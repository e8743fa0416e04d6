"""TensorBoard event-file writer (port of `avsi/train/tb.py`), with no
TensorFlow dependency.

The events are TFRecord-framed Event protos built from the port's own
protobuf primitives (`avsi_torch/data/tfrecord.py`); for the same values
and wall time they are the reference's bytes, so `tensorboard --logdir`
reads the runs of either package.

Wire schema:
  Event    { double wall_time=1; int64 step=2; string file_version=3;
             Summary summary=5; }
  Summary  { repeated Value value=1; }
  Value    { string tag=1; float simple_value=2; Image image=4;
             Audio audio=6; }
  Image    { int32 height=1; int32 width=2; int32 colorspace=3;
             bytes encoded_image_string=4; }
  Audio    { float sample_rate=1; int64 num_channels=2;
             int64 length_frames=3; bytes encoded_audio_string=4;
             string content_type=5; }
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib

import numpy as np

from avsi_torch.data.tfrecord import TFRecordWriter, _len_delimited, _tag, _varint


def _double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _int64(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(int(value) & 0xFFFFFFFFFFFFFFFF)


def _encode_event(wall_time: float, step: int, summary: bytes | None = None,
                  file_version: str | None = None) -> bytes:
    out = _double(1, wall_time) + _int64(2, step)
    if file_version is not None:
        out += _len_delimited(3, file_version.encode())
    if summary is not None:
        out += _len_delimited(5, summary)
    return out


def _png_grayscale(img: np.ndarray) -> bytes:
    """Minimal PNG encoder for (H, W) uint8 images (zlib, no filtering)."""
    h, w = img.shape
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _wav_bytes(samples: np.ndarray, sample_rate: int) -> bytes:
    data = np.clip(np.nan_to_num(samples), -32768, 32767).astype("<i2").tobytes()
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16, 1, 1,
        sample_rate, sample_rate * 2, 2, 16, b"data", len(data),
    )
    return hdr + data


def _summary_value(tag: str, field: int, payload: bytes) -> bytes:
    """One Summary holding one Value: the tag and its typed payload."""
    return _len_delimited(1, _len_delimited(1, tag.encode()) + _len_delimited(field, payload))


class SummaryWriter:
    """Append-only `events.out.tfevents.<time>.<host>` writer."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time()):d}.{socket.gethostname()}"
        self._writer = TFRecordWriter(os.path.join(logdir, fname))
        self._writer.write(_encode_event(time.time(), 0, file_version="brain.Event:2"))

    def scalar(self, tag: str, value: float, step: int) -> None:
        val = _len_delimited(1, tag.encode()) + _float(2, float(value))
        self._writer.write(_encode_event(time.time(), step, _len_delimited(1, val)))

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        """img: (H, W) float, rendered as a min-max normalized grayscale PNG."""
        arr = np.asarray(img, np.float64)
        lo, hi = arr.min(), arr.max()
        arr8 = np.zeros_like(arr, np.uint8) if hi == lo else (
            (arr - lo) / (hi - lo) * 255).astype(np.uint8)
        image_msg = (_int64(1, arr.shape[0]) + _int64(2, arr.shape[1]) + _int64(3, 1)
                     + _len_delimited(4, _png_grayscale(arr8)))
        self._writer.write(_encode_event(time.time(), step, _summary_value(tag, 4, image_msg)))

    def audio(self, tag: str, samples: np.ndarray, step: int, sample_rate: int = 16000) -> None:
        wav = _wav_bytes(np.asarray(samples), sample_rate)
        audio_msg = (_float(1, float(sample_rate)) + _int64(2, 1) + _int64(3, len(samples))
                     + _len_delimited(4, wav) + _len_delimited(5, b"audio/wav"))
        self._writer.write(_encode_event(time.time(), step, _summary_value(tag, 6, audio_msg)))

    def flush(self) -> None:
        self._writer._f.flush()

    def close(self) -> None:
        self._writer.close()
