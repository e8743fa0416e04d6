"""The port's TensorBoard event writer (`avsi_torch/train/tb.py`) against
the reference's (`avsi/train/tb.py`): its encoders byte for byte on the
same arrays, a whole event file byte for byte at the same wall time, and
TensorFlow reading the port's file back (skipped without TensorFlow, as
`tests/test_tb.py` is).  `read_events` and `read_scalars` decode an
event file for the tests of `train()` and of the generic U-Net's
`Trainer`."""

import os
import struct
from glob import glob

import numpy as np
import pytest

from avsi.train import tb as jtb
from avsi_torch.data import tfrecord as ttfr
from avsi_torch.train import tb as ttb


def read_events(logdir: str) -> list[tuple]:
    """The one event file under `logdir` -> [(step, tag, kind)] in order,
    kind "scalar", "image" or "audio"; the file-version event first, as
    (0, "file_version", <version>)."""
    files = glob(os.path.join(logdir, "events.out.tfevents.*"))
    assert len(files) == 1, files
    out = []
    for record in ttfr.read_records(files[0], verify_crc=True):
        event = {f: v for f, _, v in ttfr._iter_fields(record)}
        step = event.get(2, 0)
        if 3 in event:
            out.append((step, "file_version", event[3].decode()))
            continue
        for f, _, value in ttfr._iter_fields(event[5]):
            fields = {vf: vv for vf, _, vv in ttfr._iter_fields(value)}
            kind = {2: "scalar", 4: "image", 6: "audio"}[next(k for k in fields if k != 1)]
            out.append((step, fields[1].decode(), kind))
    return out


def read_scalars(logdir: str) -> dict:
    """The scalars of the one event file under `logdir`: {(step, tag): value}."""
    out = {}
    for record in ttfr.read_records(glob(os.path.join(logdir, "events.out.tfevents.*"))[0]):
        event = {f: v for f, _, v in ttfr._iter_fields(record)}
        for _, _, value in ttfr._iter_fields(event.get(5, b"")):
            fields = {vf: vv for vf, _, vv in ttfr._iter_fields(value)}
            if 2 in fields:
                out[(event.get(2, 0), fields[1].decode())] = struct.unpack("<f", fields[2])[0]
    return out


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w)).astype(np.uint8)
            for h, w in ((1, 1), (3, 7), (64, 32), (129, 40))] + [np.zeros((5, 4), np.uint8)]


def test_encoders_match_reference_bytes():
    """`_encode_event`, `_png_grayscale` and `_wav_bytes` on the same inputs:
    equal bytes."""
    for args in ((1.5e9, 0), (1.7e9 + 0.25, 12345, b"\x0a\x03abc"),
                 (0.0, 2 ** 40, None, "brain.Event:2"), (3.0, -1, b"x")):
        assert ttb._encode_event(*args) == jtb._encode_event(*args)
    for img in _images():
        assert ttb._png_grayscale(img) == jtb._png_grayscale(img)
    rng = np.random.RandomState(1)
    wav = 40000 * rng.randn(1601)
    wav[[3, 9]] = [np.nan, np.inf]
    for samples, rate in ((wav, 16000), (wav[:10].astype(np.float32), 8000), (np.zeros(0), 16000)):
        assert ttb._wav_bytes(samples, rate) == jtb._wav_bytes(samples, rate)


def _write(writer_cls, logdir):
    w = writer_cls(logdir)
    rng = np.random.RandomState(2)
    w.scalar("train/loss", 0.5, 1)
    w.scalar("train/loss", np.float32(0.25), 2)
    w.scalar("val/metric", -3.0, 7)
    w.image("spec", rng.randn(64, 32), 1)
    w.image("flat", np.full((4, 6), 2.0), 1)  # hi == lo renders black
    w.audio("wave", 1000 * np.sin(np.linspace(0, 60, 1600)), 1)
    w.audio("wave8k", 40000 * rng.randn(800), 2, sample_rate=8000)
    w.flush()
    w.close()
    files = glob(os.path.join(logdir, "events.out.tfevents.*"))
    assert len(files) == 1
    return files[0]


def test_event_file_matches_reference_bytes(tmp_path, monkeypatch):
    """The same calls at the same wall times give the same file name and
    the same bytes."""
    clock = iter(np.arange(1.7e9, 1.7e9 + 100, 0.125))
    monkeypatch.setattr(jtb.time, "time", lambda: next(clock))
    ref = _write(jtb.SummaryWriter, str(tmp_path / "jax"))
    clock = iter(np.arange(1.7e9, 1.7e9 + 100, 0.125))
    got = _write(ttb.SummaryWriter, str(tmp_path / "port"))
    assert os.path.basename(got) == os.path.basename(ref)
    assert open(got, "rb").read() == open(ref, "rb").read()
    assert read_events(str(tmp_path / "port")) == [
        (0, "file_version", "brain.Event:2"), (1, "train/loss", "scalar"),
        (2, "train/loss", "scalar"), (7, "val/metric", "scalar"), (1, "spec", "image"),
        (1, "flat", "image"), (1, "wave", "audio"), (2, "wave8k", "audio")]


def test_tf_reads_port_events(tmp_path):
    """TensorFlow parses the port's event file: scalars, a PNG it decodes at
    its shape, and a wav it decodes at its rate."""
    tf = pytest.importorskip("tensorflow")
    path = _write(ttb.SummaryWriter, str(tmp_path / "tb"))
    events = list(tf.compat.v1.train.summary_iterator(path))
    assert events[0].file_version == "brain.Event:2"
    scalars = [(e.step, v.simple_value) for e in events for v in e.summary.value
               if v.tag == "train/loss"]
    assert scalars == [(1, 0.5), (2, 0.25)]
    images = [v for e in events for v in e.summary.value if v.tag == "spec"]
    assert len(images) == 1 and images[0].image.height == 64 and images[0].image.width == 32
    assert tf.io.decode_png(images[0].image.encoded_image_string).shape == (64, 32, 1)
    audios = [v for e in events for v in e.summary.value if v.tag == "wave8k"]
    assert len(audios) == 1 and audios[0].audio.sample_rate == 8000.0
    wav = tf.audio.decode_wav(audios[0].audio.encoded_audio_string)
    assert wav.sample_rate == 8000 and wav.audio.shape == (800, 1)
