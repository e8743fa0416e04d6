"""TFRecord + tf.train.SequenceExample codec of the corpus.

Copy of `avsi/data/tfrecord.py` (the framing with its CRC, the protobuf
wire format, the fixed-mode `serialize_sample_fixed` / `parse_sample_fixed`
at `:374-414`, the var-mode `serialize_sample_var` / `parse_sample_var` at
`:421-481`, the record readers, `read_raw_records` and
`list_tfrecord_files`), so the port reads and writes the reference's
corpus, byte for byte, without importing it.

Schema (fixed mode):
  context:  sequence_length int64, labels_length int64,
            target_audio_wav float[48000], sample_path bytes,
            [embedding float[512]]            (emb variant)
  lists:    labels float[50][1], video_features float[250][136],
            mask float[250][257]

Var mode keeps only the lengths (and the embedding) in the context; the
wave is one float per Feature, labels one float per entry, sample_path one
int64 character code per character, video and mask one row per frame.

TFRecord framing: {uint64 len}{u32 masked_crc(len)}{payload}{u32 masked_crc}.
The CRC is CRC-32C; records of a few hundred kB are checksummed with numpy
(chunked, then the chunk CRCs combined through the CRC's linear map), so
the codec needs no C extension and stays fast.
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Iterator

import numpy as np

# ---------------------------------------------------------------- CRC-32C

_POLY = 0x82F63B78  # Castagnoli, reflected


def _crc_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
        table[i] = crc
    return table


_TABLE = _crc_table()
_CHUNK = 256  # bytes per vectorised chunk
_ZEROS_OPS: list[np.ndarray] = []  # level k: the CRC register map of CHUNK * 2**k zero bytes


def _apply(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """A GF(2)-linear map of the 32-bit register, given by the images of
    the 32 unit vectors, applied to each element of v."""
    out = np.zeros_like(v)
    for bit in range(32):
        out ^= ((v >> np.uint32(bit)) & np.uint32(1)) * cols[bit]
    return out


def _zeros_op(level: int) -> np.ndarray:
    while len(_ZEROS_OPS) <= level:
        if not _ZEROS_OPS:
            cols = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
            for _ in range(_CHUNK):
                cols = _TABLE[cols & 0xFF] ^ (cols >> 8)
        else:
            cols = _apply(_ZEROS_OPS[-1], _ZEROS_OPS[-1])
        _ZEROS_OPS.append(cols)
    return _ZEROS_OPS[level]


def _crc32c(data: bytes) -> int:
    if len(data) < 4 * _CHUNK:
        crc = 0xFFFFFFFF
        for b in data:
            crc = int(_TABLE[(crc ^ b) & 0xFF]) ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF
    # The initial register 0xFFFFFFFF is the same as a zero register over a
    # message whose first 4 bytes are inverted; leading zero bytes leave a
    # zero register unchanged, so the message is front-padded to CHUNK *
    # 2**levels, each chunk's register from zero is computed at once, and
    # neighbours are merged as shift(earlier) ^ later, level by level.
    buf = np.frombuffer(data, np.uint8).copy()
    buf[:4] ^= 0xFF
    n_chunks = -(-len(buf) // _CHUNK)
    levels = (n_chunks - 1).bit_length()
    padded = np.zeros(_CHUNK << levels, np.uint8)
    padded[len(padded) - len(buf):] = buf
    chunks = padded.reshape(-1, _CHUNK)
    reg = np.zeros(len(chunks), np.uint32)
    for i in range(_CHUNK):
        reg = _TABLE[(reg ^ chunks[:, i]) & 0xFF] ^ (reg >> 8)
    for level in range(levels):
        reg = _apply(_zeros_op(level), reg[0::2]) ^ reg[1::2]
    return int(reg[0]) ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------- protobuf wire

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & 0xFFFFFFFFFFFFFFFF, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint overflow")


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def feature_bytes(values: list[bytes]) -> bytes:
    """Feature{bytes_list=1{value=1}}"""
    return _len_delimited(1, b"".join(_len_delimited(1, v) for v in values))


def feature_floats(values) -> bytes:
    """Feature{float_list=2{value=1 packed}}"""
    return _len_delimited(2, _len_delimited(1, np.asarray(values, dtype="<f4").tobytes()))


def feature_int64s(values) -> bytes:
    """Feature{int64_list=3{value=1 packed varints}}"""
    inner = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in values)
    return _len_delimited(3, _len_delimited(1, inner))


def _map_entry(key: str, feature_payload: bytes) -> bytes:
    return _len_delimited(1, key.encode()) + _len_delimited(2, feature_payload)


def encode_features(feature_map: dict[str, bytes]) -> bytes:
    """Features{map<string,Feature> feature=1}; values are encoded Features."""
    return b"".join(_len_delimited(1, _map_entry(k, v)) for k, v in feature_map.items())


def encode_feature_list(features: list[bytes]) -> bytes:
    """FeatureList{repeated Feature feature=1}"""
    return b"".join(_len_delimited(1, f) for f in features)


def _feature_list_float_rows(arr) -> bytes:
    """Encoded FeatureList of one packed-float Feature per row (the
    headers are the same for every row, so they are built once)."""
    arr = np.ascontiguousarray(np.asarray(arr, dtype="<f4"))
    if arr.ndim == 1:
        arr = arr[:, None]
    n, w = arr.shape
    rb = 4 * w
    inner_hdr = _tag(1, 2) + _varint(rb)
    feat_hdr = _tag(2, 2) + _varint(len(inner_hdr) + rb)
    row_hdr = _tag(1, 2) + _varint(len(feat_hdr) + len(inner_hdr) + rb) + feat_hdr + inner_hdr
    raw = memoryview(arr.tobytes())
    return b"".join(b"".join((row_hdr, raw[i * rb:(i + 1) * rb])) for i in range(n))


def encode_sequence_example(context: dict[str, bytes],
                            feature_lists: dict[str, list[bytes] | bytes]) -> bytes:
    """SequenceExample{context=1 Features, feature_lists=2 FeatureLists}; a
    feature list is a list of encoded Features or an encoded FeatureList."""
    fls = b"".join(
        _len_delimited(1, _map_entry(k, v if isinstance(v, bytes) else encode_feature_list(v)))
        for k, v in feature_lists.items())
    return _len_delimited(1, encode_features(context)) + _len_delimited(2, fls)


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, bytes | int]]:
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 5:
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _decode_feature(buf: bytes):
    """A Feature -> numpy array (floats, int64s) or list of bytes."""
    for field, _wire, payload in _iter_fields(buf):
        if field == 1:  # bytes_list
            return [v for f, _, v in _iter_fields(payload) if f == 1]
        if field == 2:  # float_list, packed (wire 2) or not (wire 5)
            vals = [np.frombuffer(v, dtype="<f4") for f, w, v in _iter_fields(payload)
                    if f == 1 and w in (2, 5)]
            return np.concatenate(vals) if vals else np.zeros(0, np.float32)
        if field == 3:  # int64_list
            vals = []
            for f, w, v in _iter_fields(payload):
                if f != 1:
                    continue
                if w == 0:
                    vals.append(np.int64(np.uint64(v)))
                elif w == 2:  # packed varints
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        vals.append(np.int64(np.uint64(x)))
            return np.asarray(vals, dtype=np.int64)
    return np.zeros(0, np.float32)


def decode_sequence_example(buf: bytes) -> tuple[dict, dict]:
    """-> (context: {key: feature}, feature_lists: {key: [feature, ...]})."""
    context: dict = {}
    feature_lists: dict = {}
    for field, wire, payload in _iter_fields(buf):
        if wire != 2 or field not in (1, 2):
            continue
        for f, fw, entry in _iter_fields(payload):
            if f != 1 or fw != 2:
                continue
            key, val = None, (None if field == 1 else [])
            for ef, ew, ev in _iter_fields(entry):
                if ew != 2:
                    continue
                if ef == 1:
                    key = ev.decode(errors="replace")
                elif ef == 2 and field == 1:
                    val = _decode_feature(ev)
                elif ef == 2:  # a FeatureList
                    val = [_decode_feature(fv) for ff, fw2, fv in _iter_fields(ev)
                           if ff == 1 and fw2 == 2]
            (context if field == 1 else feature_lists)[key] = val
    return context, feature_lists


# ---------------------------------------------------------------- framing

class TFRecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header + struct.pack("<I", _masked_crc(header)) + record
                      + struct.pack("<I", _masked_crc(record)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def count_records(path: str) -> int:
    """Record count from the length headers alone (no decode, no CRC)."""
    n = 0
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if not head:
                return n
            if len(head) < 8:
                raise ValueError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", head)
            f.seek(4 + length + 4, 1)
            n += 1


def read_raw_records(path: str) -> Iterator[bytes]:
    """Yield the framed records of one file verbatim (length, CRCs and
    payload): grouping files (`generator.group_tfrecords`) concatenates
    them, with no decode and no new checksum."""
    with open(path, "rb") as f:
        data = f.read()
    pos, n = 0, len(data)
    while pos < n:
        if pos + 12 > n:
            raise ValueError(f"truncated TFRecord header in {path}")
        (length,) = struct.unpack_from("<Q", data, pos)
        if pos + 16 + length > n:
            raise ValueError(f"truncated TFRecord payload in {path}")
        yield data[pos:pos + 16 + length]
        pos += 16 + length


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield the record payloads of one file."""
    for frame in read_raw_records(path):
        payload = frame[12:-4]
        if verify_crc:
            if struct.unpack_from("<I", frame, 8)[0] != _masked_crc(frame[:8]):
                raise ValueError(f"corrupt TFRecord length crc in {path}")
            if struct.unpack_from("<I", frame, 12 + len(payload))[0] != _masked_crc(payload):
                raise ValueError(f"corrupt TFRecord data crc in {path}")
        yield payload


def list_tfrecord_files(data_dir: str) -> list[str]:
    return sorted(glob.glob(os.path.join(data_dir, "*.tfrecord")))


# ---------------------------------------------------------------- fixed-mode samples

def serialize_sample_fixed(
    seq_len: int,
    lab_len: int,
    target_audio_wav: np.ndarray,
    video_features: np.ndarray,
    mask: np.ndarray,
    labels: np.ndarray,
    sample_path: str,
    embedding: np.ndarray | None = None,
) -> bytes:
    context = {
        "sequence_length": feature_int64s([seq_len]),
        "labels_length": feature_int64s([lab_len]),
        "target_audio_wav": feature_floats(target_audio_wav),
        "sample_path": feature_bytes([sample_path.encode()]),
    }
    if embedding is not None:
        context["embedding"] = feature_floats(embedding)
    feature_lists = {
        "mask": _feature_list_float_rows(mask),
        "video_features": _feature_list_float_rows(video_features),
        "labels": _feature_list_float_rows(np.asarray(labels, np.float32)),
    }
    return encode_sequence_example(context, feature_lists)


def parse_sample_fixed(record: bytes, with_embedding: bool = False) -> dict:
    """Decode one fixed-mode sample into numpy arrays."""
    context, lists = decode_sequence_example(record)
    out = {
        "sequence_length": np.int32(context["sequence_length"][0]),
        "labels_length": np.int32(context["labels_length"][0]),
        "target_audio_wav": np.asarray(context["target_audio_wav"], np.float32),
        "sample_path": context["sample_path"][0].decode(),
        "labels": np.asarray([f[0] for f in lists["labels"]], np.float32),
        "video_features": np.stack(lists["video_features"]).astype(np.float32),
        "mask": np.stack(lists["mask"]).astype(np.float32),
    }
    if with_embedding:
        out["embedding"] = np.asarray(context["embedding"], np.float32)
    return out


# ---------------------------------------------------------------- var-mode samples

def serialize_sample_var(
    seq_len: int,
    lab_len: int,
    target_audio_wav: np.ndarray,
    video_features: np.ndarray,
    mask: np.ndarray,
    labels: np.ndarray,
    sample_path: str,
    embedding: np.ndarray | None = None,
) -> bytes:
    """One var-mode sample: everything sized per utterance is a feature list,
    so that a reader can pad a batch to its longest sample."""
    context = {
        "sequence_length": feature_int64s([seq_len]),
        "labels_length": feature_int64s([lab_len]),
    }
    if embedding is not None:
        context["embedding"] = feature_floats(embedding)
    feature_lists = {
        "target_audio_wav": _feature_list_float_rows(np.asarray(target_audio_wav, np.float32)),
        "video_features": _feature_list_float_rows(video_features),
        "mask": _feature_list_float_rows(mask),
        "labels": _feature_list_float_rows(np.asarray(labels, np.float32)),
        "sample_path": [feature_int64s([ord(ch)]) for ch in sample_path],
    }
    return encode_sequence_example(context, feature_lists)


def parse_sample_var(record: bytes, with_embedding: bool = False) -> dict:
    """Decode one var-mode sample into the keys of `parse_sample_fixed`."""
    context, lists = decode_sequence_example(record)
    wav = lists.get("target_audio_wav")
    out = {
        "sequence_length": np.int32(context["sequence_length"][0]),
        "labels_length": np.int32(context["labels_length"][0]),
        "target_audio_wav": (np.concatenate(wav).astype(np.float32) if wav
                             else np.zeros(0, np.float32)),
        "sample_path": "".join(chr(int(f[0])) for f in lists.get("sample_path") or []),
        "labels": np.asarray([f[0] for f in lists["labels"]], np.float32),
        "video_features": np.stack(lists["video_features"]).astype(np.float32),
        "mask": np.stack(lists["mask"]).astype(np.float32),
    }
    if with_embedding:
        out["embedding"] = np.asarray(context["embedding"], np.float32)
    return out
