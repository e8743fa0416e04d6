"""The port's own build of the native C++ TFRecord loader
(`avsi_torch.data.native_loader`, `native/avsi_loader.cc` compiled into
`build/avsi_torch/`) and the reader's native paths, held against the
Python codec and the reference's `DataManager` on the CPU: equal batches,
every error code, CRC checks, grouped files (buffer growth, read-ahead
order, mixed group sizes), a mixed corpus raising, and an abandoned
consumer releasing the worker; then the parser fuzzed.  All comparisons are
exact.  Sizes: 7 utterances of 9,600 samples, 50 frames.
"""

import os
import threading
import time

import numpy as np
import pytest

from avsi.data import reader as jreader
from avsi_torch.data import native_loader
from avsi_torch.data import reader
from avsi_torch.data import tfrecord as tfr
from avsi_torch.ops import _build

DIMS = dict(num_audio_samples=9600, t_frames=50)


def _record(rng, i, emb=True):
    return tfr.serialize_sample_fixed(
        seq_len=50, lab_len=4,
        target_audio_wav=rng.randn(9600).astype(np.float32),
        video_features=rng.randn(50, 136).astype(np.float32),
        mask=(rng.rand(50, 257) > 0.2).astype(np.float32),
        labels=np.pad(rng.randint(0, 33, 4).astype(np.float32), (0, 46)),
        sample_path=f"s1_utt{i:02d}_800_1",
        embedding=rng.randn(512).astype(np.float32) if emb else None)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("native"))
    rng = np.random.RandomState(0)
    paths = []
    for i in range(7):
        p = os.path.join(d, f"data_{i:05d}.tfrecord")
        with tfr.TFRecordWriter(p) as w:
            w.write(_record(rng, i))
        paths.append(p)
    return paths


def _group(path, sources):
    with tfr.TFRecordWriter(path) as w:
        for src in sources:
            for rec in tfr.read_records(src):
                w.write(rec)
    return path


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)


def test_library_is_the_ports_own_build():
    """The loader builds here (g++), from `native/avsi_loader.cc`, into
    `build/avsi_torch/libavsi_loader_<hash>.so`: never the reference's
    `native/libavsi_loader.so`."""
    assert native_loader.is_available(), native_loader._native["error"]
    path = native_loader.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libavsi_loader_") and path.suffix == ".so"
    assert native_loader.NATIVE_SOURCE.name == "avsi_loader.cc"
    assert native_loader.NATIVE_SOURCE.parent.name == "native"


def test_load_batch_matches_python_codec(corpus):
    """`load_batch` with CRCs checked: every field of every row equals the
    Python codec's parse; `parse_counts` counts the call and its records."""
    native_loader.reset_parse_counts()
    batch = native_loader.load_batch(corpus[:4], emb_dim=512, verify_crc=True, **DIMS)
    assert native_loader.parse_counts == {"calls": 1, "records": 4}
    for i, path in enumerate(corpus[:4]):
        want = tfr.parse_sample_fixed(next(tfr.read_records(path)), with_embedding=True)
        assert batch["sequence_lengths"][i] == want["sequence_length"]
        assert batch["labels_lengths"][i] == want["labels_length"]
        assert batch["sample_paths"][i] == want["sample_path"]
        for key, ref in (("target_sources", "target_audio_wav"), ("video_features", None),
                         ("masks", "mask"), ("labels", None), ("embeddings", "embedding")):
            np.testing.assert_array_equal(batch[key][i], want[ref or key])


@pytest.mark.parametrize("use_native", [True, False])
def test_reader_matches_reference(corpus, tmp_path, use_native):
    """Single-record and grouped files, shuffled and padded epochs: the port's
    `DataManager` yields the reference's batches (`use_native` alike), and
    with `use_native` it read natively (the probe and the parse count)."""
    grouped = [_group(str(tmp_path / "g0.tfrecord"), corpus[:5]),
               _group(str(tmp_path / "g1.tfrecord"), corpus[5:])]
    kw = dict(num_audio_samples=9600, with_embedding=True, seed=3, use_native=use_native)
    for files in (corpus, grouped):
        mine, ref = reader.DataManager(**kw), jreader.DataManager(**kw)
        assert mine.use_native == use_native
        native_loader.reset_parse_counts()
        for run in (dict(shuffle=True, drop_remainder=True), dict(shuffle=True),
                    dict(pad_final=True)):
            _assert_batches_equal(list(mine.prefetch_batches(files, 3, **run)),
                                  list(ref.batches(files, 3, **run)))
        assert (native_loader.parse_counts["records"] > 0) == use_native
        assert bool(mine._native_probe) == use_native
    python = list(reader.DataManager(num_audio_samples=9600, with_embedding=True,
                                     use_native=False).batches(grouped, 4, pad_final=True))
    native = list(reader.DataManager(num_audio_samples=9600, with_embedding=True,
                                     use_native=True).batches(grouped, 4, pad_final=True))
    _assert_batches_equal(native, python)


def test_probe_falls_back_where_the_layout_differs(corpus):
    """A corpus whose shapes are not the reader's reads through the Python
    codec (the probe is empty), as in the reference; the default takes the
    native loader where it builds."""
    dm = reader.DataManager(num_audio_samples=4800, with_embedding=True)
    assert dm.use_native
    assert dm._probe_native(corpus[0]) == ()
    dm = reader.DataManager(num_audio_samples=9600, with_embedding=True)
    assert dm._probe_native(corpus[0]) == (50, 512, 1, 50)
    with pytest.raises(ValueError, match="unknown tfrecord mode"):
        reader.DataManager(mode="bogus")
    assert not reader.DataManager(mode="var", use_native=True).use_native


@pytest.mark.parametrize("case", ["open", "framing", "crc", "dims", "multi", "protobuf"])
def test_error_codes(corpus, tmp_path, case):
    """Each failure raises with its code and the reference's message: a
    missing file (-1), a cut frame (-3), a flipped payload byte under
    `verify_crc` (-4), more floats than expected (-5), a second record on the
    single-record path (-6) and a payload that is not a protobuf (-2)."""
    blob = open(corpus[0], "rb").read()
    bad = str(tmp_path / "bad.tfrecord")
    kw = dict(DIMS, emb_dim=512)
    if case == "open":
        bad, code = str(tmp_path / "missing.tfrecord"), -1
    elif case == "framing":
        open(bad, "wb").write(blob[:20])
        code = -3
    elif case == "crc":
        flipped = bytearray(blob)
        flipped[100] ^= 1
        open(bad, "wb").write(bytes(flipped))
        kw["verify_crc"], code = True, -4
    elif case == "dims":
        bad, kw["num_audio_samples"], code = corpus[0], 4800, -5
    elif case == "multi":
        _group(bad, corpus[:3])
        code = -6
    else:
        with tfr.TFRecordWriter(bad) as w:
            w.write(b"\xff" * 64)
        code = -2
    with pytest.raises(ValueError, match=f"code {code} .*use_native=False"):
        native_loader.load_batch([corpus[1], bad], **kw)
    if case == "crc":
        native_loader.load_batch([bad], **dict(kw, verify_crc=False))  # unchecked: parses


def test_grouped_files(corpus, tmp_path):
    """`load_file_records` of a grouped file: its records in order, exact-size
    arrays, the overflow past `max_samples` and trailing bytes (-3) raise,
    and the reader's grouped path sees every record of files of 4, 1 and 2
    records."""
    grouped = _group(str(tmp_path / "grouped.tfrecord"), corpus[:5])
    recs = native_loader.load_file_records(grouped, 64, emb_dim=512, verify_crc=True, **DIMS)
    assert recs["target_sources"].shape == (5, 9600) and recs["masks"].base is None
    want = tfr.parse_sample_fixed(next(tfr.read_records(corpus[2])), with_embedding=True)
    np.testing.assert_array_equal(recs["target_sources"][2], want["target_audio_wav"])
    assert recs["sample_paths"][2] == want["sample_path"]
    with pytest.raises(ValueError, match="more than 4 records"):
        native_loader.load_file_records(grouped, 4, emb_dim=512, **DIMS)
    trail = _group(str(tmp_path / "trail.tfrecord"), corpus[:1])
    with open(trail, "ab") as f:
        f.write(b"\x01\x02\x03")
    with pytest.raises(ValueError, match="code -3"):
        native_loader.load_file_records(trail, 4, emb_dim=512, **DIMS)

    d = tmp_path / "mixed"
    d.mkdir()
    sizes, idx = [4, 1, 2], 0
    for j, size in enumerate(sizes):
        _group(str(d / f"g{j}.tfrecord"), [corpus[(idx + k) % 7] for k in range(size)])
        idx += size
    files = sorted(str(p) for p in d.iterdir())
    dm = reader.DataManager(num_audio_samples=9600, with_embedding=True)
    got = [p for b in dm.batches(files, 3) for p in b["sample_paths"][:b["num_real"]]]
    assert dm._native_probe[2] == 4 and len(got) == sum(sizes)


def test_grouped_file_buffer_grows(corpus, tmp_path):
    """A grouped file of more records than four times its corpus's probe
    (here 1 x 4 = 64 rows, the floor) is read whole: the buffer grows."""
    probe = _group(str(tmp_path / "g0.tfrecord"), corpus[:2])
    big = _group(str(tmp_path / "g1.tfrecord"), corpus * 10)
    dm = reader.DataManager(num_audio_samples=9600, with_embedding=True)
    batches = list(dm.batches([probe, big], 9))
    assert dm._native_probe[2] == 2
    assert sum(b["num_real"] for b in batches) == 72


def test_mixed_corpus_raises(corpus, tmp_path):
    """A corpus probed as single-record (its first file) with a grouped file
    in it fails loudly on the single-record path (-6), never dropping the
    records past the first."""
    d = tmp_path / "mixed"
    d.mkdir()
    for i, p in enumerate(corpus[:3]):
        _group(str(d / f"a{i}.tfrecord"), [p])
    _group(str(d / "b.tfrecord"), corpus[3:6])
    files = sorted(str(p) for p in d.iterdir())
    dm = reader.DataManager(num_audio_samples=9600, with_embedding=True)
    with pytest.raises(ValueError, match="more than one record"):
        list(dm.batches(files, 4))


def test_readahead_order(corpus, tmp_path):
    """Grouped files parsed on 4 threads yield the batches of 1 thread, in
    the same order; `_ordered_pool_map` keeps order and raises a worker's
    error."""
    groups = [_group(str(tmp_path / f"g{g}.tfrecord"), corpus[g:g + 3]) for g in range(4)]
    kw = dict(num_audio_samples=9600, with_embedding=True)
    seq = list(reader.DataManager(native_readahead=1, **kw).batches(groups, 5, pad_final=True))
    par = list(reader.DataManager(native_readahead=4, **kw).batches(groups, 5, pad_final=True))
    _assert_batches_equal(par, seq)

    def boom(x):
        if x == 3:
            raise ValueError("x3")
        return x * 2

    with pytest.raises(ValueError, match="x3"):
        list(reader._ordered_pool_map(boom, range(6), workers=3))
    assert list(reader._ordered_pool_map(boom, [1, 2], workers=3)) == [2, 4]
    assert list(reader._ordered_pool_map(boom, range(3), workers=1)) == [0, 2, 4]


def test_abandoned_consumer_releases_worker(corpus):
    """Leaving `prefetch_batches` after one batch stops its thread."""
    dm = reader.DataManager(num_audio_samples=9600, with_embedding=True)
    before = {t.ident for t in threading.enumerate()}
    gen = dm.prefetch_batches(list(corpus) * 4, 2)
    next(gen)
    gen.close()
    deadline = time.time() + 5.0
    alive = []
    while time.time() < deadline:
        alive = [t for t in threading.enumerate() if t.ident not in before and t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive, f"prefetch worker leaked: {alive}"


def test_fuzzed_files_raise_or_parse(tmp_path):
    """Random bytes, bit flips and cuts of a valid file: the parser returns
    or raises ValueError, never crashes; a structurally valid record of other
    dims raises."""
    rng = np.random.RandomState(1)
    base = str(tmp_path / "base.tfrecord")
    with tfr.TFRecordWriter(base) as w:
        w.write(_record(np.random.RandomState(0), 0, emb=False))
    blob = open(base, "rb").read()
    cases = [rng.bytes(int(rng.randint(0, 4096))) for _ in range(30)]
    for _ in range(40):
        mutated = bytearray(blob)
        for _ in range(int(rng.randint(1, 8))):
            mutated[int(rng.randint(0, len(mutated)))] ^= 1 << int(rng.randint(0, 8))
        cases.append(bytes(mutated))
    cases += [blob[:cut] for cut in (0, 1, 7, 8, 12, 100, len(blob) // 2, len(blob) - 5)]
    outcomes = set()
    for i, data in enumerate(cases):
        p = str(tmp_path / f"f{i}.tfrecord")
        open(p, "wb").write(data)
        try:
            native_loader.load_file_records(p, 4, **DIMS)
            outcomes.add("ok")
        except ValueError:
            outcomes.add("error")
    assert "error" in outcomes
    for kw in (dict(num_audio_samples=48000, t_frames=50), dict(num_audio_samples=9600,
                                                                t_frames=250),
               dict(DIMS, emb_dim=512)):
        with pytest.raises(ValueError):
            native_loader.load_file_records(base, 4, **kw)
    for _ in range(100):
        try:
            tfr.decode_sequence_example(rng.bytes(int(rng.randint(0, 1024))))
        except (ValueError, IndexError, UnicodeDecodeError):
            pass
