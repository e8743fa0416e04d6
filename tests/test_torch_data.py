"""The port's corpus tooling held against the JAX package's on the CPU:
`make_fixture` trees byte for byte, the var-mode codec, `group_tfrecords`,
the mask, landmark and A/V-sync functions, the feature statistics and the
landmark extraction's bookkeeping (the dlib extractor stubbed in both).

Sizes are small: 600 ms utterances (50 frames), 2 speakers x 3 samples a
split.  Each test states its tolerance; most are exact.
"""

import os

import numpy as np
import pytest

from avsi.data import avsync as javsync
from avsi.data import extract as jextract
from avsi.data import fixture as jfixture
from avsi.data import generator as jgenerator
from avsi.data import landmarks as jlandmarks
from avsi.data import masks as jmasks
from avsi.data import stats as jstats
from avsi.data import tfrecord as jtfr
from avsi_torch.data import avsync as tavsync
from avsi_torch.data import extract as textract
from avsi_torch.data import fixture as tfixture
from avsi_torch.data import generator as tgenerator
from avsi_torch.data import landmarks as tlandmarks
from avsi_torch.data import masks as tmasks
from avsi_torch.data import stats as tstats
from avsi_torch.data import tfrecord as ttfr

SMALL = dict(n_speakers=2, n_samples=3, audio_len_ms=600, gap_ms=150.0, gap_std_ms=20.0)


def tree_bytes(root) -> dict:
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def assert_same_tree(mine, ref) -> None:
    a, b = tree_bytes(mine), tree_bytes(ref)
    assert sorted(a) == sorted(b)
    for rel in b:
        assert a[rel] == b[rel], rel


FIXTURES = {
    "default": {},
    "freeform": dict(mask_kind="freeform"),
    "video_informative": dict(video_informative=True, with_embeddings=True),
    "unet": dict(mask_hop_ms=8, mask_frame_dim=128, n_max_intr=2),
    "raw_only": dict(raw_only=True),
}


@pytest.mark.parametrize("variant", sorted(FIXTURES) + ["var"])
def test_make_fixture_tree_is_the_reference(tmp_path, variant):
    """`make_fixture` with the same arguments writes the same files with the
    same bytes (the raw corpus, the masked sample directories, the TFRecord
    splits and seq_lengths.npy); "var" then builds the var-mode TFRecords of
    the same sample directories with `create_dataset`."""
    kw = dict(SMALL, **FIXTURES.get(variant, {}))
    ref = jfixture.make_fixture(str(tmp_path / "j"), **kw)
    mine = tfixture.make_fixture(str(tmp_path / "t"), **kw)
    assert sorted(mine) == sorted(ref)
    if variant == "var":
        for pkg, out in ((jgenerator, ref), (tgenerator, mine)):
            pkg.create_dataset(out["audio"], out["tfrecords"] + "_var", out["dictionary"],
                               tfrecord_mode="var")
    assert_same_tree(tmp_path / "t", tmp_path / "j")
    if variant == "raw_only":
        assert not (tmp_path / "t" / "tfrecords").exists()
    elif variant == "var":
        files = ttfr.list_tfrecord_files(os.path.join(mine["tfrecords"] + "_var", "test-set"))
        assert len(files) == 6
        sample = ttfr.parse_sample_var(next(ttfr.read_records(files[0], verify_crc=True)))
        assert sample["mask"].shape == (50, 257) and len(sample["target_audio_wav"]) == 9600


def test_var_codec_is_the_reference(tmp_path):
    """`serialize_sample_var` records are byte-equal to the reference's (with
    and without an embedding), and each package parses the other's into the
    same arrays."""
    rng = np.random.RandomState(0)
    for t, emb in ((37, None), (12, rng.randn(8).astype(np.float32))):
        s = dict(seq_len=t, lab_len=3, target_audio_wav=rng.randn(t * 192).astype(np.float32),
                 video_features=rng.randn(t, 136).astype(np.float32),
                 mask=(rng.rand(t, 257) > 0.2).astype(np.float32),
                 labels=np.arange(3, dtype=np.float32) + 1, sample_path=f"s1_ü_{t}",
                 embedding=emb)
        rec = ttfr.serialize_sample_var(**s)
        assert rec == jtfr.serialize_sample_var(**s)
        a = ttfr.parse_sample_var(rec, with_embedding=emb is not None)
        b = jtfr.parse_sample_var(rec, with_embedding=emb is not None)
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["sample_path"] == s["sample_path"]
    features = {"x": ttfr.feature_int64s([3, -1]), "y": ttfr.feature_floats([0.5])}
    lists = {"z": [ttfr.feature_bytes([b"ab"]), ttfr.feature_floats([1.0, 2.0])]}
    assert ttfr.encode_sequence_example(features, lists) == jtfr.encode_sequence_example(
        features, lists)


def test_group_tfrecords_is_the_reference(tmp_path):
    """Grouping a fixture's training split by 4 writes the reference's files
    byte for byte (2 speakers x 3 samples: one group of 4, one of 2), and
    `read_raw_records` yields the reference's frames."""
    out = tfixture.make_fixture(str(tmp_path / "fix"), **SMALL)
    src = os.path.join(out["tfrecords"], "training-set")
    tgenerator.group_tfrecords(src, str(tmp_path / "t"), group_size=4)
    jgenerator.group_tfrecords(src, str(tmp_path / "j"), group_size=4)
    assert_same_tree(tmp_path / "t", tmp_path / "j")
    grouped = ttfr.list_tfrecord_files(str(tmp_path / "t"))
    assert [ttfr.count_records(p) for p in grouped] == [4, 2]
    assert list(ttfr.read_raw_records(grouped[0])) == list(jtfr.read_raw_records(grouped[0]))
    with pytest.raises(ValueError, match="Non matching"):  # 2 files, 6 lengths
        tgenerator.group_tfrecords(str(tmp_path / "t"), str(tmp_path / "x"))
    with pytest.raises(IOError, match="seq_lengths"):
        tgenerator.group_tfrecords(str(tmp_path / "fix"), str(tmp_path / "x"))


def test_masks_are_the_reference():
    """Both mask samplers, from generators of one seed, draw the same masks,
    coverages and counts over many calls (exact)."""
    for seed in range(3):
        mine, ref = np.random.default_rng(seed), np.random.default_rng(seed)
        for i in range(40):
            n_max = 1 + i % 4
            a = tmasks.get_intrusions_mask(mine, 257, 250, 0.27, 0.03, n_max)
            b = jmasks.get_intrusions_mask(ref, 257, 250, 0.27, 0.03, n_max)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:] == b[1:]
        for _ in range(5):
            a = tmasks.get_freeform_mask(mine, 128, 128, 0.25, 0.05)
            b = jmasks.get_freeform_mask(ref, 128, 128, 0.25, 0.05)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:] == b[1:]
    assert tmasks.get_intrusions_mask(np.random.default_rng(0), 8, 50, 0.2, 0.0, 1)[1] == 0.2


def test_landmarks_and_avsync_are_the_reference(tmp_path):
    """On seeded landmarks: the anchor adjustment, the motion vectors (delta
    1 and 2, with an anchor), the rendered overlays (dots, full drawing, on
    backgrounds) and their PNG files, `inc_fps` and
    `sync_audio_visual_features` (padded at the start and the end, and the
    corrupt inputs it refuses) are equal to the reference's (exact)."""
    rng = np.random.RandomState(3)
    lm = rng.randn(75, 136)
    np.testing.assert_array_equal(tlandmarks.adjust_landmarks(lm.reshape(75, 68, 2)),
                                  jlandmarks.adjust_landmarks(lm.reshape(75, 68, 2)))
    for delta, anchor in ((0, -1), (1, -1), (2, -1), (1, 33)):
        np.testing.assert_array_equal(tlandmarks.get_motion_vector(lm, delta, anchor),
                                      jlandmarks.get_motion_vector(lm, delta, anchor))
    bg = rng.randint(0, 255, (4, 60, 80)).astype(np.uint8)
    pts = np.abs(rng.randn(4, 68, 2)) * 20
    for kw in (dict(), dict(full_draw=True), dict(backgrounds=bg, full_draw=True, dot_radius=2)):
        np.testing.assert_array_equal(tlandmarks.render_landmark_frames(pts, **kw),
                                      jlandmarks.render_landmark_frames(pts, **kw))
    assert tlandmarks.render_landmark_frames(np.zeros((0, 136))).shape == (0, 240, 240)
    frames = tlandmarks.render_landmark_frames(pts, size=32)
    mine = tlandmarks.save_landmark_overlays(frames, str(tmp_path / "t"))
    ref = jlandmarks.save_landmark_overlays(frames, str(tmp_path / "j"))
    assert [os.path.basename(p) for p in mine] == [os.path.basename(p) for p in ref]
    assert_same_tree(tmp_path / "t", tmp_path / "j")

    np.testing.assert_array_equal(tavsync.inc_fps(lm, 250), javsync.inc_fps(lm, 250))
    mask = np.ones((250, 257), np.float32)
    for feats, kw in ((lm, {}), (lm[:72], dict(tot_frames=75, min_frames=70)),
                      (lm[:72], dict(tot_frames=75, pad="end"))):
        np.testing.assert_array_equal(tavsync.sync_audio_visual_features(mask, feats, **kw),
                                      javsync.sync_audio_visual_features(mask, feats, **kw))
    assert tavsync.sync_audio_visual_features(mask, lm[:60], 75, 70) is None
    assert tavsync.sync_audio_visual_features(mask, lm[0], 75, 70) is None


@pytest.fixture(scope="module")
def sample_dirs(tmp_path_factory):
    return tfixture.make_fixture(str(tmp_path_factory.mktemp("stats")), **SMALL)["training-set"]


@pytest.mark.parametrize("feat_type,kw", [
    ("spec", {}),
    ("spec", dict(apply_mask=True, preemph=0.97)),
    ("fbanks", dict(n_delta=2)),
    ("mfcc", dict(n_delta=1, apply_mask=True, save_feat=True)),
])
def test_feature_stats_are_the_reference(sample_dirs, tmp_path, feat_type, kw):
    """`compute_mean_std_features` over a fixture split: the returned float64
    mean and std and the saved float32 files at rtol 1e-6 against the
    reference's (the same float64 numpy arithmetic on the same matrices), and
    the saved per-sample features (`save_feat`) equal; the prefix is joined
    to the audio directory (an absolute one stands)."""
    mine = tstats.compute_mean_std_features(sample_dirs, "target", str(tmp_path / "t"),
                                            feat_type=feat_type, **kw)
    if kw.get("save_feat"):
        saved = {d: np.load(os.path.join(sample_dirs, d, "target.npy"))
                 for d in sorted(os.listdir(sample_dirs))}
    ref = jstats.compute_mean_std_features(sample_dirs, "target", str(tmp_path / "j"),
                                           feat_type=feat_type, **kw)
    width = {"spec": 257, "fbanks": 80, "mfcc": 13}[feat_type] * (1 + kw.get("n_delta", 0))
    for a, b in zip(mine, ref):
        assert a.shape == (width,)
        np.testing.assert_allclose(a, b, rtol=1e-6)
    for suffix in ("_mean.npy", "_std.npy"):
        np.testing.assert_allclose(np.load(str(tmp_path / "t") + suffix),
                                   np.load(str(tmp_path / "j") + suffix), rtol=1e-6)
    if kw.get("save_feat"):
        for d, feats in saved.items():
            np.testing.assert_array_equal(feats, np.load(os.path.join(sample_dirs, d,
                                                                      "target.npy")))
    mean, std = tstats.load_stats(str(tmp_path / "t") + "_mean.npy",
                                  str(tmp_path / "t") + "_std.npy", feat_dim=min(width, 10))
    assert mean.shape == std.shape == (min(width, 10),)


def test_feature_stats_refuse_an_empty_directory(tmp_path):
    with pytest.raises(ValueError, match="no samples"):
        tstats.compute_mean_std_features(str(tmp_path), "target", "x")


def test_save_face_landmarks_is_the_reference(tmp_path, monkeypatch):
    """`save_face_landmarks` (and so `save_face_landmarks_speaker`) with the
    dlib extractor stubbed alike in both packages (seeded landmarks per
    video, one video with no face): the same landmark files and motion
    stats, byte for byte.  Without dlib and OpenCV, extraction names them."""
    videos = tmp_path / "data"
    for spk in (1, 2):
        (videos / f"s{spk}" / "video").mkdir(parents=True)
        for name in ("a", "b", "noface"):
            (videos / f"s{spk}" / "video" / f"{name}.mpg").write_bytes(b"")

    def fake_extract(video, predictor_params, refresh_size=8):
        if "noface" in video:
            return np.zeros((0,)), np.zeros((0, 4))
        rng = np.random.RandomState(len(video) + ord(video[-5]))
        return rng.randint(0, 200, (75, 68, 2)), np.zeros((75, 4))

    monkeypatch.setattr(textract, "extract_face_landmarks", fake_extract)
    monkeypatch.setattr(jextract, "extract_face_landmarks", fake_extract)
    out = {}
    for tag, pkg in (("t", textract), ("j", jextract)):
        pkg.save_face_landmarks(str(videos), [1, 2], "video", f"lm_{tag}", "predictor.dat")
        out[tag] = {spk: tree_bytes(videos / f"s{spk}" / f"lm_{tag}") for spk in (1, 2)}
    assert out["t"] == out["j"]
    assert sorted(out["t"][1]) == ["a.npy", "b.npy", "video_feat_mean.npy",
                                   "video_feat_std.npy"]
    try:
        import cv2, dlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="dlib"):
            textract._require_cv()
