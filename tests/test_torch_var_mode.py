"""Var-mode corpora through the port on the CPU, held against the JAX
package: the padded reader batches (frames rounded up to 25, waves to
frames x 192, labels to the longest), exact; and `mask_app(tfrecord_mode=
"var")`, each batch resynthesized at its padded length, with the fixed-mode
test's tolerances (tests/test_torch_masking.py): each wav within 1 LSB per
sample and relative L2 <= 1e-3, the mean hole loss rtol 1e-5.
"""

import os

import numpy as np
import pytest

from avsi.data import reader as jreader
from avsi.infer import masking as jmasking
from avsi.utils import wav as jwav
from avsi_torch.data import reader as treader
from avsi_torch.data import tfrecord as tfr
from avsi_torch.infer import masking as tmasking
from avsi_torch.utils import wav as twav

LENGTHS = (37, 12, 60, 55, 30)


@pytest.fixture(scope="module")
def var_corpus(tmp_path_factory):
    """Var-mode records of 5 utterances of 12-60 frames: int16-valued waves
    of frames x 192 samples with a gap, video, labels of 2-6 entries."""
    d = tmp_path_factory.mktemp("var")
    files = []
    for i, t in enumerate(LENGTHS):
        rng = np.random.RandomState(i)
        mask = np.ones((t, 257), np.float32)
        mask[t // 3:t // 3 + 5] = 0.0
        wave = np.round(3000 * np.sin(np.arange(t * 192) * (0.05 + 0.01 * i))
                        + 100 * rng.randn(t * 192)).astype(np.float32)
        rec = tfr.serialize_sample_var(
            t, 2 + i, wave, rng.randn(t, 136).astype(np.float32), mask,
            np.arange(2 + i, dtype=np.float32) + 1, f"s1_var_{i}")
        path = str(d / f"data_{i:03d}.tfrecord")
        with tfr.TFRecordWriter(path) as w:
            w.write(rec)
        files.append(path)
    return files


def test_var_batches_are_the_reference(var_corpus):
    """Shuffled and padded epochs, batches of 2: the same batches in the same
    order, every array equal; the frame counts round up to 25."""
    kw = dict(mode="var", seed=5)
    mine, ref = treader.DataManager(**kw), jreader.DataManager(**kw)
    assert not mine.use_native
    for run in (dict(shuffle=True), dict(shuffle=True, drop_remainder=True),
                dict(pad_final=True)):
        a = list(mine.prefetch_batches(var_corpus, 2, **run))
        b = list(ref.batches(var_corpus, 2, **run))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert sorted(x) == sorted(y)
            assert x["masks"].shape[1] % 25 == 0
            assert x["target_sources"].shape[1] == x["masks"].shape[1] * 192
            for key in y:
                np.testing.assert_array_equal(np.asarray(x[key]), np.asarray(y[key]),
                                              err_msg=key)
    batch = next(iter(mine.batches(var_corpus[:2], 2)))
    assert batch["masks"].shape == (2, 50, 257) and batch["labels"].shape == (2, 3)
    np.testing.assert_array_equal(batch["sequence_lengths"], [37, 12])


@pytest.mark.parametrize("oracle_phase", [True, False], ids=["oracle_phase", "masked_phase"])
def test_var_mask_app_is_the_reference(var_corpus, tmp_path, oracle_phase):
    """`mask_app` in var mode over the 5 utterances (batches of 2: 50, 75 and
    a padded 50 frames): the same count, the hole loss, and every masked.wav
    (trimmed to its own length) against the reference's."""
    data = os.path.dirname(var_corpus[0])
    kw = dict(tfrecord_mode="var", oracle_phase=oracle_phase, batch_size=2)
    want = jmasking.mask_app(data, str(tmp_path / "j"), **kw)
    got = tmasking.mask_app(data, str(tmp_path / "t"), device="cpu", **kw)
    assert got["num_samples"] == want["num_samples"] == len(LENGTHS)
    np.testing.assert_allclose(got["loss_hole"], want["loss_hole"], rtol=1e-5)
    for i, t in enumerate(LENGTHS):
        _, w = jwav.read_wav_int16(str(tmp_path / "j" / f"s1_var_{i}" / "masked.wav"))
        _, g = twav.read_wav_int16(str(tmp_path / "t" / f"s1_var_{i}" / "masked.wav"))
        assert g.shape == w.shape == (t * 192,) and np.any(w)
        w64 = w.astype(np.float64)
        assert np.abs(g - w64).max() <= 1.0, i
        assert np.linalg.norm(g - w64) <= 1e-3 * np.linalg.norm(w64), i
