"""The oracle-mask baseline held against the JAX reference on the CPU: the
oracle masks (`avsi_torch.ops.masks`), their NaN-free gradient at silent
bins, and `mask_app` (`masked.wav` with oracle and masked phase) over the
reference fixture's test set.

Tolerances: mask values rtol 1e-5 (atol 1e-6 for values near zero);
gradients rtol 1e-4, atol 1e-6 (f32 chains of divides); the mean hole
loss rtol 1e-5 (the same f32 DFTs, summed in another order); the int16
wavs within 1 LSB per sample and relative L2 <= 1e-3 each.  The wavs
resynthesize the int16 input exactly outside the gaps in exact
arithmetic, so their f32 values sit on integers and the int16 cast, which
truncates, takes the integer below for about half of them in either
package: a 1 LSB difference on many samples, not a larger one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsi.data import fixture
from avsi.infer import masking as jmasking
from avsi.ops import masks as jmasks
from avsi.utils import wav as jwav
from avsi_torch.data import generator as tgenerator
from avsi_torch.infer import masking as tmasking
from avsi_torch.ops import masks as tmasks
from avsi_torch.utils import wav as twav

MASKS = {"iam": (jmasks.oracle_iam, tmasks.oracle_iam),
         "ipsm": (jmasks.oracle_ipsm, tmasks.oracle_ipsm)}


def _parts(seed=0, shape=(2, 6, 9)):
    """Real and imaginary parts of a target and a mixture: small mixture bins
    (the clip), silent bins in both, a silent target under a live mixture,
    and a live target under a silent mixture."""
    rng = np.random.RandomState(seed)
    tr, ti, mr, mi = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    mr[:, 1], mi[:, 1] = 0.01 * mr[:, 1], 0.01 * mi[:, 1]
    for a in (tr, ti, mr, mi):
        a[:, 2] = 0.0
    tr[:, 3], ti[:, 3] = 0.0, 0.0
    mr[:, 4], mi[:, 4] = 0.0, 0.0
    return tr, ti, mr, mi


@pytest.mark.parametrize("kind", list(MASKS))
def test_oracle_masks_match_reference(kind):
    """Values and the gradient with respect to all four parts, against the
    reference's and `jax.grad`; silent mixture bins give mask 0, and the
    port's gradient is finite everywhere.  The reference's IPSM gradient is
    NaN at silent bins (the derivative of `jnp.angle` at 0 is 0/0, which
    the guarded divide does not reach), so there it is held only where the
    reference's is finite; `torch.angle` differentiates to 0 at 0."""
    jfn, tfn = MASKS[kind]
    parts = _parts()
    weights = np.random.RandomState(1).rand(*parts[0].shape).astype(np.float32)

    def jloss(tr, ti, mr, mi):
        mask = jfn((tr + 1j * ti).astype(jnp.complex64), (mr + 1j * mi).astype(jnp.complex64))
        return jnp.sum(mask * weights), mask

    (_, ref), j_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(p) for p in parts))
    tp = [torch.from_numpy(p).requires_grad_() for p in parts]
    got = tfn(torch.complex(tp[0], tp[1]), torch.complex(tp[2], tp[3]))
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert got.dtype == torch.float32
    assert (got.detach().numpy()[:, 2] == 0).all() and (got.detach().numpy()[:, 4] == 0).all()
    silent = np.zeros(parts[0].shape, bool)
    silent[:, 2:5] = kind == "ipsm"  # a silent target, mixture, or both
    for t, j in zip(tp, j_grads):
        j = np.asarray(j)
        assert np.isfinite(t.grad.numpy()).all()
        assert not np.isnan(j[~silent]).any()
        finite = ~np.isnan(j)
        np.testing.assert_allclose(t.grad.numpy()[finite], j[finite], rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference's fixture (5 test utterances of 600 ms: batches of 2,
    2 and a padded 1) and feature stats from a seed."""
    d = str(tmp_path_factory.mktemp("mask_corpus"))
    paths = fixture.make_fixture(d, n_speakers=1, n_samples=(1, 1, 5), audio_len_ms=600,
                                 gap_ms=200.0, gap_std_ms=20.0)
    rng = np.random.RandomState(0)
    np.save(os.path.join(d, "mean.npy"), rng.uniform(0.0, 5.0, 257).astype(np.float32))
    np.save(os.path.join(d, "std.npy"), rng.uniform(0.5, 2.0, 257).astype(np.float32))
    return {"test": os.path.join(paths["tfrecords"], "test-set"), "root": d,
            "audio": paths["audio"], "dictionary": paths["dictionary"]}


@pytest.mark.parametrize("oracle_phase", [True, False], ids=["oracle_phase", "masked_phase"])
def test_mask_app_matches_reference(corpus, tmp_path, oracle_phase):
    kw = dict(oracle_phase=oracle_phase, num_audio_samples=9600, batch_size=2,
              feat_mean_file=os.path.join(corpus["root"], "mean.npy"),
              feat_std_file=os.path.join(corpus["root"], "std.npy"))
    want = jmasking.mask_app(corpus["test"], str(tmp_path / "j"), **kw)
    got = tmasking.mask_app(corpus["test"], str(tmp_path / "t"), device="cpu", **kw)
    assert got["num_samples"] == want["num_samples"] == 5
    np.testing.assert_allclose(got["loss_hole"], want["loss_hole"], rtol=1e-5)
    pairs = 0
    for root, _, names in os.walk(tmp_path / "j"):
        if "masked.wav" not in names:
            continue
        mine = os.path.join(str(tmp_path / "t"), os.path.relpath(root, tmp_path / "j"))
        _, w = jwav.read_wav_int16(os.path.join(root, "masked.wav"))
        _, g = twav.read_wav_int16(os.path.join(mine, "masked.wav"))
        assert g.shape == w.shape and np.any(w)
        w64 = w.astype(np.float64)
        assert np.abs(g - w64).max() <= 1.0, root
        assert np.linalg.norm(g - w64) <= 1e-3 * np.linalg.norm(w64), root
        pairs += 1
    assert pairs == 5


def test_mask_app_refuses_var_mode_and_empty_dirs(corpus, tmp_path):
    """Var mode, refused before the var reader was ported, runs (held against
    the reference in tests/test_torch_var_mode.py): on the var-mode records of
    the same utterances (50 frames, a multiple of 25, so the padded batches
    are the fixed ones) its wavs equal the fixed mode's.  A directory without
    records is refused."""
    var_root = str(tmp_path / "var")
    tgenerator.create_dataset(corpus["audio"], var_root, corpus["dictionary"],
                              tfrecord_mode="var")
    kw = dict(batch_size=2, device="cpu")
    fixed = tmasking.mask_app(corpus["test"], str(tmp_path / "fixed"), num_audio_samples=9600,
                              **kw)
    var = tmasking.mask_app(os.path.join(var_root, "test-set"), str(tmp_path / "varout"),
                            tfrecord_mode="var", **kw)
    assert var == fixed and var["num_samples"] == 5
    for name in os.listdir(tmp_path / "fixed"):
        _, w = twav.read_wav_int16(str(tmp_path / "fixed" / name / "masked.wav"))
        _, g = twav.read_wav_int16(str(tmp_path / "varout" / name / "masked.wav"))
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="no tfrecords"):
        tmasking.mask_app(str(tmp_path), str(tmp_path), device="cpu")
