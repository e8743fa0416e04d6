"""The port's signal ops (STFT, deltas, phase, CTC), its device rule and
its import isolation, held against the JAX reference on the CPU.

Inputs come from numpy with a seed; the same arrays feed both packages.
Tolerances: STFT coefficients max error <= 1e-5 x peak (f32 sums over
384 taps in another order); waveforms max error <= 1e-4 x peak; losses
rtol 1e-5; the Griffin-Lim waveform relative L2 <= 1e-3.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsi.ops import ctc as jctc
from avsi.ops import masks as jmasks
from avsi.ops import mel as jmel
from avsi.ops import phase as jphase
from avsi.ops import stft as jstft
from avsi_torch import device as tdevice
from avsi_torch.ops import _build
from avsi_torch.ops import ctc as tctc
from avsi_torch.ops import masks as tmasks
from avsi_torch.ops import mel as tmel
from avsi_torch.ops import phase as tphase
from avsi_torch.ops import stft as tstft

REPO = Path(__file__).resolve().parent.parent


def _wave(seed=0, shape=(2, 4800)):
    return (3000 * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _close_to_peak(got, ref, frac=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.abs(got - ref).max() <= frac * np.abs(ref).max()


@pytest.mark.parametrize("geom", [(384, 192, 512), (400, 160, 512)])
def test_stft_and_log_magnitude(geom):
    fl, fs, nfft = geom
    x = _wave()
    jl, jre, jim = jstft.log_magnitude_spectrogram(jnp.asarray(x), fl, fs, nfft)
    tl, tre, tim = tstft.log_magnitude_spectrogram(torch.from_numpy(x), fl, fs, nfft)
    assert tre.shape == jre.shape
    _close_to_peak(tre.numpy(), jre, 1e-5)
    _close_to_peak(tim.numpy(), jim, 1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


@pytest.mark.parametrize("geom", [(384, 192, 512), (400, 160, 512)])
def test_istft_round_trip(geom):
    fl, fs, nfft = geom
    x = _wave(1)
    re, im = jstft.stft_real_imag(jnp.asarray(x), fl, fs, nfft)
    re, im = np.array(re), np.array(im)
    ref = jstft.istft_real_imag(jnp.asarray(re), jnp.asarray(im), fl, fs, nfft, 4800)
    got = tstft.istft_real_imag(torch.from_numpy(re), torch.from_numpy(im), fl, fs, nfft, 4800)
    _close_to_peak(got.numpy(), ref)


def test_waveform_from_mag_complex_signed_zero():
    """Hole bins with re = -0.0 (a negative real part times a zero mask)
    resynthesize as -mag, exactly as arctan2(+-0, -0.0) = +-pi."""
    rng = np.random.RandomState(2)
    t, f = 25, 257
    mag = np.exp(rng.randn(2, t, f)).astype(np.float32)
    re = rng.randn(2, t, f).astype(np.float32)
    im = rng.randn(2, t, f).astype(np.float32)
    mask = np.ones((2, t, f), np.float32)
    mask[:, 8:15] = 0.0
    re, im = re * mask, im * mask  # keeps each zero's sign
    assert np.signbit(re[:, 8:15]).any() and (~np.signbit(re[:, 8:15])).any()
    ref = jstft.waveform_from_mag_complex(
        jnp.asarray(mag), jnp.asarray(re), jnp.asarray(im), num_samples=4800
    )
    got = tstft.waveform_from_mag_complex(
        torch.from_numpy(mag), torch.from_numpy(re), torch.from_numpy(im), num_samples=4800
    )
    _close_to_peak(got.numpy(), ref)


def test_delta_features():
    feats = np.random.RandomState(3).randn(2, 25, 257).astype(np.float32)
    ref = jmel.add_delta_features(jnp.asarray(feats), n_delta=2, N=2)
    got = tmel.add_delta_features(torch.from_numpy(feats), n_delta=2, N=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(
        tmel.delta(torch.from_numpy(feats), N=3).numpy(),
        np.asarray(jmel.delta(jnp.asarray(feats), N=3)), atol=1e-5,
    )


def test_sequence_mask():
    lengths = np.array([3, 7, 0], np.int32)
    np.testing.assert_array_equal(
        tmasks.sequence_mask(torch.from_numpy(lengths), 8).numpy(),
        np.asarray(jmasks.sequence_mask(jnp.asarray(lengths), 8)),
    )


def test_princarg_floor_semantics():
    x = np.linspace(-20, 20, 401).astype(np.float32)
    np.testing.assert_allclose(
        tphase._princarg(torch.from_numpy(x)).numpy(),
        np.asarray(jphase._princarg(jnp.asarray(x))), atol=1e-5,
    )


def _phase_inputs(seed=4, t=25, f=257):
    rng = np.random.RandomState(seed)
    phase = rng.uniform(-np.pi, np.pi, (2, t, f)).astype(np.float32)
    mask = np.ones((2, t, f), np.float32)
    mask[0, 8:15] = 0.0  # mid-utterance gap
    mask[1, :5] = 0.0  # a gap touching the sequence start
    mask[1, -4:] = 0.0  # and one touching its end
    mag = np.exp(rng.randn(2, t, f)).astype(np.float32)
    return mag, phase, mask


def test_extrapolate_phase():
    _, phase, mask = _phase_inputs()
    ref = jphase.extrapolate_phase(jnp.asarray(phase * mask), jnp.asarray(mask))
    got = tphase.extrapolate_phase(torch.from_numpy(phase * mask), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("init,relax", [("extrapolate", 0.0), ("zero", 0.0), ("extrapolate", 0.5)])
def test_griffin_lim_blend(init, relax):
    mag, phase, mask = _phase_inputs(5)
    ref = np.asarray(jphase.griffin_lim_blend(
        jnp.asarray(mag), jnp.asarray(phase), jnp.asarray(mask), 4800,
        n_iters=3, init=init, hole_mag_relax=relax,
    ))
    got = tphase.griffin_lim_blend(
        torch.from_numpy(mag), torch.from_numpy(phase), torch.from_numpy(mask), 4800,
        n_iters=3, init=init, hole_mag_relax=relax,
    ).numpy()
    assert got.shape == ref.shape == (2, 4800)
    assert np.linalg.norm(got - ref) <= 1e-3 * np.linalg.norm(ref)


def test_ctc_loss():
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 25, 34).astype(np.float32)
    logit_len = np.array([25, 20], np.int32)
    labels = np.zeros((2, 50), np.float32)
    labels[0, :5] = rng.randint(0, 33, 5)
    labels[1, :3] = rng.randint(0, 33, 3)
    label_len = np.array([5, 3], np.int32)
    args_j = [jnp.asarray(a) for a in (logits, logit_len, labels, label_len)]
    args_t = [torch.from_numpy(a) for a in (logits, logit_len, labels, label_len)]
    np.testing.assert_allclose(
        tctc.ctc_loss_per_seq(*args_t).numpy(),
        np.asarray(jctc.ctc_loss_per_seq(*args_j)), rtol=1e-5,
    )
    np.testing.assert_allclose(
        float(tctc.ctc_loss(*args_t)), float(jctc.ctc_loss(*args_j)), rtol=1e-5
    )


def test_resolve_device_needs_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|avsi)(\.|\s|$)", re.M)


# modules of the recognition and two-step slice, which the walk must reach
_SLICE_MODULES = ("avsi_torch.data.phonemes", "avsi_torch.ops.mel", "avsi_torch.ops.ctc",
                  "avsi_torch.ops.masks", "avsi_torch.models.asr", "avsi_torch.models.twosteps",
                  "avsi_torch.infer.asr", "avsi_torch.infer.siasr", "avsi_torch.infer.masking",
                  "avsi_torch.models.unet", "avsi_torch.models.unet_pconv",
                  "avsi_torch.models.unet_generic", "avsi_torch.train.tb",
                  "avsi_torch.data.native_loader", "avsi_torch.data.reader",
                  "avsi_torch.data.masks", "avsi_torch.data.landmarks",
                  "avsi_torch.data.avsync", "avsi_torch.data.generator",
                  "avsi_torch.data.fixture", "avsi_torch.data.stats",
                  "avsi_torch.data.extract", "avsi_torch.eval.metrics", "avsi_torch.eval.pesq",
                  "avsi_torch.eval.harness", "avsi_torch.eval.pesq_conformance",
                  "avsi_torch.infer.export", "avsi_torch.infer.import_tf",
                  "avsi_torch.utils.profiling", "avsi_torch.cli", "avsi_torch.__main__")


def test_port_imports_no_jax_and_no_avsi():
    """Every port module imports cleanly with no jax and no avsi loaded (the
    walk reaches every module of the recognition and two-step slice, of
    the U-Net slice, the TensorBoard writer included, of the data slice,
    and of the evaluation and command-line slice, with no tensorflow
    loaded by `infer.import_tf`), and no port source (nor chip_smoke.py)
    names them in an import, nor the reference's native loader module or its library: the loader the
    port loads is its own hashed build of `native/avsi_loader.cc` under
    `build/avsi_torch/`, as its CTC decoder is."""
    code = (
        "import importlib, pkgutil, sys, avsi_torch\n"
        "for m in pkgutil.walk_packages(avsi_torch.__path__, 'avsi_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'avsi', 'tensorflow'))\n"
        f"missing = sorted(set({_SLICE_MODULES!r}) - set(sys.modules))\n"
        "print('BAD', bad, 'MISSING', missing)\n"
        "assert not bad and not missing, (bad, missing)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    sources = list((REPO / "avsi_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for src in sources:
        text = src.read_text()
        assert not _FORBIDDEN.search(text), src
        assert "avsi.data.native_loader" not in text, src
        assert "libavsi_loader.so" not in text and "libavsi_ctc.so" not in text, src
    from avsi_torch.data import native_loader

    lib = native_loader.library_path()
    assert lib is not None, native_loader._native["error"]
    assert lib.parent == REPO / "build" / "avsi_torch"
    assert lib.name.startswith("libavsi_loader_") and lib.suffix == ".so"


def test_build_hash_covers_every_kernel_source():
    """The kernels' library is named by a hash of `_build.SOURCES` and
    `_build.HEADERS` only: every `.cu` and `.cuh` under `avsi_torch/csrc/`
    must be listed, or an edit to it would load a stale library."""
    csrc = REPO / "avsi_torch" / "csrc"
    assert sorted(_build.SOURCES) == sorted(csrc.glob("*.cu"))
    assert sorted(_build.HEADERS) == sorted(csrc.glob("*.cuh"))
