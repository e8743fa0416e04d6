"""The port's scoring (`avsi_torch.eval`), its STFT helpers and its
profiling tools, held against the JAX package's on the CPU.

The scoring is host numpy in both packages, so the same seeded inputs give
the same numbers: the metrics are held bit for bit (rtol 1e-12 where a
float sum may reorder), PESQ abs 1e-9, and the harnesses' CSV files cell
for cell.  The STFT helpers take `tests/test_torch_ops.py`'s tolerances:
coefficients max error <= 1e-5 x peak, waveforms <= 1e-4 x peak.
"""

import csv
import json
import os
import stat
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsi.eval import harness as jharness
from avsi.eval import metrics as jmetrics
from avsi.eval import pesq as jpesq
from avsi.eval import pesq_conformance as jconf
from avsi.ops import stft as jstft
from avsi.utils import wav as jwav
from avsi_torch.eval import harness as tharness
from avsi_torch.eval import metrics as tmetrics
from avsi_torch.eval import pesq as tpesq
from avsi_torch.eval import pesq_conformance as tconf
from avsi_torch.ops import stft as tstft
from avsi_torch.utils import profiling

SR = 16000


def _speech(seed, n=SR):
    """A voiced, syllabic int16-scale test wave of n samples."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    f0 = rng.uniform(110, 220)
    x = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6)) / k for k in range(1, 6))
    env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2, 4) * t)
    return np.round(5000 * env * x + 100 * rng.randn(n)).astype(np.float64)


def _pair(seed, n=SR):
    clean = _speech(seed, n)
    rng = np.random.RandomState(seed + 100)
    deg = clean + 600 * rng.randn(n)
    deg[n // 3: n // 3 + n // 8] = 0.0
    return clean, np.round(deg)


METRICS = ["l1_eval", "l2_eval", "sisdr_eval", "sdr_eval", "stoi_eval"]


@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_reference(name):
    """Each metric on a seeded pair of unequal lengths (the common prefix
    is scored), and on the silent-estimate and identical edge cases."""
    clean, deg = _pair(1)
    cases = [(clean, deg[:-37]), (clean, clean), (clean, np.zeros_like(clean))]
    for target, est in cases:
        want = getattr(jmetrics, name)(target, est)
        got = getattr(tmetrics, name)(target, est)
        if np.isnan(want):
            assert np.isnan(got)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_stoi_pieces_match_reference():
    """The STOI internals: the third-octave bands, the framing and the
    silent-frame removal, bit for bit."""
    np.testing.assert_array_equal(tmetrics._thirdoct(10000, 512, 15, 150),
                                  jmetrics._thirdoct(10000, 512, 15, 150))
    clean, deg = _pair(2)
    np.testing.assert_array_equal(tmetrics._stoi_frames(clean), jmetrics._stoi_frames(clean))
    for got, want in zip(tmetrics._remove_silent(clean, deg), jmetrics._remove_silent(clean, deg)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["nb", "wb"])
def test_pesq_measure_matches_reference(mode):
    """The native P.862 on the conformance battery's pairs (AWGN, MNRU, a
    delay, a hole, a gain) and a delayed, scaled pair: abs 1e-9."""
    probes = tconf.probe_battery()
    clean, _ = _pair(3)
    probes.append(("delayed_scaled", clean, 0.5 * np.concatenate([np.zeros(333), clean])))
    for name, ref, deg in probes:
        got = tpesq.pesq_measure(ref, deg, SR, mode)
        want = jpesq.pesq_measure(ref, deg, SR, mode)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9, err_msg=name)


def test_probe_battery_and_native_scores_match_reference():
    ours, theirs = tconf.probe_battery(), jconf.probe_battery()
    assert [p[0] for p in ours] == [p[0] for p in theirs]
    for (_, r1, d1), (_, r2, d2) in zip(ours, theirs):
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(d1, d2)
    short = ours[3:6]  # MNRU and the delay: the fast probes
    got = tconf.score_native(short, "nb", gain=6.5)
    want = jconf.score_native(short, "nb", gain=6.5)
    assert got.keys() == want.keys()
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-9, k
    assert tpesq._SL_16K == jpesq._SL_16K  # the gain is restored


def _fake_pesq(tmp_path):
    """An executable that prints what the ITU binary prints: the MOS it
    reads from the length of the degraded file's name (nb: raw and LQO)."""
    path = tmp_path / "fake_pesq"
    path.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "deg = sys.argv[-1]\n"
        "mos = 1.0 + (len(deg) % 30) / 10.0\n"
        "if '+wb' in sys.argv:\n"
        "    print(f'P.862.2 Prediction (MOS-LQO):  = {mos:.3f}')\n"
        "else:\n"
        "    print(f'P.862 Prediction (Raw MOS, MOS-LQO):  = {mos:.3f}\\t{mos - 0.2:.3f}')\n"
    )
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


@pytest.mark.parametrize("mode", ["nb", "wb"])
def test_score_binary_and_pesq_eval_through_a_fake_binary(tmp_path, mode):
    """`score_binary` and `pesq_eval` parse a binary's output as the
    reference does; a missing binary gives (nan, nan) in both."""
    binary = _fake_pesq(tmp_path)
    probes = tconf.probe_battery()[:3]
    got = tconf.score_binary(probes, binary, mode, workdir=str(tmp_path))
    want = jconf.score_binary(probes, binary, mode, workdir=str(tmp_path))
    assert got == want and all(np.isfinite(v) for v in got.values())
    clean, deg = _pair(4)
    jwav.write_wav_int16(str(tmp_path / "ref.wav"), clean, SR)
    jwav.write_wav_int16(str(tmp_path / "deg.wav"), deg, SR)
    args = (str(tmp_path / "ref.wav"), str(tmp_path / "deg.wav"))
    assert tmetrics.pesq_eval(*args, binary, mode) == jmetrics.pesq_eval(*args, binary, mode)
    assert tmetrics.pesq_eval(*args, None, mode) == jmetrics.pesq_eval(*args, None, mode)
    missing = str(tmp_path / "no_such_binary")
    for got in (tmetrics.pesq_eval(*args, missing, mode), jmetrics.pesq_eval(*args, missing, mode)):
        assert np.isnan(got[0]) and np.isnan(got[1])


def test_conformance_run_matches_reference(tmp_path):
    """`run` through the fake binary with a two-gain grid: the same report,
    but for the note that names the package to edit."""
    binary = _fake_pesq(tmp_path)
    got = tconf.run(binary, "wb", gain_grid=(5.0, 7.0))
    want = jconf.run(binary, "wb", gain_grid=(5.0, 7.0))
    assert "avsi_torch/eval/pesq.py" in got.pop("note")
    want.pop("note")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def _sample_tree(root, n=4):
    """Sample directories as inference and masking leave them: target.wav,
    enhanced/x.wav, masked.wav, transcription.lbl, transcriptions/x.lbl and
    masked.lbl; sample 1 lacks masked.wav and masked.lbl (a partial row),
    sample 2 its transcriptions, and sample 3 its enhanced wav (no row)."""
    for i in range(n):
        d = os.path.join(root, f"s1_utt{i:03d}")
        os.makedirs(os.path.join(d, "enhanced"))
        os.makedirs(os.path.join(d, "transcriptions"))
        clean, deg = _pair(10 + i, SR // 2)
        enh = clean + 150 * np.random.RandomState(i).randn(len(clean))
        jwav.write_wav_int16(os.path.join(d, "target.wav"), clean, SR)
        if i != 3:
            jwav.write_wav_int16(os.path.join(d, "enhanced", "x.wav"), enh[: len(clean) - 5 * i], SR)
        if i != 1:
            jwav.write_wav_int16(os.path.join(d, "masked.wav"), deg, SR)
            with open(os.path.join(d, "masked.lbl"), "w") as f:
                f.write("sil,b,ih,n")
        with open(os.path.join(d, "transcription.lbl"), "w") as f:
            f.write("sil,b,ih,n,sil")
        if i != 2:
            with open(os.path.join(d, "transcriptions", "x.lbl"), "w") as f:
                f.write("sil,b,n,sil")
    os.makedirs(os.path.join(root, "not_a_sample.txt.d"), exist_ok=True)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


HARNESS_CASES = [(fn, me, sdr, 0) for fn in ("speech_inpainting_eval", "speech_enhancement_eval")
                 for me in (True, False) for sdr in (True, False)] + [
    ("speech_inpainting_eval", True, True, 2), ("speech_enhancement_eval", True, False, 2)]


@pytest.mark.parametrize("fn,masked_eval,with_sdr,workers", HARNESS_CASES)
def test_harness_csv_matches_reference(tmp_path, capsys, fn, masked_eval, with_sdr, workers):
    """Both protocols on one sample tree: the CSV equal cell for cell and
    the summaries equal (NaN where the reference's is), the printed lines
    the same; the port with `workers` processes (spawned), the reference
    in one."""
    tree = str(tmp_path / "audio")
    _sample_tree(tree)
    got = getattr(tharness, fn)(tree, "x", "ours", masked_eval, num_workers=workers,
                                with_sdr=with_sdr)
    ours_out = capsys.readouterr().out
    want = getattr(jharness, fn)(tree, "x", "theirs", masked_eval, with_sdr=with_sdr)
    theirs_out = capsys.readouterr().out
    assert _rows(os.path.join(tree, "ours.csv")) == _rows(os.path.join(tree, "theirs.csv"))
    assert len(_rows(os.path.join(tree, "ours.csv"))) == 4  # header + 3 samples
    assert ours_out.replace("ours.csv", "X") == theirs_out.replace("theirs.csv", "X")
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_harness_with_no_samples(tmp_path, capsys):
    assert tharness.speech_inpainting_eval(str(tmp_path), "x", "o") == {}
    assert "No evaluable samples found." in capsys.readouterr().out


STFT_CASES = [((2, 4800), 384, 192, 512), ((3, 2048), 256, 128, 256)]


@pytest.mark.parametrize("shape,fl,fs,nfft", STFT_CASES)
def test_stft_helpers_match_reference(shape, fl, fs, nfft):
    """`stft` (complex), `spectrogram` (power 1 and 2, log), `istft` and
    `preemphasis` against the reference on the same seeded wave."""
    x = (3000 * np.random.RandomState(5).randn(*shape)).astype(np.float32)
    got = tstft.stft(torch.from_numpy(x), fl, fs, nfft)
    want = np.asarray(jstft.stft(jnp.asarray(x), fl, fs, nfft))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    peak = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * peak
    for power, log in ((1.0, False), (2.0, False), (1.0, True)):
        s_got = tstft.spectrogram(got, power, log).numpy()
        s_want = np.asarray(jstft.spectrogram(jnp.asarray(want), power, log))
        assert np.abs(s_got - s_want).max() <= 1e-5 * np.abs(s_want).max()
    wav = tstft.istft(torch.from_numpy(np.array(want)), fl, fs, nfft, shape[-1]).numpy()
    wav_want = np.asarray(jstft.istft(jnp.asarray(want), fl, fs, nfft, shape[-1]))
    assert wav.shape == wav_want.shape
    assert np.abs(wav - wav_want).max() <= 1e-4 * np.abs(wav_want).max()
    pre = tstft.preemphasis(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(pre, np.asarray(jstft.preemphasis(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6 * np.abs(x).max())


def test_trace_writes_a_chrome_trace(tmp_path):
    """`trace(logdir)` on the CPU: a Chrome trace naming the ops it ran and
    the spans recorded inside it."""
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.span("train.step", step=0):
            torch.matmul(torch.ones(64, 64), torch.ones(64, 64)).sum()
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert [e["name"] for e in events if e.get("cat") == "span"] == ["train.step"]
