"""The port's CTC prefix beam search held against the reference's
(`avsi.ops.ctc.beam_search_decode` and `beam_search_decode_batch`, which
run the reference's build of the native decoder) on the CPU: the port's
native decoder (its own build of `native/avsi_ctc.cc`) and its Python
twin, on seeded logits at beam widths 1, 20 and 100, peaked logits with
runs of one symbol, quantized logits full of exact ties, and rows of zero
length.  Sequences must be identical (no tolerance).

The reference's own Python search sorts float32 scores stably and so
differs from its native decoder where equal scores meet at the beam's cut;
the port's Python search is the native decoder's twin, so there the port
follows the native decoder, and on logits without such ties it equals the
reference's Python search too.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from avsi.data import native_loader
from avsi.ops import ctc as jctc
from avsi_torch.ops import ctc as tctc

REPO = Path(__file__).resolve().parent.parent


def _logits(kind: str, seed: int, b: int = 4, t: int = 40, c: int = 12) -> np.ndarray:
    rng = np.random.RandomState(seed)
    x = (2.0 * rng.randn(b, t, c)).astype(np.float32)
    if kind == "peaked":
        # a confident path with runs of one symbol, repeats split by a blank
        # and a repeat run with no blank between (merged by CTC)
        path = rng.randint(0, c - 1, t)
        path[5:9], path[9], path[10:13] = 3, c - 1, 3
        x = rng.randn(b, t, c).astype(np.float32)
        x[:, np.arange(t), path] += 12.0
    elif kind == "ties":
        # quantized logits: many exactly equal scores, within and across rows
        x = np.round(rng.randn(b, t, c)).astype(np.float32)
        x[:, ::3, :] = 0.0  # whole frames of equal scores
    return x


CASES = [(kind, width) for kind in ("random", "peaked", "ties") for width in (1, 20, 100)]


def test_native_decoder_builds_here():
    """The native decoder builds with g++ into build/avsi_torch/, so the
    parity below holds the native search (where no g++ exists the port
    falls back to the Python search, which the same tests then hold)."""
    assert tctc.beam_impl() == "native", tctc._native.get("error")
    assert tctc._build.BUILD_DIR in Path(tctc._native["lib"]._name).parents


@pytest.mark.parametrize("kind,width", CASES, ids=[f"{k}-w{w}" for k, w in CASES])
def test_beam_search_matches_reference(kind, width):
    """Batch and single-sequence searches, native and Python, against the
    reference's, with one row cut short and one of zero length."""
    assert native_loader.is_available()  # the reference's decoder is its native one here
    logits = _logits(kind, seed=width)
    lens = np.asarray([40, 27, 0, 40])
    want = jctc.beam_search_decode_batch(logits, lens, width)
    assert want[2] == []
    assert tctc.beam_search_decode_batch(logits, lens, width) == want
    for i in range(len(lens)):
        assert tctc.beam_search_decode(logits[i], int(lens[i]), width) == want[i]
        assert tctc._beam_search_decode_py(logits[i], int(lens[i]), width) == want[i]
        if kind != "ties":
            assert want[i] == jctc._beam_search_decode_py(logits[i], int(lens[i]), width)
    if kind == "peaked":
        # a confident path decodes to its greedy collapse at any width
        greedy = [[int(v) for v in row if v >= 0] for row in tctc.greedy_decode(
            torch.from_numpy(logits), torch.from_numpy(lens)).numpy()]
        assert want == greedy


@pytest.mark.parametrize("kind", ["random", "peaked", "ties"])
def test_native_equals_python(kind):
    """The port's two searches give the same sequences on the same logits,
    ties included, at widths 2, 20 and the judge's 100 (34 classes, as the
    ASR's 33 phonemes and the blank, over 60 frames)."""
    logits = _logits(kind, seed=7, b=3, t=60, c=34)
    lens = np.asarray([60, 45, 60])
    for width in (2, 20, 100):
        native = tctc.beam_search_decode_batch(logits, lens, width)
        python = [tctc._beam_search_decode_py(logits[i], int(lens[i]), width) for i in range(3)]
        assert native == python, (kind, width)


def test_python_fallback_where_native_does_not_build(tmp_path):
    """With no compiler on the PATH and an empty build directory the port
    says "python" and decodes with the Python twin (a fresh process, so
    this process's loaded library is not reused); a width below 1 raises."""
    code = (
        "import numpy as np\n"
        "from avsi_torch.ops import _build, ctc\n"
        f"_build.BUILD_DIR = __import__('pathlib').Path({str(tmp_path)!r})\n"
        "x = np.random.RandomState(0).randn(2, 20, 6).astype(np.float32)\n"
        "print(ctc.beam_impl(), ctc.beam_search_decode_batch(x, [20, 9], 8))\n"
        "print([ctc._beam_search_decode_py(x[i], n, 8) for i, n in enumerate([20, 9])])\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    first, second = proc.stdout.strip().splitlines()
    assert first.startswith("python ") and first[len("python "):] == second
    with pytest.raises(ValueError, match="width"):
        tctc.beam_search_decode(_logits("random", 0)[0], 40, 0)
