"""The fused inpaint-then-recognize pipeline (`avsi_torch.infer.siasr`)
held against the reference's (`avsi.infer.siasr`) on the CPU, over the
reference fixture's test set (5 utterances of 600 ms, batches of 2, the
last padded), plain with the beam search and with both levers and greedy
decoding.

Both packages load the same two bundles written by the reference: a
flagship-shaped SI model (net_dim [16, 16, 16], 257-bin stats) and an
`a-blstm` ASR judge (net_dim [16, 16], 80-bin log-mel stats), random
weights and stats from seeds.  The reference runs its CPU default (the
scan), the port the plain versions of K1/K2.  Tolerances: the int16 wavs
relative L2 <= 1e-3 each (as tests/test_torch_infer.py), the mean losses
rtol 1e-5, the transcriptions and the PER identical.
"""

import os

import jax
import numpy as np
import pytest

from avsi import config as jconfig
from avsi import flagship as jflagship
from avsi.data import fixture
from avsi.infer import siasr as jsiasr
from avsi.models import registry as jregistry
from avsi.train import checkpoints as jckpt
from avsi.utils import wav as jwav
from avsi_torch.infer import inpaint as tinpaint
from avsi_torch.infer import siasr as tsiasr
from avsi_torch.utils import wav as twav

from helpers import tiny_config

AUDIO_LEN = 9600  # the fixture's 600 ms utterances: 50 frames


def _bundle(d, cfg, stats, name, is_asr, seed):
    os.makedirs(d)
    np.save(os.path.join(d, "audio_features_mean.npy"), stats[0])
    np.save(os.path.join(d, "audio_features_std.npy"), stats[1])
    cfg = dict(cfg, num_asr_labels=33, root_folder=d, exp_folder=d,
               audio_feat_mean=os.path.join(d, "audio_features_mean.npy"),
               audio_feat_std=os.path.join(d, "audio_features_std.npy"))
    jconfig.save_configfile(cfg, os.path.join(d, "config.txt"))
    get = jregistry.get_asr_model if is_asr else jregistry.get_model
    params = get(cfg["model"]).init(jax.random.PRNGKey(seed),
                                    jconfig.check_trainconfiguration(cfg))
    jckpt.save_checkpoint(d, name, params)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("siasr"))
    paths = fixture.make_fixture(d, n_speakers=1, n_samples=(1, 1, 5), audio_len_ms=600,
                                 gap_ms=200.0, gap_std_ms=20.0)
    rng = np.random.RandomState(0)
    _bundle(os.path.join(d, "si"), jflagship.flagship_config(net_dim=[16, 16, 16],
                                                             audio_len=AUDIO_LEN),
            (rng.uniform(0.0, 5.0, 257).astype(np.float32),
             rng.uniform(0.5, 2.0, 257).astype(np.float32)), "sinet", False, 4)
    _bundle(os.path.join(d, "asr"), tiny_config(net_dim=(16, 16), audio_len=AUDIO_LEN),
            (rng.uniform(-2.0, 8.0, 80).astype(np.float32),
             rng.uniform(1.0, 3.0, 80).astype(np.float32)), "asrnet", True, 5)
    return {"si": os.path.join(d, "si"), "asr": os.path.join(d, "asr"),
            "dict": paths["dictionary"], "test": os.path.join(paths["tfrecords"], "test-set"),
            "audio": os.path.join(paths["audio"], "test-set")}


MODES = {
    "plain_beam": dict(beam_width=100),
    "levers_greedy": dict(beam_width=0, passthrough=True,
                          gap_atten={"alpha": 0.3, "trust": 2, "ramp": 3}),
}


def _outputs(root, prefix):
    """{sample dir: (wav, transcription)} of one run."""
    out = {}
    for sample, _, names in os.walk(root):
        if prefix + ".wav" in names and os.path.basename(sample) == "enhanced":
            base = os.path.dirname(sample)
            with open(os.path.join(base, "transcriptions", prefix + ".lbl")) as f:
                out[base] = (twav.read_wav_int16(os.path.join(sample, prefix + ".wav"))[1], f.read())
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_siasr_matches_reference(corpus, mode):
    kw = dict(batch_size=2, gl_iters=3, **MODES[mode])
    args = (corpus["si"], corpus["asr"], corpus["test"], corpus["audio"])
    want = jsiasr.infer(*args, f"j_{mode}", corpus["dict"], **kw)
    got = tsiasr.infer(*args, f"t_{mode}", corpus["dict"], device="cpu", **kw)
    assert got["num_samples"] == want["num_samples"] == 5
    for key in ("loss", "loss_hole"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    assert got["per"] == want["per"] and got["utt_per_sec"] > 0
    ref, mine = _outputs(corpus["audio"], f"j_{mode}"), _outputs(corpus["audio"], f"t_{mode}")
    assert len(ref) == 5 and sorted(mine) == sorted(ref)
    for base, (w, text) in ref.items():
        g, g_text = mine[base]
        assert g_text == text, base
        w64 = w.astype(np.float64)
        assert g.shape == w.shape and np.linalg.norm(g - w64) <= 1e-3 * np.linalg.norm(w64), base


def test_siasr_wavs_are_inpaint_infers(corpus):
    """With both levers, the pipeline's wavs are `inpaint.infer`'s on the
    same SI bundle bit for bit: the same step on the same device."""
    kw = dict(batch_size=2, gl_iters=3, passthrough=True, gap_atten={"alpha": 0.3})
    tsiasr.infer(corpus["si"], corpus["asr"], corpus["test"], corpus["audio"], "s_same",
                 corpus["dict"], beam_width=0, device="cpu", **kw)
    tinpaint.infer(corpus["si"], corpus["test"], corpus["audio"], "i_same", device="cpu", **kw)
    pairs = 0
    for sample, _, names in os.walk(corpus["audio"]):
        if "s_same.wav" in names:
            a = twav.read_wav_int16(os.path.join(sample, "s_same.wav"))[1]
            b = jwav.read_wav_int16(os.path.join(sample, "i_same.wav"))[1]
            np.testing.assert_array_equal(a, b)
            pairs += 1
    assert pairs == 5
