"""The plain reference agrees with `avsi_torch` at a small size on the CPU,
layer by layer, on the benchmark's own weights."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.lib import corpus as corpus_lib
from perfbench.lib import weights
from perfbench.reference import blstm
from perfbench.reference.arith import Arith

M = {"model": "av-blstm-ssnn-ctc", "audio_feat_dim": 257, "video_feat_dim": 136,
     "audio_len": 48000, "net_dim": [16, 12], "integration_layer": 0, "num_asr_labels": 33,
     "ctc_loss": 0.001, "dropout_rate": 0.0}
GEO = {"frame_length": 384, "frame_step": 192, "fft_length": 512}
TRAFFIC = {"corpus_utterances": 2, "wave_scale": 3000, "grid_words": [[2, 3], [3, 6]],
           "gaps": {"n_max": 1, "cov_mean": 0.3333, "cov_std": 0.1}}
STATS = {"mean": [9.5, 10.5], "std": [0.8, 1.2]}


def _both(m, geo, seed=3):
    cpu = torch.device("cpu")
    c = corpus_lib.draw(seed, m, geo, TRAFFIC, cpu)
    rows = np.arange(2)
    host = corpus_lib.host_batch(c, rows, m["audio_feat_dim"])
    return c, host, corpus_lib.ref_batch(c, rows, cpu), weights.stats(seed, m["audio_feat_dim"],
                                                                       STATS)


def _port_batch(host, af):
    from avsi_torch.parallel import mesh

    out = mesh.expand_batch({k: torch.as_tensor(v) for k, v in mesh.compact_batch(host).items()},
                            af)
    return out


def test_blstm_forward_matches_the_port():
    from avsi_torch.models import registry

    _, host, rb, (mean, std) = _both(M, GEO)
    flat = weights.draw(blstm.param_shapes(M), 5, "cpu")
    model = registry.get_model(M["model"])
    cfg = dict(M, num_asr_labels=34, lstm_impl="plain")
    st = (torch.from_numpy(mean), torch.from_numpy(std))
    got = model.forward(weights.nest(flat), _port_batch(host, 257), cfg, st)
    want = blstm.forward(Arith(), flat, rb, M, GEO, st)
    torch.testing.assert_close(got["prediction"], want["prediction"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["asr_logits"], want["logits"], rtol=1e-5, atol=1e-5)
    pb = _port_batch(host, 257)
    pb["ctc_infeasible"] = np.zeros(2, bool)
    port_loss = model.losses(got, pb, cfg)["loss"]
    torch.testing.assert_close(port_loss, blstm.loss(want, rb, M), rtol=1e-5, atol=1e-6)


def test_control_rounds_to_tf32():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -3.0])
    from perfbench.reference.arith import round_tf32

    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -9, -3.0]
