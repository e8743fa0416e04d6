"""The harness's arithmetic against hand counts: the idle share from a
union of intervals, launches per step, the roofline and model
operations."""

from __future__ import annotations

import pytest

from perfbench.lib import roofline
from perfbench.lib.devtrace import Op, Trace, union_seconds
from perfbench.lib.spec import metric_reader
from perfbench.reference import blstm

FLAGSHIP = {"model": "av-blstm-ssnn-ctc", "audio_feat_dim": 257, "video_feat_dim": 136,
            "net_dim": [250, 250, 250], "num_asr_labels": 33}
GEO = {"frame_length": 384, "frame_step": 192, "fft_length": 512}


def test_idle_from_the_union_of_intervals():
    ops = [Op("k1", 0, 100), Op("k2", 50, 150), Op("Memcpy HtoD", 300, 400), Op("k3", 900, 1000)]
    assert union_seconds([(o.start_ns, o.end_ns) for o in ops]) == pytest.approx(350e-9)
    tr = Trace(ops, window_s=1000e-9)
    assert tr.busy_s() == pytest.approx(350e-9)
    assert metric_reader("idle_pct.train")({"trace": tr}, None) == pytest.approx(65.0)
    assert [o.name for o in tr.kernels()] == ["k1", "k2", "k3"]
    assert tr.device_seconds(tr.kernels(("k1", "k3"))) == pytest.approx(200e-9)
    gaps = dict(tr.idle_gaps())
    assert gaps == pytest.approx({"after Memcpy HtoD | before k3": 500e-9,
                                  "after k2 | before Memcpy HtoD": 150e-9})
    assert [name for name, _ in tr.top_ops()] == ["k1", "k2", "Memcpy HtoD", "k3"]


def test_launches_per_step():
    tr = Trace([Op(f"k{i}", i, i + 1) for i in range(30)] + [Op("Memset (Device)", 40, 41)], 1.0)
    layer = {"trace": tr, "traced_steps": 3}
    assert metric_reader("train.launches_per_step")(layer, None) == pytest.approx(10.0)


def test_training_bound_matches_the_kernel_table():
    # PERF.md's kernel table: K3 + K4 at B=32 0.1194 + 0.3582 ms, at B=8
    # 0.0299 + 0.0896 ms, by operations
    (d0, h), (d1, _), _ = blstm.layer_inputs(FLAGSHIP)
    assert (d0, d1, h) == (593, 500, 250)
    assert 1e3 * roofline.train_layer(250, 32, 250) == pytest.approx(0.1194 + 0.3582, abs=2e-4)
    assert 1e3 * roofline.train_layer(250, 8, 250) == pytest.approx(0.0299 + 0.0896, abs=2e-4)


def test_roofline_reader():
    k = [Op("void rec_cluster<float>", 0, 1_000_000), Op("void rec_cluster_bwd<float>", 0,
                                                          2_000_000),
         Op("dwh_partial", 0, 1_000_000), Op("proj_gemm_f32", 0, 5_000_000)]
    layer = {"trace": Trace(k, 1.0), "traced_steps": 2, "frames": 250, "batch": 8,
             "model": FLAGSHIP}
    least = 3 * roofline.train_layer(250, 8, 250)
    got = metric_reader("blstm_train_roofline")(layer, None)
    assert got == pytest.approx(100 * least * 2 / 4e-3)


def test_flagship_operations_by_hand():
    t = 250
    ssnn = t * (514 * 200 + 200 * 200 + 200 * 200)
    rec = 2 * t * ((593 + 250) + 2 * (500 + 250)) * 1000
    heads = t * 500 * (257 + 34)
    fft = t * 5 * 512 * 9
    fwd = 2 * (ssnn + rec + heads) + fft
    assert blstm.forward_flops(FLAGSHIP, GEO, t) == pytest.approx(fwd)
    assert blstm.train_flops(FLAGSHIP, GEO, t) == pytest.approx(3 * (fwd - fft) + fft)
    assert 2.4e9 < fwd < 2.6e9


def test_mfu_reader():
    layer = {"flops_per_utt": 67e9, "utterances": 100, "window_s": 2.0}
    assert metric_reader("mfu_pct.train")(layer, None) == pytest.approx(5.0)


def test_grid_sentences_by_hand():
    import numpy as np

    from perfbench.lib.corpus import grid_label_lengths
    from perfbench.lib.spec import cell_files, load_benchmark

    _, _, traffic = cell_files(load_benchmark(), "flagship.train")
    words = traffic["grid_words"]
    assert [len(s) for s in words] == [4, 4, 4, 25, 10, 4]  # GRID's grammar, w left out
    got = grid_label_lengths(np.random.default_rng(0), 200_000, words)
    # "lay red at a two now" .. "place green with q seven again"
    assert got.min() == 12 and got.max() == 23
    # each slot's word uniform: 3 + 3.25 + 2.25 + 48 / 25 + 3.2 + 3.25 phonemes
    assert got.mean() == pytest.approx(16.87, abs=0.01)
