"""The port's live streaming (`avsi_torch.infer.streaming`) held against the
JAX reference (`avsi.infer.streaming`) on the CPU.

Both packages get the same weights (the reference's init, carried over by
`params_from_flat`), the same random normalization stats and the same
int16-valued waves, masks and video made from numpy seeds.  The JAX side
runs its scan window, or `lstm_impl="pallas"` (the Pallas LC window kernel
in interpret mode) where a test says so; the port runs on `device="cpu"`,
where "auto" takes the plain version of K5 (f32 gates) or, under bf16
gates, the scan twin, which are the functions the reference's scan and
kernel compute.

Tolerances, as a share of the reference's peak sample: 1e-5 in f32 (f32
sums in another order through three small layers and the OLA), 1e-3
under bf16 (a rounding flip of a bf16 value); the port's lockstep fleet
against its own single stream 1e-4 (the fleet featurizes with the
matmul-DFT, the stream with numpy's FFT).  Transcripts are equal.
"""

import jax
import numpy as np
import pytest
import torch

from avsi.infer import streaming as jstreaming
from avsi.models import blstm as jblstm
from avsi_torch.infer import inpaint as tinpaint
from avsi_torch.infer import streaming
from avsi_torch.models import registry as tregistry
from avsi_torch.train import checkpoints as tckpt

from helpers import synth_batch, tiny_config

AL, T = 4800, 25  # 25 frames
TOL = {"float32": 1e-5, "bfloat16": 1e-3}
FLAGSHIP = "av-blstm-ssnn-ctc"


def _setup(model, **cfg_kw):
    """(config, spec, JAX params, port params, stats)."""
    config = tiny_config(model=model, audio_len=AL, net_dim=(16, 16), **cfg_kw)
    spec = jblstm.parse_model_name(model)
    params_j = jblstm.init(jax.random.PRNGKey(3), config, spec)
    flat = {"/".join(str(p).strip("[].'") for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params_j)[0]}
    rng = np.random.RandomState(1)
    stats = (rng.uniform(0.0, 5.0, 257).astype(np.float32),
             rng.uniform(0.5, 2.0, 257).astype(np.float32))
    return config, spec, params_j, tckpt.params_from_flat(flat), stats


def _inputs(config, batch_size=1, seed=5, gap=(6, 13)):
    """int16-valued waves (B, AL), frame masks (B, T), video (B, T, 136),
    embeddings (B, 512)."""
    b = synth_batch(config, batch_size=batch_size, seed=seed, gap=gap)
    waves = np.round(30000 * np.asarray(b["target_sources"])).astype(np.float32)
    return (waves, np.array(b["masks"][:, :, 0]), np.asarray(b["video_features"]),
            np.asarray(b["embeddings"]))


def _close(got, want, tol):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _pair(config, stats, params_j, params_t, jax_impl="scan", **kw):
    """The reference's and the port's StreamingInpainter, same options."""
    return (jstreaming.StreamingInpainter(config, stats, params_j, lstm_impl=jax_impl, **kw),
            streaming.StreamingInpainter(config, stats, params_t, device="cpu", **kw))


# ----------------------------------------------------------- single stream

@pytest.mark.parametrize(
    "model,cfg_kw",
    [
        ("a-blstm", {}),
        ("v-blstm", {}),
        (FLAGSHIP, {}),
        ("av-blstm-ssnn", {"integration_layer": 1}),
        ("av-blstm-emb", {}),
        ("a-blstm", {"compute_dtype": "bfloat16", "gate_dtype": "float32"}),
        ("a-blstm-ssnn", {"compute_dtype": "bfloat16"}),
    ],
)
def test_full_window_matches_reference(model, cfg_kw):
    """One window over the whole utterance (C=T, L=0), every variant of the
    reference's offline-equality test."""
    config, spec, params_j, params_t, stats = _setup(model, **cfg_kw)
    waves, masks, videos, embs = _inputs(config)
    emb = embs[0] if spec.conditioning == "emb" else None
    inp_j, inp_t = _pair(config, stats, params_j, params_t, chunk_frames=T,
                         lookahead_frames=0, embedding=emb)
    bf16_gates = cfg_kw.get("compute_dtype") == "bfloat16" and "gate_dtype" not in cfg_kw
    assert inp_t.lstm_impl == ("scan" if bf16_gates else "plain")
    want = jstreaming.stream_utterance(inp_j, waves[0], masks[0], videos[0])
    got = streaming.stream_utterance(inp_t, waves[0], masks[0], videos[0])
    assert got.shape == (T * 192,) and got.dtype == np.float32
    _close(got, want, TOL[cfg_kw.get("compute_dtype", "float32")])


def test_full_window_matches_port_offline():
    """The port's own streaming and offline paths tie together: a window
    covering the utterance is the offline `phase_recon="none"` step (int16
    output, relative L2 <= 1e-3, as on the card)."""
    config, spec, _, params_t, stats = _setup(FLAGSHIP)
    waves, masks, videos, _ = _inputs(config)
    videos = videos.astype(np.float16)  # the offline batch carries f16 video
    inp = streaming.StreamingInpainter(config, stats, params_t, chunk_frames=T,
                                       lookahead_frames=0, device="cpu")
    got = np.clip(streaming.stream_utterance(inp, waves[0], masks[0], videos[0]), -32768, 32767)
    step = tinpaint.make_infer_step(tregistry.get_model(FLAGSHIP), config, stats, False,
                                    "none", 0, device="cpu")
    batch = {
        "sequence_lengths": np.array([T], np.int32), "labels_lengths": np.ones(1, np.int32),
        "target_sources": waves.astype(np.int16), "labels": np.zeros((1, 50), np.float32),
        "video_features": videos, "mask_frames": masks.astype(np.int8),
    }
    want = step(params_t, batch)[0][0].numpy().astype(np.float64)
    assert np.linalg.norm(got[:AL].astype(np.int16) - want) <= 1e-3 * np.linalg.norm(want)


def test_chunked_stream_matches_pallas_reference():
    """C=5/L=7 on the flagship with transcripts, against the reference
    serving its Pallas LC window kernel (interpret mode)."""
    config, _, params_j, params_t, stats = _setup(FLAGSHIP)
    waves, masks, videos, _ = _inputs(config)
    inp_j, inp_t = _pair(config, stats, params_j, params_t, jax_impl="pallas",
                         chunk_frames=5, lookahead_frames=7, transcript=True)
    want = jstreaming.stream_utterance(inp_j, waves[0], masks[0], videos[0])
    got = streaming.stream_utterance(inp_t, waves[0], masks[0], videos[0])
    _close(got, want, TOL["float32"])
    assert inp_t.transcript == inp_j.transcript


def test_push_size_invariance():
    """Outputs and transcripts do not depend on how samples arrive."""
    config, _, _, params_t, stats = _setup(FLAGSHIP)
    waves, masks, videos, _ = _inputs(config)
    inp = streaming.StreamingInpainter(config, stats, params_t, chunk_frames=5,
                                       lookahead_frames=7, transcript=True, device="cpu")
    outs, transcripts = [], []
    for n in (173, 1536, AL):
        outs.append(streaming.stream_utterance(inp, waves[0], masks[0], videos[0],
                                               samples_per_push=n))
        transcripts.append(list(inp.transcript))
    for other in outs[1:]:
        np.testing.assert_allclose(outs[0], other, atol=1e-5 * np.abs(outs[0]).max(), rtol=0)
    assert transcripts[0] == transcripts[1] == transcripts[2]


def test_phase_fill_matches_reference():
    config, _, params_j, params_t, stats = _setup("a-blstm")
    waves, masks, _, _ = _inputs(config)
    inp_j, inp_t = _pair(config, stats, params_j, params_t, chunk_frames=8,
                         lookahead_frames=4, phase_fill=True)
    want = jstreaming.stream_utterance(inp_j, waves[0], masks[0])
    got = streaming.stream_utterance(inp_t, waves[0], masks[0])
    _close(got, want, TOL["float32"])
    # the fill is active: it changes the hole
    inp_off = streaming.StreamingInpainter(config, stats, params_t, chunk_frames=8,
                                           lookahead_frames=4, device="cpu")
    off = streaming.stream_utterance(inp_off, waves[0], masks[0])
    hole = slice(7 * 192, 12 * 192)
    assert np.abs(got[hole] - off[hole]).max() > 0.2 * np.abs(off).max()


def test_causal_fill_matches_reference_across_chunks():
    """`_causal_fill` against the reference's, whole and in 7-frame chunks
    with the carry threaded through (atol 5e-4 rad: the extrapolated phase
    grows to tens of radians)."""
    rng = np.random.RandomState(3)
    b, t, f = 2, 40, 9
    known = np.ones((b, t), np.float32)
    known[0, 10:22] = 0.0
    known[1, 0:5] = 0.0
    known[1, 30:40] = 0.0
    phase = rng.uniform(-np.pi, np.pi, (b, t, f)).astype(np.float32) * known[:, :, None]
    omega = (2 * np.pi * np.arange(f) * 192 / 512).astype(np.float32)
    carry0 = (np.zeros((b, f), np.float32), np.broadcast_to(omega, (b, f)).copy(),
              np.zeros(b, np.float32))
    want, _ = jstreaming._causal_fill(phase, known, carry0)
    carry = tuple(torch.from_numpy(c) for c in carry0)
    parts = []
    for lo in range(0, t, 7):
        ph, (adv, pk) = streaming._causal_fill(
            torch.from_numpy(phase[:, lo : lo + 7]), torch.from_numpy(known[:, lo : lo + 7]), carry)
        parts.append(ph.numpy())
        carry = (ph[:, -1], adv, pk)
    np.testing.assert_allclose(np.concatenate(parts, axis=1), np.asarray(want), atol=5e-4, rtol=0)


def test_push_after_flush_raises_until_reset():
    config, _, _, params_t, stats = _setup("a-blstm")
    waves, masks, _, _ = _inputs(config)
    inp = streaming.StreamingInpainter(config, stats, params_t, chunk_frames=4,
                                       lookahead_frames=4, device="cpu")
    first = inp.push(waves[0], masks[0])
    out = np.concatenate([first, inp.flush()])
    assert len(out) == T * 192
    assert len(inp.flush()) == 0  # idempotent
    with pytest.raises(RuntimeError):
        inp.push(waves[0], masks[0])
    inp.reset()
    again = np.concatenate([inp.push(waves[0], masks[0]), inp.flush()])
    np.testing.assert_array_equal(again, out)


def test_rejected_push_leaves_stream_intact():
    """Too few mask values, or video rows, raise before any state changes:
    the caller's retry gives the stream an uninterrupted one would."""
    config, _, _, params_t, stats = _setup(FLAGSHIP)
    waves, masks, videos, _ = _inputs(config)
    inp = streaming.StreamingInpainter(config, stats, params_t, chunk_frames=5,
                                       lookahead_frames=7, device="cpu")
    want = streaming.stream_utterance(inp, waves[0], masks[0], videos[0], samples_per_push=AL)
    inp.reset()
    with pytest.raises(ValueError, match="mask values"):
        inp.push(waves[0], masks[0, :3], videos[0])
    with pytest.raises(ValueError, match="video"):
        inp.push(waves[0], masks[0], videos[0, :3])
    got = np.concatenate([inp.push(waves[0], masks[0], videos[0]), inp.flush()])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model", [FLAGSHIP, "av-blstm"])
def test_long_stream_trims_buffers_and_matches_reference(model):
    """Twelve utterances through one unbroken stream: host buffers stay
    bounded, and the output is the reference's throughout."""
    config, _, params_j, params_t, stats = _setup(model)
    waves, masks, videos, _ = _inputs(config)
    inp_j, inp_t = _pair(config, stats, params_j, params_t, chunk_frames=4,
                         lookahead_frames=4)
    got, want = [], []
    for _ in range(12):
        got.append(inp_t.push(waves[0], masks[0], videos[0]))
        want.append(inp_j.push(waves[0], masks[0], videos[0]))
    cap = 16 * inp_t.window + 2 * T
    assert len(inp_t._mask_buf) < cap and len(inp_t._frames["spec_norm"]) < cap
    got.append(inp_t.flush())
    want.append(inp_j.flush())
    _close(np.concatenate(got), np.concatenate(want), TOL["float32"])


def test_window_and_model_checks():
    config, _, _, params_t, stats = _setup("a-blstm", lc_chunk=4, lc_lookahead=6)
    inp = streaming.StreamingInpainter(config, stats, params_t, device="cpu")
    assert (inp.chunk, inp.look, inp.window) == (4, 6, 10)  # the trained window
    config, _, _, params_t, stats = _setup("a-blstm")
    assert streaming.resolve_window(config, None, None) == (8, 16)
    with pytest.raises(ValueError):
        streaming.resolve_window(config, 0, 4)
    with pytest.raises(ValueError):  # no CTC head
        streaming.StreamingInpainter(config, stats, params_t, transcript=True, device="cpu")
    config, _, _, params_t, stats = _setup("av-blstm-emb")
    with pytest.raises(ValueError):  # needs a speaker embedding
        streaming.StreamingInpainter(config, stats, params_t, device="cpu")


# ----------------------------------------------------------- lockstep fleet

def _lockstep_pair(config, stats, params_j, params_t, waves, masks, videos=None,
                   jax_impl="scan", **kw):
    want = jstreaming.stream_utterances_lockstep(config, stats, params_j, waves, masks, videos,
                                                 lstm_impl=jax_impl, **kw)
    got = streaming.stream_utterances_lockstep(config, stats, params_t, waves, masks, videos,
                                               device="cpu", **kw)
    return got, want


def test_lockstep_matches_pallas_reference_with_transcripts():
    """B=2 streams with distinct gaps, C=5/L=7, transcripts; the reference
    runs its Pallas LC window kernel (interpret mode)."""
    config, _, params_j, params_t, stats = _setup(FLAGSHIP)
    waves, masks, videos, _ = _inputs(config, batch_size=2, seed=13, gap=(4, 11))
    masks[1, 4:11] = 1.0
    masks[1, 15:22] = 0.0
    (wav, tr), (wav_j, tr_j) = _lockstep_pair(
        config, stats, params_j, params_t, waves, masks, videos, jax_impl="pallas",
        chunk_frames=5, lookahead_frames=7, transcript=True)
    assert wav.shape == (2, T * 192)
    _close(wav, wav_j, TOL["float32"])
    assert tr == tr_j


def test_lockstep_b1_equals_single_stream():
    config, _, _, params_t, stats = _setup(FLAGSHIP)
    waves, masks, videos, _ = _inputs(config, seed=9, gap=(4, 11))
    wav, tr = streaming.stream_utterances_lockstep(
        config, stats, params_t, waves, masks, videos, chunk_frames=5, lookahead_frames=7,
        transcript=True, device="cpu")
    inp = streaming.StreamingInpainter(config, stats, params_t, chunk_frames=5,
                                       lookahead_frames=7, transcript=True, device="cpu")
    single = streaming.stream_utterance(inp, waves[0], masks[0], videos[0])
    _close(wav[0], single, 1e-4)
    assert tr[0] == inp.transcript


def test_lockstep_empty_stream():
    config, _, _, params_t, stats = _setup(FLAGSHIP)
    args = (np.zeros((2, 0), np.float32), np.zeros((2, 0), np.float32),
            np.zeros((2, 0, 136), np.float32))
    out = streaming.stream_utterances_lockstep(config, stats, params_t, *args,
                                               chunk_frames=5, lookahead_frames=7, device="cpu")
    assert out.shape == (2, 0)
    wav, tr = streaming.stream_utterances_lockstep(
        config, stats, params_t, *args, chunk_frames=5, lookahead_frames=7, transcript=True,
        device="cpu")
    assert wav.shape == (2, 0) and tr == [[], []]


def test_lockstep_final_full_window_with_pad_frame():
    """T=25 from 4,800 samples has one pad_end frame; at C=5/L=5 the t0=15
    window is full but needs it, so it runs as the final window (fold
    timing, t_end clamp), in the fleet as in the single stream."""
    config, _, params_j, params_t, stats = _setup(FLAGSHIP)
    waves, masks, videos, _ = _inputs(config, batch_size=2, seed=11, gap=(14, 23))
    got, want = _lockstep_pair(config, stats, params_j, params_t, waves, masks, videos,
                               chunk_frames=5, lookahead_frames=5)
    _close(got, want, TOL["float32"])
    inp = streaming.StreamingInpainter(config, stats, params_t, chunk_frames=5,
                                       lookahead_frames=5, device="cpu")
    for i in range(2):
        _close(got[i], streaming.stream_utterance(inp, waves[i], masks[i], videos[i]), 1e-4)


@pytest.mark.parametrize("look", [0, 1])
def test_lockstep_ssnn_low_lookahead_burst(look):
    """Lookahead below the delta lag: at the final transition chunk + 2
    frames become final in one window, more than W, and the fleet's fold
    rows (and the stream's standalone fold) must take them all."""
    config, _, params_j, params_t, stats = _setup("a-blstm-ssnn")
    waves, masks, _, _ = _inputs(config, batch_size=2, seed=17, gap=(16, 24))
    masks[1, 18:25] = 0.0
    got, want = _lockstep_pair(config, stats, params_j, params_t, waves, masks,
                               chunk_frames=5, lookahead_frames=look)
    _close(got, want, TOL["float32"])
    inp_j, inp_t = _pair(config, stats, params_j, params_t, chunk_frames=5,
                         lookahead_frames=look)
    for i in range(2):
        single = streaming.stream_utterance(inp_t, waves[i], masks[i])
        _close(single, jstreaming.stream_utterance(inp_j, waves[i], masks[i]), TOL["float32"])
        _close(got[i], single, 1e-4)


def test_lockstep_validation():
    config, _, _, params_t, stats = _setup("av-blstm-emb")
    waves, masks, videos, embs = _inputs(config)
    with pytest.raises(ValueError):  # masks of the wrong length
        streaming.stream_utterances_lockstep(config, stats, params_t, waves, masks[:, :5], videos,
                                             embeddings=embs, device="cpu")
    with pytest.raises(ValueError):  # no embeddings
        streaming.stream_utterances_lockstep(config, stats, params_t, waves, masks, videos,
                                             device="cpu")
    out = streaming.stream_utterances_lockstep(config, stats, params_t, waves, masks, videos,
                                               embeddings=embs, chunk_frames=6,
                                               lookahead_frames=6, device="cpu")
    assert out.shape == (1, T * 192) and np.isfinite(out).all()


# ----------------------------------------------------------- policy

def test_resolve_stream_impl():
    f32, bf16 = torch.float32, torch.bfloat16
    model = ([250, 250, 250], f32)  # the layer widths and compute dtype
    assert streaming.resolve_stream_impl("auto", "cpu", f32, *model) == "plain"
    assert streaming.resolve_stream_impl(None, "cuda", f32, *model) == "kernel"
    # bf16 gates: the scan, whose gates round as the trained function's do
    assert streaming.resolve_stream_impl("auto", "cuda", bf16, *model) == "scan"
    assert streaming.resolve_stream_impl("auto", "cpu", bf16, *model) == "scan"
    assert streaming.resolve_stream_impl("scan", "cuda", f32, *model) == "scan"
    assert streaming.resolve_stream_impl("kernel", "cuda", bf16, *model) == "kernel"
    with pytest.raises(ValueError):
        streaming.resolve_stream_impl("kernel", "cpu", f32, *model)
    with pytest.raises(ValueError):
        streaming.resolve_stream_impl("plain", "cuda", f32, *model)
    with pytest.raises(ValueError):
        streaming.resolve_stream_impl("pallas", "cpu", f32, *model)


def test_unported_options_and_device_default(monkeypatch):
    """passthrough and gap_atten now work (their outputs differ from the
    plain stream's); a fleet mesh without a `data` axis is refused (fleets
    over a mesh are held against the reference in
    tests/test_torch_parallel.py); no device means the GPU."""
    config, _, _, params_t, stats = _setup("a-blstm")
    waves, masks, _, _ = _inputs(config)
    plain = streaming.stream_utterance(
        streaming.StreamingInpainter(config, stats, params_t, device="cpu"), waves[0], masks[0])
    for kw in ({"passthrough": True}, {"gap_atten": {"alpha": 0.5, "trust": 0, "ramp": 1}}):
        inp = streaming.StreamingInpainter(config, stats, params_t, device="cpu", **kw)
        got = streaming.stream_utterance(inp, waves[0], masks[0])
        assert got.shape == plain.shape and np.isfinite(got).all()
        assert np.abs(got - plain).max() > 1e-3 * np.abs(plain).max(), kw
    with pytest.raises(ValueError, match="mesh must carry a 'data' axis"):
        streaming.stream_utterances_lockstep(config, stats, params_t, waves, masks,
                                             mesh=object(), device="cpu")
    # alpha >= 1 is the reference's "off"
    streaming.StreamingInpainter(config, stats, params_t, gap_atten={"alpha": 1.0}, device="cpu")
    # no device means the GPU, and without one the entry points raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        streaming.StreamingInpainter(config, stats, params_t)
    with pytest.raises(RuntimeError, match="GPU"):
        streaming.stream_utterances_lockstep(config, stats, params_t, waves, masks)


# ----------------------------------------------------------- deployment levers

LEVERS = {"passthrough": True, "gap_atten": {"alpha": 0.3, "trust": 2, "ramp": 3}}


def _lever_inputs(config, batch_size=1):
    """A gap deep enough to attenuate (frames 6-17), and for a second
    stream one that runs to the end of the utterance (the flush fill and
    pad frames must count as unknown there)."""
    waves, masks, videos, embs = _inputs(config, batch_size=batch_size, seed=21, gap=(6, 18))
    if batch_size > 1:
        masks[1] = 1.0
        masks[1, 14:] = 0.0
    return waves, masks, videos, embs


@pytest.mark.parametrize("chunk,look", [(5, 7), (4, 0), (8, 1)])
@pytest.mark.parametrize("levers", ["passthrough", "gap_atten", "both"])
def test_levers_match_reference(chunk, look, levers):
    """The single stream with passthrough, gap attenuation or both against
    the reference's, at lookaheads 7, 0 and 1 (tolerance TOL f32)."""
    kw = LEVERS if levers == "both" else {levers: LEVERS[levers]}
    config, _, params_j, params_t, stats = _setup(FLAGSHIP)
    waves, masks, videos, _ = _lever_inputs(config, batch_size=2)
    for i in range(2):
        inp_j, inp_t = _pair(config, stats, params_j, params_t, chunk_frames=chunk,
                             lookahead_frames=look, **kw)
        want = jstreaming.stream_utterance(inp_j, waves[i], masks[i], videos[i])
        got = streaming.stream_utterance(inp_t, waves[i], masks[i], videos[i])
        _close(got, want, TOL["float32"])


@pytest.mark.parametrize("look", [7, 0])
def test_levers_push_size_invariance(look):
    """With both levers the output does not depend on how samples arrive
    (push sizes coarser than one hop, as the passthrough's exactness needs
    at lookahead 0)."""
    config, _, _, params_t, stats = _setup(FLAGSHIP)
    waves, masks, videos, _ = _lever_inputs(config)
    inp = streaming.StreamingInpainter(config, stats, params_t, chunk_frames=5,
                                       lookahead_frames=look, device="cpu", **LEVERS)
    outs = [streaming.stream_utterance(inp, waves[0], masks[0], videos[0], samples_per_push=n)
            for n in (397, 1536, AL)]
    for other in outs[1:]:
        np.testing.assert_allclose(outs[0], other, atol=1e-5 * np.abs(outs[0]).max(), rtol=0)


def test_lockstep_levers_match_reference_and_single_stream():
    """The fleet with both levers against the reference's fleet (TOL f32),
    and each stream against its own single stream (1e-4)."""
    config, _, params_j, params_t, stats = _setup(FLAGSHIP)
    waves, masks, videos, _ = _lever_inputs(config, batch_size=2)
    got, want = _lockstep_pair(config, stats, params_j, params_t, waves, masks, videos,
                               chunk_frames=5, lookahead_frames=7, **LEVERS)
    _close(got, want, TOL["float32"])
    inp = streaming.StreamingInpainter(config, stats, params_t, chunk_frames=5,
                                       lookahead_frames=7, device="cpu", **LEVERS)
    for i in range(2):
        _close(got[i], streaming.stream_utterance(inp, waves[i], masks[i], videos[i]), 1e-4)


def test_whole_window_gap_atten_is_the_offline_postfilter():
    """At a whole-utterance window (C=T, L=0) the causal attenuation is the
    offline postfilter: the stream equals the port's offline
    phase_recon="none" step with the same gap_atten (int16 relative L2
    <= 1e-3), and differs from the stream without it."""
    config, _, _, params_t, stats = _setup(FLAGSHIP)
    waves, masks, videos, _ = _lever_inputs(config)
    videos = videos.astype(np.float16)
    atten = LEVERS["gap_atten"]
    inp = streaming.StreamingInpainter(config, stats, params_t, chunk_frames=T, lookahead_frames=0,
                                       gap_atten=atten, device="cpu")
    got = np.clip(streaming.stream_utterance(inp, waves[0], masks[0], videos[0]), -32768, 32767)
    step = tinpaint.make_infer_step(tregistry.get_model(FLAGSHIP), config, stats, False, "none", 0,
                                    gap_atten=atten, device="cpu")
    batch = {
        "sequence_lengths": np.array([T], np.int32), "labels_lengths": np.ones(1, np.int32),
        "target_sources": waves.astype(np.int16), "labels": np.zeros((1, 50), np.float32),
        "video_features": videos, "mask_frames": masks.astype(np.int8),
    }
    want = step(params_t, batch)[0][0].numpy().astype(np.float64)
    assert np.linalg.norm(got[:AL].astype(np.int16) - want) <= 1e-3 * np.linalg.norm(want)
    inp_off = streaming.StreamingInpainter(config, stats, params_t, chunk_frames=T,
                                           lookahead_frames=0, device="cpu")
    off = streaming.stream_utterance(inp_off, waves[0], masks[0], videos[0])
    deep = slice(10 * 192, 14 * 192)  # frames 5-6 deep in the gap: gain 0.3 or near it
    assert np.abs(got[deep]).max() < 0.6 * np.abs(off[deep]).max()
    known = slice(0, 5 * 192)
    np.testing.assert_array_equal(got[known], np.clip(off[known], -32768, 32767))
