"""Streaming (latency-controlled) speech inpainting: port of
`avsi/infer/streaming.py`.

Audio arrives in C-frame chunks; each chunk is processed over a window of
W = C + L frames (L = lookahead) by an LC-BLSTM: the forward direction
carries its exact state across chunks, the backward direction starts at
zero at the window's last frame.  Algorithmic latency is W * 12 ms (the
defaults C=8, L=16 give 288 ms).  The semantics are the reference's, and
its module docstring states them: with a window covering the whole
utterance the output equals the offline `phase_recon="none"` path; the
SSNN speaker embedding is a causal running masked average of frames whose
delta features are final; phase is the masked (known-region) phase, or the
causal phase-vocoder fill with `phase_fill=True`.

One window is `_window_step`: the SSNN running fold, the LC-BLSTM layers,
the heads, the magnitude and the overlap-add resynthesis of the C emitted
frames, all on the stream's device.  Per window the host makes one upload
(the window's features in one buffer) and one fetch (the emitted samples,
and the CTC ids with `transcript=True`); the recurrent state (h, c per
layer, the SSNN sums, the previous OLA frame) stays on the device.  On a
GPU each LC-BLSTM layer is the CUDA kernel K5
(`avsi_torch.ops.lstm_window.lc_bilstm_window`), three launches per window
for the flagship.

`StreamingInpainter` serves one live stream, `stream_utterances_lockstep`
a fleet of B streams with one window step per window for all of them (its
front end runs on the device through the matmul-DFT STFT).  Both take
`device=None`, which means `cuda`, and raise without a card.  Both take the
two deployment levers of the offline path: `gap_atten`, the causal twin of
the gap-attenuation postfilter inside the window step, and `passthrough`,
the known-region blend of the raw pushed samples on the host.  A fleet
can be split over a data mesh (`stream_utterances_lockstep(mesh=...)`):
each shard's streams run on its device, window by window in lockstep.  The
reference's `program_cache` has no meaning without tracing, and is dropped.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from avsi_torch.device import resolve_device
from avsi_torch.models import blstm as blstm_lib
from avsi_torch.models import core
from avsi_torch.ops import lstm_fused, lstm_window
from avsi_torch.ops import passthrough as passthrough_ops
from avsi_torch.ops import postfilter
from avsi_torch.ops import stft as stft_ops
from avsi_torch.ops.lstm_train import project
from avsi_torch.ops.phase import _princarg

FRAME_LENGTH = blstm_lib.FRAME_LENGTH  # 384
FRAME_STEP = blstm_lib.FRAME_STEP  # 192
FFT_LENGTH = blstm_lib.FFT_LENGTH  # 512
_DELTA_N = 2  # delta(N=2): a frame's delta needs frames t-2 .. t+2
_EXT_CTX = 4  # left-context frames in a raw window (the fold's delta +-2)
_WINDOW_FN = stft_ops.hann_window(FRAME_LENGTH).astype(np.float32)


def _cut_frames(buf: np.ndarray, n: int) -> np.ndarray:
    """First n hop-aligned analysis frames of a sample buffer."""
    return np.stack(
        [buf[i * FRAME_STEP : i * FRAME_STEP + FRAME_LENGTH] for i in range(n)]
    )


def _lc_bilstm_layer(params, x, carry_h, carry_c, emit, compute_dtype, gate_dtype=None):
    """The scan twin of one LC-BLSTM layer over a (B, W, D) window
    (`streaming.py:92-131`): the reference's per-step cell
    (`core._lstm_cell`), gates rounded to `gate_dtype`.  Same contract as
    `lstm_window.lc_bilstm_window`."""
    cd = compute_dtype
    gate_dtype = gate_dtype or cd
    wh32 = params["wh"].to(cd).float()
    xw = project(x, params["wx"].to(cd), params["b"], cd)
    zero = torch.zeros_like(carry_h)
    h = torch.stack([carry_h, zero]).float()
    c = torch.stack([carry_c, zero]).float()
    hs, cs = [], []
    for t in range(xw.shape[0]):
        h, c = core._lstm_cell(h, c, xw[t], wh32, cd, gate_dtype)
        hs.append(h)
        cs.append(c)
    hs = torch.stack(hs)  # (W, 2, B, H)
    fwd = hs[:, 0].transpose(0, 1)
    bwd = hs[:, 1].transpose(0, 1).flip(1)
    out = torch.cat([fwd, bwd], dim=-1).to(x.dtype)
    return out, hs[emit - 1, 0], cs[emit - 1][0]


def _layer_list(params: dict, spec, int_layer: int):
    """Flatten the (blstm | blstm1+blstm2) param layout into
    (layer_params, inject_embedding_before) pairs, mirroring `blstm.forward`'s
    integration_layer handling."""
    if "blstm" in params:
        inject_first = spec.conditioning is not None and int_layer == 0
        return [(p, inject_first and i == 0) for i, p in enumerate(params["blstm"])]
    out = [(p, False) for p in params["blstm1"]]
    out += [(p, i == 0) for i, p in enumerate(params["blstm2"])]
    return out


def _ssnn_update(params, deltas, mask, n_valid, ssnn_sum, ssnn_cnt):
    """Fold <= W finalized frames into the masked running sums (the +1 mean
    denominator is applied at read).  n_valid: how many leading rows count.
    Called inside the window step, and alone for a burst of more than W
    frames (the reference's standalone `_SSNN_STEP`)."""
    h = F.leaky_relu(core.dense(params["ssnn"][0], deltas), 0.3)
    h = F.leaky_relu(core.dense(params["ssnn"][1], h), 0.3)
    h = core.dense(params["ssnn"][2], h)  # (B, W, 200)
    pos = torch.arange(h.shape[1], dtype=torch.float32, device=h.device)[None, :]
    fm = mask * (pos < n_valid).float()
    return ssnn_sum + (h * fm[:, :, None]).sum(dim=1), ssnn_cnt + fm.sum(dim=1)


def resolve_window(config: dict, chunk_frames, lookahead_frames) -> tuple[int, int]:
    """(chunk, lookahead): None takes the model's TRAINED window when the
    config carries lc_chunk/lc_lookahead, else the 288 ms C=8/L=16."""
    lc_c = int(config.get("lc_chunk", 0) or 0)
    if chunk_frames is None:
        chunk_frames = lc_c if lc_c > 0 else 8
    if lookahead_frames is None:
        lookahead_frames = int(config.get("lc_lookahead", 0) or 0) if lc_c > 0 else 16
    chunk, look = int(chunk_frames), int(lookahead_frames)
    if chunk < 1:
        raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
    if look < 0:
        raise ValueError(f"lookahead_frames must be >= 0, got {lookahead_frames}")
    return chunk, look


def _check_mesh(mesh) -> None:
    if mesh is not None and not getattr(mesh, "shape", {}).get("data", 0):
        raise ValueError("mesh must carry a 'data' axis")


def resolve_stream_impl(requested: str | None, device, gate_dtype, widths,
                        compute_dtype, mesh=None) -> str:
    """Streaming's `lstm_impl` policy -> "kernel", "plain" or "scan".

    mesh: a fleet's mesh, which must carry a `data` axis (ValueError).  The
    reference keeps the scan under a model axis because its kernel needs
    whole params; here every data shard holds whole params, so the policy
    below holds on any mesh and K5 runs once per shard per layer.

    "auto" runs the LC window kernel K5 on a CUDA device and its plain
    version on the CPU, but the scan under bf16 gates: the kernel evaluates
    gates in f32 and the scan-trained function rounds them to bf16, and
    "auto" keeps the trained function (the reference's train == serve
    rule).  Otherwise `lstm_fused.resolve_impl` decides, given the model's
    layer `widths` and `compute_dtype`: on a CUDA device "auto" and
    "kernel" raise for a width without a launch plan.  "kernel" off CUDA,
    and "plain" on CUDA, are refused.  gate_dtype: the effective gate
    dtype."""
    _check_mesh(mesh)
    req = (requested or "auto").lower()
    if req == "auto" and gate_dtype == torch.bfloat16:
        return "scan"
    return lstm_fused.resolve_impl(req, device, widths, compute_dtype)


def ctc_blank_id(params) -> int:
    """Blank label = last output of the ASR head."""
    return int(params["head_asr"]["b"].shape[0]) - 1


def greedy_collapse(ids, blank: int, prev: int, out: list) -> int:
    """Incremental greedy CTC collapse: append each non-blank, non-repeat
    label in `ids` to `out`; return the new collapse state (the last raw
    label), so chained calls decode as one offline pass."""
    for label in ids:
        label = int(label)
        if label != blank and label != prev:
            out.append(label)
        prev = label
    return prev


def _norm_gap_atten(gap_atten) -> tuple | None:
    """A gap-attenuation request -> (alpha, trust, ramp), or None for off
    (also alpha >= 1, the reference's "disabled")."""
    if not gap_atten:
        return None
    alpha = float(gap_atten["alpha"])
    if alpha >= 1.0:
        return None
    if not 0.0 <= alpha:
        raise ValueError(f"gap_atten alpha must be in [0, 1), got {alpha}")
    return alpha, int(gap_atten.get("trust", 34)), int(gap_atten.get("ramp", 16))


class _ProgSpec:
    """The static inputs of the window step."""

    __slots__ = ("spec", "int_layer", "chunk", "compute_dtype", "gate_dtype",
                 "stats", "transcript", "phase_fill", "lstm_impl", "gap_atten")

    def __init__(self, spec, int_layer, chunk, compute_dtype, gate_dtype, stats,
                 transcript, phase_fill, lstm_impl, gap_atten):
        self.spec = spec
        self.int_layer = int_layer
        self.chunk = chunk
        self.compute_dtype = compute_dtype
        self.gate_dtype = gate_dtype or compute_dtype  # None follows compute
        self.stats = stats  # (mean, std) on the device
        self.transcript = transcript  # also emit CTC argmax ids per chunk
        self.phase_fill = phase_fill  # causal hole-phase extrapolation
        self.lstm_impl = lstm_impl  # "kernel" | "plain" (K5) | "scan"
        # None or (alpha, trust, ramp): causal deep-gap attenuation; the
        # window then carries "gap_ld" (B,) and "gap_valid"
        self.gap_atten = gap_atten


def _prog(config, stats, chunk, transcript, phase_fill, lstm_impl, device,
          gap_atten=None, mesh=None) -> _ProgSpec:
    spec = blstm_lib.parse_model_name(config["model"])
    if transcript and not spec.ctc:
        raise ValueError(
            f"model {config['model']} has no CTC head; transcripts need a -ctc variant")
    cdt, gdt = blstm_lib.dtypes(config)
    return _ProgSpec(
        spec=spec,
        int_layer=int(config.get("integration_layer", 0)) if spec.conditioning else 0,
        chunk=chunk, compute_dtype=cdt, gate_dtype=gdt,
        stats=tuple(torch.as_tensor(np.asarray(s, np.float32)).to(device) for s in stats),
        transcript=bool(transcript), phase_fill=bool(phase_fill),
        lstm_impl=resolve_stream_impl(lstm_impl, device, gdt or cdt, config["net_dim"], cdt,
                                      mesh),
        gap_atten=gap_atten,
    )


def _omega(af: int, device) -> torch.Tensor:
    """Each bin's nominal phase advance per hop."""
    return 2 * math.pi * torch.arange(af, dtype=torch.float32, device=device) * FRAME_STEP / FFT_LENGTH


def _causal_fill(phase, known, carry):
    """Causal hole-phase extrapolation over one chunk of frames (the forward
    half of `ops.phase.extrapolate_phase`, carry exposed).

    phase: (B, C, F) masked phase; known: (B, C) 1 = frame intact; carry:
    (last output phase (B, F), per-bin advance (B, F), last knownness (B,)).
    Returns the filled (B, C, F) phase and the new (advance, knownness)."""
    omega = _omega(phase.shape[-1], phase.device)
    ph_prev, adv, pk = carry
    out = []
    for t in range(phase.shape[1]):
        ph_t, k_t = phase[:, t], known[:, t]
        adv = torch.where((k_t * pk)[:, None] > 0, omega + _princarg(ph_t - ph_prev - omega), adv)
        ph_prev = torch.where(k_t[:, None] > 0, ph_t, ph_prev + adv)
        pk = k_t
        out.append(ph_prev)
    return torch.stack(out, dim=1), (adv, pk)


def _window_step(prog, params, window, carries, prev, ssnn_sum, ssnn_cnt):
    """One LC window -> (emitted samples, chunk mag, chunk phase, new
    carries, new prev, ssnn_sum, ssnn_cnt, CTC ids), all on the device.

    window: spec_norm/re/im (B, W, af), mask (B, W), video (B, W, vf) for
    visual models, embedding (B, E) for -emb models, for ssnn models the
    fold inputs ssnn_feats (B, W', 2*af), ssnn_mask (B, W') and ssnn_n (a
    number: how many leading fold rows count), and with gap attenuation
    gap_ld (B,), each stream's distance since its last known frame before
    the window, and gap_valid (a number: the rows that are stream frames)."""
    spec = prog.spec
    mask_bins = window["mask"][:, :, None]  # broadcast over the bins
    spec_norm = window["spec_norm"]
    audio_feat = spec_norm * mask_bins

    emb = None
    if spec.conditioning == "ssnn":
        ssnn_sum, ssnn_cnt = _ssnn_update(
            params, window["ssnn_feats"], window["ssnn_mask"], window["ssnn_n"],
            ssnn_sum, ssnn_cnt)
        emb = ssnn_sum / (ssnn_cnt + 1.0)[:, None]
    elif spec.conditioning == "emb":
        emb = window["embedding"]

    if spec.input_type == "a":
        x = audio_feat
    elif spec.input_type == "v":
        x = window["video"]
    else:
        x = torch.cat([audio_feat, window["video"]], dim=2)

    new_carries = []
    for (layer_params, inject), (ch, cc) in zip(_layer_list(params, spec, prog.int_layer), carries):
        if inject and emb is not None:
            x = torch.cat([x, emb[:, None, :].expand(x.shape[0], x.shape[1], emb.shape[-1])], dim=2)
        if prog.lstm_impl == "scan":
            x, nh, nc = _lc_bilstm_layer(layer_params, x, ch, cc, prog.chunk,
                                         prog.compute_dtype, prog.gate_dtype)
        else:
            x, nh, nc = lstm_window.lc_bilstm_window(layer_params, x, ch, cc, prog.chunk,
                                                     prog.compute_dtype)
        new_carries.append((nh, nc))

    x_emit = x[:, : prog.chunk]
    if prog.transcript:  # CTC argmax over the emitted chunk frames
        ids = torch.argmax(core.dense(params["head_asr"], x_emit).float(), dim=-1)
    else:
        ids = torch.zeros((x.shape[0], 0), dtype=torch.int64, device=x.device)

    # only the emitted chunk is consumed downstream
    sn_emit = spec_norm[:, : prog.chunk]
    m_emit = mask_bins[:, : prog.chunk]
    inference = core.dense(params["head_ipt"], x_emit).float()
    prediction = sn_emit * m_emit + inference * (1 - m_emit) if spec.restore_unmasked else inference
    mean, std = prog.stats
    if prog.gap_atten is not None:
        # the causal twin of `postfilter.apply_gap_attenuation`: the left
        # distance is carried by the host, the right edge seen within the
        # lookahead.  Rows past gap_valid (flush fill rows, lockstep pad
        # frames) count as unknown, as the offline edge convention has it:
        # their known fill would otherwise end an end-of-utterance gap early
        alpha, trust, ramp = prog.gap_atten
        mask = window["mask"]
        valid = torch.arange(mask.shape[1], device=mask.device) < window["gap_valid"]
        gain = postfilter.causal_window_gain(mask * valid[None, :], window["gap_ld"], alpha,
                                             trust, ramp)[:, : prog.chunk]
        log_gain = torch.log(torch.clamp(gain, min=1e-6))[:, :, None]
        prediction = prediction + log_gain / std[: prediction.shape[-1]] * (1 - m_emit)
    mag = torch.exp(prediction * std + mean)  # (B, C, af)
    re = window["re"][:, : prog.chunk]
    im = window["im"][:, : prog.chunk]
    phase = torch.atan2(im * m_emit, re * m_emit)  # masked phase: 0 in the hole

    # OLA of [prev frame, chunk frames]: return only the samples the chunk
    # finalizes.  prev also carries the causal phase-fill state.
    prev_mag, prev_phase, ph_adv, prev_known = prev  # (B, af) x 3 + (B,)
    if prog.phase_fill:
        phase, (ph_adv, prev_known) = _causal_fill(
            phase, window["mask"][:, : prog.chunk], (prev_phase, ph_adv, prev_known))
    wav = stft_ops.waveform_from_mag_phase(
        torch.cat([prev_mag[:, None], mag], dim=1),
        torch.cat([prev_phase[:, None], phase], dim=1),
        num_samples=prog.chunk * FRAME_STEP + FRAME_LENGTH,
        frame_length=FRAME_LENGTH, frame_step=FRAME_STEP, fft_length=FFT_LENGTH,
    )[:, FRAME_STEP : FRAME_STEP + prog.chunk * FRAME_STEP]
    new_prev = (mag[:, -1], phase[:, -1], ph_adv, prev_known)
    return wav, mag, phase, new_carries, new_prev, ssnn_sum, ssnn_cnt, ids


def _window_step_raw(prog, params, raw, carries, prev, ssnn_sum, ssnn_cnt):
    """Raw-sample window step of the lockstep fleet: the STFT -> log ->
    normalize front end (and, for ssnn, the fold's delta features) run on
    the device from raw samples.

    raw: samples (B, (EXT+W-1)*192+384) covering frames [t0-EXT, t0+W),
    mask_ext (B, EXT+W), video (B, W, vf), optional embedding (B, E), and
    host numbers (window-relative frame indices): t_valid (rows from it on
    are past the stream and zeroed, the class's zero-feature padding) and,
    for ssnn, fold_lo, fold_n, clamp_lo, clamp_hi; with gap attenuation
    gap_ld (B,) and gap_valid, passed on to `_window_step`."""
    mean, std = prog.stats
    n_ext = raw["mask_ext"].shape[1]
    w_len = n_ext - _EXT_CTX
    dev = raw["mask_ext"].device
    logmag, re, im = stft_ops.log_magnitude_spectrogram(
        raw["samples"], FRAME_LENGTH, FRAME_STEP, FFT_LENGTH)
    af = mean.shape[-1]
    valid = (torch.arange(n_ext, device=dev) < raw["t_valid"])[None, :, None]
    zero = torch.zeros((), device=dev)
    re = torch.where(valid, re[:, :n_ext, :af], zero)
    im = torch.where(valid, im[:, :n_ext, :af], zero)
    sn_ext = torch.where(valid, (logmag[:, :n_ext, :af] - mean) / std, zero)
    window = {
        "spec_norm": sn_ext[:, _EXT_CTX:],
        "re": re[:, _EXT_CTX:],
        "im": im[:, _EXT_CTX:],
        "mask": raw["mask_ext"][:, _EXT_CTX:],
        "video": raw["video"],
    }
    if "embedding" in raw:
        window["embedding"] = raw["embedding"]
    if "gap_ld" in raw:
        window["gap_ld"], window["gap_valid"] = raw["gap_ld"], raw["gap_valid"]
    if prog.spec.conditioning == "ssnn":
        masked_ext = sn_ext * raw["mask_ext"][:, :, None]
        # w_len + _DELTA_N fold rows: at the non-final -> final transition
        # chunk + _DELTA_N new frames become final in one window, more than
        # w_len when lookahead < _DELTA_N; rows past fold_n are masked out
        pos = raw["fold_lo"] + torch.arange(w_len + _DELTA_N, device=dev)

        def rows(arr, idx):
            return arr[:, torch.clamp(idx, raw["clamp_lo"], raw["clamp_hi"]).clamp(0, n_ext - 1)]

        denom = 2.0 * sum(i * i for i in range(1, _DELTA_N + 1))
        d = torch.zeros_like(rows(masked_ext, pos))
        for i in range(1, _DELTA_N + 1):
            d = d + i * (rows(masked_ext, pos + i) - rows(masked_ext, pos - i))
        window["ssnn_feats"] = torch.cat([rows(masked_ext, pos), d / denom], dim=2)
        window["ssnn_mask"] = rows(raw["mask_ext"], pos)
        window["ssnn_n"] = raw["fold_n"]
    return _window_step(prog, params, window, carries, prev, ssnn_sum, ssnn_cnt)


def _clamped_deltas(masked: np.ndarray, lo: int, hi: int, t_end: int | None):
    """Regression deltas for frames [lo, hi) of `masked` (rows = frames),
    the index clamped at 0 and, once the end is known (t_end), at t_end - 1:
    the reference's iterative SYMMETRIC pad."""
    denom = 2.0 * sum(i * i for i in range(1, _DELTA_N + 1))
    top = (t_end if t_end is not None else masked.shape[0]) - 1
    idx = np.arange(lo, hi)
    out = np.zeros((hi - lo, masked.shape[1]), np.float32)
    for i in range(1, _DELTA_N + 1):
        out += i * (masked[np.clip(idx + i, 0, top)] - masked[np.clip(idx - i, 0, top)])
    return out / denom


def _upload(arrays: dict, device) -> dict:
    """Host arrays -> float32 tensors on `device` through ONE host-to-device
    copy (views of one buffer)."""
    flat = np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in arrays.values()])
    buf = torch.from_numpy(flat).to(device)
    out, off = {}, 0
    for key, a in arrays.items():
        out[key] = buf[off : off + a.size].view(a.shape)
        off += a.size
    return out


def _fetch(*tensors) -> list[np.ndarray]:
    """Device tensors with a leading batch axis -> numpy, through ONE
    device-to-host copy (integer tensors come back as int64)."""
    rows = tensors[0].shape[0]
    host = torch.cat([t.reshape(rows, -1).float() for t in tensors], dim=1).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t[0].numel() if rows else 0
        a = host[:, off : off + n].reshape(t.shape)
        out.append(a.astype(np.int64) if not t.is_floating_point() else a)
        off += n
    return out


def _zero_state(hidden: list[int], b_sz: int, af: int, device):
    """Zero LSTM carries, SSNN sums and previous OLA frame for b_sz streams.
    The previous frame's zeros behave like the offline iSTFT's nonexistent
    frame -1; slots 3/4 are the phase-fill carry (nominal advance, unknown)."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    carries = [(z(b_sz, h), z(b_sz, h)) for h in hidden]
    prev = (z(b_sz, af), z(b_sz, af), _omega(af, device).expand(b_sz, af).clone(), z(b_sz))
    return carries, prev, z(b_sz, blstm_lib.SSNN_DIM), z(b_sz)


class StreamingInpainter:
    """One live stream.  Feed waveform (+ per-frame hole masks / video
    features) with `push`, read enhanced int16-scale samples back as they
    become available; `flush` drains the tail.  Every window, the padded
    flush windows included, runs at the fixed W."""

    def __init__(
        self,
        config: dict,
        stats: tuple,
        params: dict,
        chunk_frames: int | None = None,
        lookahead_frames: int | None = None,
        embedding: np.ndarray | None = None,
        transcript: bool = False,
        phase_fill: bool = False,
        passthrough: bool = False,
        lstm_impl: str = "auto",
        gap_atten: dict | None = None,
        device=None,
    ):
        """chunk_frames/lookahead_frames: None takes the model's trained
        window (`resolve_window`).  transcript=True (CTC models) keeps an
        incremental greedy decode in `self.transcript`.  lstm_impl: "auto"
        (K5 on a GPU, its plain version on the CPU; the scan under bf16
        gates), "kernel", "plain" or "scan" (`resolve_stream_impl`).
        params are moved to `device` (default cuda; raises without one).

        passthrough=True keeps the original pushed samples on fully-known
        frames, crossfaded on the known side of each gap boundary: a host
        blend per emitted chunk with one frame of mask context on each
        side, equal to the offline passthrough whenever the next frame's
        mask is in the buffer at emit time (always for lookahead >= 1, and
        at lookahead 0 for any push coarser than one hop).  Otherwise, a gap
        that starts exactly at a chunk boundary gets a hard splice there
        instead of the fade, which the unseen mask would have decided.

        gap_atten {"alpha", "trust", "ramp"} (None, or alpha >= 1: off):
        the causal deep-gap attenuation, the live twin of the offline
        postfilter.  The left gap-edge distance is exact (carried across
        windows); the right edge is seen within the lookahead, past which
        frames stay attenuated where the offline filter would ramp back up.
        Equal to the offline filter at a whole-utterance window."""
        self.device = resolve_device(device)
        self.chunk, self.look = resolve_window(config, chunk_frames, lookahead_frames)
        self.window = self.chunk + self.look
        self.passthrough = bool(passthrough)
        self.gap_atten = _norm_gap_atten(gap_atten)
        self._prog = _prog(config, stats, self.chunk, transcript, phase_fill, lstm_impl,
                           self.device, self.gap_atten)
        self.spec = self._prog.spec
        self.want_transcript = self._prog.transcript
        self.lstm_impl = self._prog.lstm_impl
        self.af = int(config["audio_feat_dim"])
        self.vf = int(config["video_feat_dim"])
        self.params = core.tree_to(params, self.device)
        # host copy for the per-push numpy front end
        self._stats_np = tuple(np.asarray(s, np.float32) for s in stats)
        self._ext_emb = None
        if self.spec.conditioning == "emb":
            if embedding is None:
                raise ValueError("model needs an external speaker embedding")
            self._ext_emb = torch.from_numpy(
                np.array(embedding, np.float32).reshape(1, -1)).to(self.device)
        self._hidden = [p["wh"].shape[1]
                        for p, _ in _layer_list(self.params, self.spec, self._prog.int_layer)]
        self._ctc_blank = ctc_blank_id(self.params) if self.spec.ctc else -1
        self.reset()

    # ------------------------------------------------------------------ state

    def reset(self):
        self._sample_buf = np.zeros((0,), np.float32)
        self._mask_buf = np.zeros((0,), np.float32)
        self._video_buf = np.zeros((0, self.vf), np.float32)
        self._masked_buf = np.zeros((0, self.af), np.float32)  # ssnn inputs
        # per-frame features awaiting a full window (rows retire on emit)
        self._frames = {k: np.zeros((0, self.af), np.float32) for k in ("spec_norm", "re", "im")}
        self._carry, self._prev_dev, self._ssnn_sum, self._ssnn_cnt = _zero_state(
            self._hidden, 1, self.af, self.device)
        self._frames_in = 0  # featurized
        self._frames_out = 0  # emitted
        self._closed = False  # set by flush(); push() then needs reset()
        self._deltas_done = 0  # frames whose ssnn contribution is summed
        self._buf_base = 0  # absolute frame index of mask/video/masked row 0
        self.transcript: list[int] = []  # collapsed CTC label ids so far
        self._ctc_prev = self._ctc_blank  # collapse state across chunks
        # passthrough: raw pushed samples not yet emitted (from absolute
        # sample _orig_base on) and the last emitted frame's known flag
        self._orig = np.zeros((0,), np.float32)
        self._orig_base = 0
        self._pt_prev_known = 1.0
        # gap attenuation: distance since the last known frame after the
        # last emitted frame (frame -1 counts as unknown)
        self._gap_ld = postfilter._BIG

    # ------------------------------------------------------------------- api

    def push(self, wave, frame_masks, video=None):
        """Feed samples plus the per-frame hole masks (1 = intact, 0 = hole)
        for the 12 ms frames those samples complete; `video` adds one
        136-vector per frame for visual models.  Returns whatever enhanced
        samples became ready (np.float32, possibly empty)."""
        if self._closed:
            # the terminal flush window already ran through the state
            raise RuntimeError("stream is flushed; call reset() to reuse")
        wave = np.asarray(wave, np.float32).reshape(-1)
        buf = np.concatenate([self._sample_buf, wave])
        n_frames = max(0, (len(buf) - FRAME_LENGTH) // FRAME_STEP + 1)
        frame_masks = np.asarray(frame_masks, np.float32).reshape(-1)
        if video is not None:
            video = np.asarray(video, np.float32).reshape(-1, self.vf)
        # validate before touching stream state: a rejected push leaves the
        # buffers as they were, so the caller can retry
        total = self._frames_in + n_frames
        supplied = self._buf_base + len(self._mask_buf) + len(frame_masks)
        if total > supplied:
            raise ValueError(f"{total} frames completed but only {supplied} mask values supplied")
        if self.spec.input_type != "a" and total > (
            self._buf_base + len(self._video_buf) + (len(video) if video is not None else 0)
        ):
            raise ValueError("not enough video feature rows supplied")
        self._mask_buf = np.concatenate([self._mask_buf, frame_masks])
        if self.passthrough:
            self._orig = np.concatenate([self._orig, wave])
        if self.spec.input_type != "a" and video is not None:
            self._video_buf = np.concatenate([self._video_buf, video])
        if n_frames:
            self._featurize(_cut_frames(buf, n_frames))
            self._sample_buf = buf[n_frames * FRAME_STEP :]
        else:
            self._sample_buf = buf
        return self._drain(final=False)

    def flush(self):
        """End of stream: pad the tail with zeros like the offline
        pad_end=True STFT, process every buffered frame with zero-padded
        lookahead, return the final samples.  A second flush() returns
        empty; push() after flush() raises until reset()."""
        if self._closed:
            return np.zeros((0,), np.float32)
        n_rem = len(self._sample_buf)
        if n_rem > 0:
            n_frames = -(-n_rem // FRAME_STEP)
            need = (n_frames - 1) * FRAME_STEP + FRAME_LENGTH
            buf = np.concatenate([self._sample_buf, np.zeros(need - n_rem, np.float32)])
            total = self._frames_in + n_frames
            short = total - self._buf_base - len(self._mask_buf)
            if short > 0:  # pad_end frames default to intact
                self._mask_buf = np.concatenate([self._mask_buf, np.ones(short, np.float32)])
            if self.spec.input_type != "a":
                short = total - self._buf_base - len(self._video_buf)
                if short > 0:
                    tail = (self._video_buf[-1:] if len(self._video_buf)
                            else np.zeros((1, self.vf), np.float32))
                    self._video_buf = np.concatenate([self._video_buf, np.repeat(tail, short, axis=0)])
            self._featurize(_cut_frames(buf, n_frames))
            self._sample_buf = np.zeros((0,), np.float32)
        out = self._drain(final=True)
        self._closed = True
        return out

    # ------------------------------------------------------------- internals

    def _featurize(self, frames):
        """Raw 384-sample frames -> (spec_norm, re, im) buffer rows: the
        windowed rDFT + log(|X| + 1e-6) chain of the offline front end."""
        spec = np.fft.rfft(frames * _WINDOW_FN, n=FFT_LENGTH, axis=-1)
        re = spec.real.astype(np.float32)[:, : self.af]
        im = spec.imag.astype(np.float32)[:, : self.af]
        logmag = np.log(np.sqrt(re * re + im * im) + 1e-6)
        mean, std = self._stats_np
        spec_norm = ((logmag - mean) / std).astype(np.float32)
        for key, rows in (("spec_norm", spec_norm), ("re", re), ("im", im)):
            self._frames[key] = np.concatenate([self._frames[key], rows])
        if self.spec.conditioning == "ssnn":
            lo = self._frames_in - self._buf_base
            masks = self._mask_buf[lo : lo + len(frames), None]
            self._masked_buf = np.concatenate([self._masked_buf, spec_norm * masks])
        self._frames_in += len(frames)

    def _fold_chunk(self, lo, hi, t_end):
        """One <= W-frame fold (feats, mask, n_valid) for frames [lo, hi),
        zero-padded to the fixed window shape."""
        base = self._buf_base
        d = _clamped_deltas(self._masked_buf, lo - base, hi - base,
                            None if t_end is None else t_end - base)
        feats = np.concatenate([self._masked_buf[lo - base : hi - base], d], axis=1)
        masks = self._mask_buf[lo - base : hi - base]
        pad = self.window - (hi - lo)
        if pad > 0:
            feats = np.concatenate([feats, np.zeros((pad, feats.shape[1]), np.float32)])
            masks = np.concatenate([masks, np.zeros(pad, np.float32)])
        return feats, masks, float(hi - lo)

    def _advance_ssnn(self, final, visible_end):
        """Fold frames into the running masked average once their delta
        features are final within the visible range (a function of the
        window sequence alone, not of push sizes).  The last fold is
        returned for the window step; a burst of more than W frames folds
        its excess here first."""
        if self.spec.conditioning != "ssnn":
            return None
        upto = visible_end if final else max(0, visible_end - _DELTA_N)
        t_end = self._frames_in if final else None
        lo = self._deltas_done
        if lo >= upto:  # nothing new: a zero-count fold keeps shapes fixed
            return (np.zeros((self.window, 2 * self.af), np.float32),
                    np.zeros(self.window, np.float32), 0.0)
        while upto - lo > self.window:
            hi = lo + self.window
            feats, masks, n_valid = self._fold_chunk(lo, hi, t_end)
            dev = _upload({"feats": feats[None], "masks": masks[None]}, self.device)
            self._ssnn_sum, self._ssnn_cnt = _ssnn_update(
                self.params, dev["feats"], dev["masks"], n_valid,
                self._ssnn_sum, self._ssnn_cnt)
            lo = hi
        self._deltas_done = upto
        return self._fold_chunk(lo, upto, t_end)

    def _drain(self, final):
        out = []
        while True:
            buffered = len(self._frames["spec_norm"])
            if buffered >= self.window:
                fold = self._advance_ssnn(final, self._frames_out + self.window)
                out.append(self._run_window(self.window, fold))
            elif final and buffered > 0:
                fold = self._advance_ssnn(True, self._frames_out + buffered)
                out.append(self._run_window(buffered, fold))
            else:
                break
        if not out:
            return np.zeros((0,), np.float32)
        return np.concatenate(out)

    def _run_window(self, buffered, fold):
        n_emit = min(self.chunk, buffered)
        pad = self.window - buffered
        fr = self._frames
        base = self._frames_out - self._buf_base

        def take(arr, fill=0.0):
            w = arr[:buffered]
            if pad:
                w = np.concatenate([w, np.full((pad,) + arr.shape[1:], fill, np.float32)])
            return w[None]

        host = {
            "spec_norm": take(fr["spec_norm"]),
            "re": take(fr["re"]),
            "im": take(fr["im"]),
            "mask": take(self._mask_buf[base : base + buffered], fill=1.0),
        }
        if self.spec.input_type != "a":
            host["video"] = take(self._video_buf[base : base + buffered])
        if fold is not None:
            host["ssnn_feats"], host["ssnn_mask"] = fold[0][None], fold[1][None]
        if self.gap_atten is not None:  # f32 holds every distance up to _BIG exactly
            host["gap_ld"] = np.full((1,), self._gap_ld, np.float32)
        window = _upload(host, self.device)
        if fold is not None:
            window["ssnn_n"] = fold[2]
        if self._ext_emb is not None:
            window["embedding"] = self._ext_emb
        if self.gap_atten is not None:
            window["gap_valid"] = buffered  # rows past it are flush fill

        prev_before = self._prev_dev
        wav, mag, phase, self._carry, self._prev_dev, self._ssnn_sum, self._ssnn_cnt, ids = (
            _window_step(self._prog, self.params, window, self._carry, self._prev_dev,
                         self._ssnn_sum, self._ssnn_cnt))
        if self.gap_atten is not None:
            # advance the left distance over the emitted frames' masks,
            # which the host holds
            for m in self._mask_buf[base : base + n_emit]:
                self._gap_ld = 0 if m > 0.5 else min(self._gap_ld + 1, postfilter._BIG)
        for k in fr:
            fr[k] = fr[k][n_emit:]
        # one device-to-host fetch per window
        if n_emit == self.chunk:
            # the window step's OLA already produced exactly these samples
            self._frames_out += n_emit
            wav_h, ids_h = _fetch(wav, ids)
            out = wav_h[0]
        else:
            # terminal short flush window: host OLA over the n_emit frames
            # with the pre-step previous frame as left context
            mag_h, phase_h, pm_h, pp_h, ids_h = _fetch(mag, phase, *prev_before[:2], ids)
            out = self._emit(mag_h[0, :n_emit], phase_h[0, :n_emit], (pm_h[0], pp_h[0]))
        if self.want_transcript:
            self._ctc_prev = greedy_collapse(ids_h[0, :n_emit], self._ctc_blank,
                                             self._ctc_prev, self.transcript)
        if self.passthrough:
            out = self._passthrough_blend(out, n_emit)
        self._trim_buffers()
        return out

    def _passthrough_blend(self, out, n_emit):
        """The known-region passthrough of one emitted chunk.  The blend
        weight depends on the masks within one frame, so [previous frame,
        emitted frames, next frame] of mask context gives the
        whole-utterance weight (`passthrough_weight_np`).  A next frame not
        yet pushed counts as known: exact at the end of the stream (pad_end
        frames are intact); mid-stream it cuts the pre-gap ramp of a gap
        that starts at the boundary (see the class docstring)."""
        if n_emit <= 0 or len(out) == 0:
            return out
        f0 = self._frames_out - n_emit  # first emitted frame (absolute)
        lo = f0 - self._buf_base
        m = self._mask_buf[lo : lo + n_emit + 1]  # emitted frames (+ the next, if pushed)
        ctx = np.ones(n_emit + 2, np.float32)
        ctx[0] = self._pt_prev_known
        ctx[1 : 1 + len(m)] = m
        w = passthrough_ops.passthrough_weight_np(
            ctx, FRAME_STEP, (n_emit + 2) * FRAME_STEP)[FRAME_STEP : FRAME_STEP + len(out)]
        s0 = f0 * FRAME_STEP - self._orig_base
        orig = self._orig[s0 : s0 + len(out)]
        if len(orig) < len(out):  # the flush's zero padding past the pushed tail
            orig = np.pad(orig, (0, len(out) - len(orig)))
        self._pt_prev_known = float(m[n_emit - 1])
        cut = s0 + len(out)
        if cut > 0:
            self._orig = self._orig[cut:]
            self._orig_base += cut
        return (orig * (1.0 - w) + out * w).astype(np.float32)

    def _trim_buffers(self):
        """Bound memory on long-lived streams: drop mask/video/masked rows
        no window or delta computation can reference again."""
        if self.spec.conditioning == "ssnn":
            keep_from = min(self._frames_out, max(0, self._deltas_done - _DELTA_N))
        else:
            keep_from = self._frames_out
        cut = keep_from - self._buf_base
        if cut > 4 * self.window:
            self._mask_buf = self._mask_buf[cut:]
            if len(self._video_buf):
                self._video_buf = self._video_buf[cut:]
            if len(self._masked_buf):
                self._masked_buf = self._masked_buf[cut:]
            self._buf_base = keep_from

    def _emit(self, mag, phase, prev):
        """Host OLA over the emitted frames with `prev` (mag, phase) as the
        one-frame left context (numpy, the same windowed-iDFT matrix as
        `ops/stft.py`).  Only the terminal short flush window takes this
        path."""
        c = mag.shape[0]
        frames_mag = np.concatenate([prev[0][None], mag])
        frames_ph = np.concatenate([prev[1][None], phase])
        coeffs = np.concatenate(
            [frames_mag * np.cos(frames_ph), frames_mag * np.sin(frames_ph)], axis=-1
        ).astype(np.float32)
        frames = coeffs @ stft_ops._idft_matrix(FRAME_LENGTH, FFT_LENGTH, FRAME_STEP)
        wav = np.zeros(c * FRAME_STEP + FRAME_LENGTH, np.float32)
        for i in range(c + 1):
            wav[i * FRAME_STEP : i * FRAME_STEP + FRAME_LENGTH] += frames[i]
        self._frames_out += c
        return wav[FRAME_STEP : FRAME_STEP + c * FRAME_STEP]


def stream_utterance(inp: StreamingInpainter, wave: np.ndarray, frame_mask: np.ndarray,
                     video: np.ndarray | None = None, samples_per_push: int = 1536) -> np.ndarray:
    """Stream one utterance through `inp` in `samples_per_push`-sample
    pushes and return the enhanced waveform (ceil(len(wave) / 192) * 192
    samples)."""
    inp.reset()
    out = []
    frames_fed = 0
    for lo in range(0, len(wave), samples_per_push):
        chunk = wave[lo : lo + samples_per_push]
        done = lo + len(chunk)
        n_frames = min(max(0, (done - FRAME_LENGTH) // FRAME_STEP + 1), len(frame_mask))
        vid = video[frames_fed:n_frames] if video is not None else None
        out.append(inp.push(chunk, frame_mask[frames_fed:n_frames], vid))
        frames_fed = n_frames
    if frames_fed < len(frame_mask):  # rows for the pad_end frame(s)
        vid = video[frames_fed:] if video is not None else None
        out.append(inp.push(np.zeros((0,), np.float32), frame_mask[frames_fed:], vid))
    out.append(inp.flush())
    return np.concatenate(out)


def stream_utterances_lockstep(
    config: dict,
    stats: tuple,
    params: dict,
    waves: np.ndarray,
    frame_masks: np.ndarray,
    videos: np.ndarray | None = None,
    embeddings: np.ndarray | None = None,
    chunk_frames: int | None = None,
    lookahead_frames: int | None = None,
    transcript: bool = False,
    mesh=None,
    phase_fill: bool = False,
    passthrough: bool = False,
    lstm_impl: str = "auto",
    gap_atten: dict | None = None,
    device=None,
):
    """Serve B streams in lockstep: one window step per window for all of
    them, the front end (STFT, log, normalization, ssnn delta fold) on the
    device from raw samples.  The window schedule, padding and ssnn fold
    timing are the single-stream class's, so a B=1 call matches it up to
    float rounding (the class featurizes with numpy's FFT on the host).

    waves (B, S) int16-scale float; frame_masks (B, T), T = ceil(S / 192);
    videos (B, T, 136) for visual models; embeddings (B, emb_dim) for
    external-embedding models.  Returns (B, T * 192); with transcript=True
    (CTC models) (wav, transcripts), a list of B collapsed greedy CTC
    label-id lists.  The samples, masks and video are uploaded once; each
    window fetches its emitted samples (and ids), as a live fleet would.

    gap_atten and passthrough: as `StreamingInpainter`'s.  The left
    distances of the gap attenuation come from the whole masks on the host
    and are uploaded with them; the passthrough blends the whole utterances
    at the end, which equals the single stream's per-chunk blend (the
    weight's reach is one frame).

    mesh: a `parallel.mesh.Mesh` with a `data` axis (B must divide it).
    Each data shard's streams, their planes and their state live on its
    device, with the params replicated there; every window runs each
    shard's window step (K5 per shard per layer on a card), then fetches
    each shard's samples, so the shards advance in lockstep.  The streams
    are independent: the result is the unsharded fleet's."""
    _check_mesh(mesh)
    devices = [resolve_device(d) for d in (mesh.data_devices if mesh is not None else [device])]
    chunk, look = resolve_window(config, chunk_frames, lookahead_frames)
    gap_atten = _norm_gap_atten(gap_atten)
    progs = {d: _prog(config, stats, chunk, transcript, phase_fill, lstm_impl, d, gap_atten,
                      mesh) for d in set(devices)}
    spec = progs[devices[0]].spec
    af, vf = int(config["audio_feat_dim"]), int(config["video_feat_dim"])
    window_n = chunk + look
    b_sz, n_samples = waves.shape
    t_frames = -(-n_samples // FRAME_STEP)
    if t_frames == 0:  # empty streams: the class's flush() yields zero samples
        empty = np.zeros((b_sz, 0), np.float32)
        return (empty, [[] for _ in range(b_sz)]) if transcript else empty
    if frame_masks.shape != (b_sz, t_frames):
        raise ValueError(f"frame_masks must be {(b_sz, t_frames)}, got {frame_masks.shape}")
    if spec.conditioning == "emb" and embeddings is None:
        raise ValueError("model needs external speaker embeddings")
    if spec.input_type != "a" and videos is None:
        raise ValueError("model consumes video features")
    if b_sz % len(devices):
        raise ValueError(f"fleet size {b_sz} not divisible by the mesh data axis "
                         f"({len(devices)})")

    # global planes in extended coordinates: EXT zero frames of left
    # context, the stream, then pad_end zeros / intact masks
    n_windows = -(-t_frames // chunk)
    t0_max = (n_windows - 1) * chunk
    ext_frames = _EXT_CTX + window_n
    samp_len = (t0_max + window_n + _EXT_CTX - 1) * FRAME_STEP + FRAME_LENGTH
    samp = np.zeros((b_sz, samp_len), np.float32)
    samp[:, _EXT_CTX * FRAME_STEP : _EXT_CTX * FRAME_STEP + n_samples] = waves
    fm = np.asarray(frame_masks, np.float32)
    mask_glob = np.concatenate(
        [np.zeros((b_sz, _EXT_CTX), np.float32), fm,
         np.ones((b_sz, t0_max + window_n - t_frames), np.float32)], axis=1)
    host = {"samples": samp, "mask": mask_glob}
    if gap_atten is not None:
        # column t: the left distance after frame t - 1, from the true masks
        # (the EXT context and the pad_end frames never feed the depth)
        host["gap_ld"] = np.concatenate(
            [np.full((b_sz, 1), postfilter._BIG, np.float32),
             postfilter.left_distances_np(fm).astype(np.float32)], axis=1)
    if spec.input_type != "a":
        host["video"] = np.zeros((b_sz, t0_max + window_n, vf), np.float32)
        host["video"][:, :t_frames] = videos
    if spec.conditioning == "emb":
        host["embedding"] = np.asarray(embeddings, np.float32)

    # one shard per data device: its rows of every plane, its params and
    # its state, uploaded once
    per = b_sz // len(devices)
    shards = []
    for i, d in enumerate(devices):
        rows = slice(i * per, (i + 1) * per)
        sp = core.tree_to(params, d)
        hidden = [p["wh"].shape[1] for p, _ in _layer_list(sp, spec, progs[d].int_layer)]
        shards.append({"device": d, "params": sp,
                       "glob": _upload({k: v[rows] for k, v in host.items()}, d),
                       "state": _zero_state(hidden, per, af, d)})
    raw_len = (ext_frames - 1) * FRAME_STEP + FRAME_LENGTH
    outs, id_chunks = [], []
    deltas_done = 0
    # frames computable from real samples before the flush: any window that
    # needs the pad_end frame(s) runs as the class's final window, even a
    # full one
    real_frames = max(0, (n_samples - FRAME_LENGTH) // FRAME_STEP + 1)
    for t0 in range(0, t_frames, chunk):
        final = t0 + window_n > real_frames
        numbers = {"t_valid": min(_EXT_CTX + t_frames - t0, ext_frames)}
        if gap_atten is not None:
            numbers["gap_valid"] = min(t_frames - t0, window_n)
        if spec.conditioning == "ssnn":
            visible = min(t0 + window_n, t_frames)
            upto = visible if final else max(0, visible - _DELTA_N)
            numbers["fold_lo"] = _EXT_CTX + deltas_done - t0
            numbers["fold_n"] = float(max(0, upto - deltas_done))
            numbers["clamp_lo"] = max(0, _EXT_CTX - t0)
            numbers["clamp_hi"] = _EXT_CTX + (t_frames - 1 - t0) if final else ext_frames - 1
            deltas_done = upto
        results = []
        for sh in shards:
            glob = sh["glob"]
            raw = {
                "samples": glob["samples"][:, t0 * FRAME_STEP : t0 * FRAME_STEP + raw_len],
                "mask_ext": glob["mask"][:, t0 : t0 + ext_frames],
                "video": glob["video"][:, t0 : t0 + window_n] if "video" in glob else None,
                **numbers,
            }
            if "embedding" in glob:
                raw["embedding"] = glob["embedding"]
            if "gap_ld" in glob:
                raw["gap_ld"] = glob["gap_ld"][:, t0]
            wav, _, _, carries, prev, ssnn_sum, ssnn_cnt, ids = _window_step_raw(
                progs[sh["device"]], sh["params"], raw, *sh["state"])
            sh["state"] = (carries, prev, ssnn_sum, ssnn_cnt)
            results.append((wav, ids))
        fetched = [_fetch(wav, ids) for wav, ids in results]
        outs.append(np.concatenate([w for w, _ in fetched]))
        id_chunks.append(np.concatenate([i for _, i in fetched]))
    wav_out = np.concatenate(outs, axis=1)[:, : t_frames * FRAME_STEP]
    if passthrough:
        num = wav_out.shape[1]
        w = np.stack([passthrough_ops.passthrough_weight_np(fm[i], FRAME_STEP, num)
                      for i in range(b_sz)])
        orig = np.zeros((b_sz, num), np.float32)
        orig[:, : min(num, n_samples)] = waves[:, :num]
        wav_out = (orig * (1.0 - w) + wav_out * w).astype(np.float32)
    if not transcript:
        return wav_out
    all_ids = np.concatenate(id_chunks, axis=1)[:, :t_frames]
    blank = ctc_blank_id(params)
    transcripts = []
    for row in all_ids:
        decoded: list[int] = []
        greedy_collapse(row, blank, blank, decoded)
        transcripts.append(decoded)
    return wav_out, transcripts
