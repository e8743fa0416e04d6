"""Plain reference of the flagship family `av-blstm-ssnn-ctc` (Morrone et
al., arXiv:2010.04556): front end, SSNN speaker embedding, stacked BLSTM,
inpainting and CTC heads, and the losses.

Follows the published model as the JAX package and its port implement it
(`avsi/models/blstm.py`, `avsi/models/core.py`; the arithmetic here is a
frozen copy of the port's plain twins): STFT 384/192/512 with pad_end,
log(|X| + 1e-6), per-bin normalisation, the gap mask on the input, SSNN =
[x, delta(x)] -> 200 -> 200 -> 200 (LeakyReLU 0.3 on the first two) and a
masked mean over frames with +1 in the denominator, concat of audio,
video and the tiled embedding, bidirectional LSTM layers (gates i, f, g, o;
the backward direction on reversed time), linear heads, the known bins
restored.  Loss: L1 over the hole + ctc_loss x CTC (blank last, mean over
the batch).  The recurrence is an eager per-step loop: no kernel, no
fusion.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import dsp
from perfbench.reference.arith import Arith

SSNN = 200


def _spec(m: dict):
    parts = m["model"].split("-")
    return {"input": parts[0], "ssnn": "ssnn" in parts, "ctc": "ctc" in parts}


def layer_inputs(m: dict) -> list[tuple[int, int]]:
    """(input width, hidden width) of each BLSTM layer."""
    sp = _spec(m)
    d = {"a": m["audio_feat_dim"], "v": m["video_feat_dim"],
         "av": m["audio_feat_dim"] + m["video_feat_dim"]}[sp["input"]] + (SSNN if sp["ssnn"] else 0)
    out = []
    for h in m["net_dim"]:
        out.append((d, h))
        d = 2 * h
    return out


def param_shapes(m: dict) -> dict:
    """Flat key (the port's checkpoint layout) -> (shape, init, scale):
    "normal" is N(0, 1) cut at +-2 times scale, "uniform" U(-scale, scale),
    "zeros"."""
    sp = _spec(m)
    af = m["audio_feat_dim"]
    out = {}
    if sp["ssnn"]:
        dims = [2 * af, SSNN, SSNN, SSNN]
        for i in range(3):
            out[f"ssnn/{i}/w"] = ((dims[i], dims[i + 1]), "normal", 1 / math.sqrt(dims[i]))
            out[f"ssnn/{i}/b"] = ((dims[i + 1],), "zeros", 0.0)
    for i, (d, h) in enumerate(layer_inputs(m)):
        out[f"blstm/{i}/wx"] = ((2, d, 4 * h), "uniform", 1 / math.sqrt(h))
        out[f"blstm/{i}/wh"] = ((2, h, 4 * h), "uniform", 1 / math.sqrt(h))
        out[f"blstm/{i}/b"] = ((2, 4 * h), "zeros", 0.0)
    head = 2 * m["net_dim"][-1]
    out["head_ipt/w"] = ((head, af), "normal", 1 / math.sqrt(head))
    out["head_ipt/b"] = ((af,), "zeros", 0.0)
    if sp["ctc"]:
        out["head_asr/w"] = ((head, m["num_asr_labels"] + 1), "normal", 1 / math.sqrt(head))
        out["head_asr/b"] = ((m["num_asr_labels"] + 1,), "zeros", 0.0)
    return out


def _dense(ar: Arith, p: dict, key: str, x):
    return ar.mm(x, p[key + "/w"]) + p[key + "/b"]


def _bilstm(ar: Arith, p: dict, i: int, x: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T, 2H): both directions stepped together."""
    wx, wh, b = p[f"blstm/{i}/wx"], p[f"blstm/{i}/wh"], p[f"blstm/{i}/b"]
    hid = wh.shape[1]
    x2 = torch.stack([x, x.flip(1)])  # (2, B, T, D)
    xw = ar.mm(x2, wx[:, None]) + b[:, None, None, :]  # (2, B, T, 4H)
    h = x.new_zeros(2, x.shape[0], hid)
    c = torch.zeros_like(h)
    hs = []
    for t in range(x.shape[1]):
        g = xw[:, :, t] + ar.bmm(h, wh)
        gi, gf, gg, go = g.chunk(4, -1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        hs.append(h)
    hs = torch.stack(hs, 2)  # (2, B, T, H)
    return torch.cat([hs[0], hs[1].flip(1)], -1)


def forward(ar: Arith, p: dict, batch: dict, m: dict, geo: dict, stats) -> dict:
    """batch: waves (B, N) f32, frame masks (B, T) f32, video (B, T, V) f32."""
    sp = _spec(m)
    af = m["audio_feat_dim"]
    mean, std = stats
    re, im = dsp.stft(ar, batch["waves"], geo)
    t = batch["frames"].shape[1]
    re, im = re[:, :t, :af], im[:, :t, :af]
    logmag = torch.log(torch.sqrt(re * re + im * im) + 1e-6)
    norm = (logmag - mean) / std
    mask = batch["frames"][:, :, None].expand(-1, -1, af)
    audio = norm * mask
    x = {"a": audio, "v": batch["video"], "av": torch.cat([audio, batch["video"]], 2)}[sp["input"]]
    if sp["ssnn"]:
        h = F.leaky_relu(_dense(ar, p, "ssnn/0", torch.cat([audio, dsp.delta(audio)], 2)), 0.3)
        h = F.leaky_relu(_dense(ar, p, "ssnn/1", h), 0.3)
        h = _dense(ar, p, "ssnn/2", h)
        fm = batch["frames"]
        emb = (h * fm[:, :, None]).sum(1) / (fm.sum(1) + 1.0)[:, None]
        x = torch.cat([x, emb[:, None].expand(-1, t, -1)], 2)
    for i in range(len(m["net_dim"])):
        x = _bilstm(ar, p, i, x)
    inference = _dense(ar, p, "head_ipt", x)
    out = {"norm": norm, "mask": mask, "re": re, "im": im,
           "prediction": norm * mask + inference * (1 - mask)}
    if sp["ctc"]:
        out["logits"] = _dense(ar, p, "head_asr", x)
    return out


def hole_l1(out: dict, dims=(1, 2)):
    """Mean |target - prediction| over the hole (per row with dims (1, 2),
    over the batch with dims None)."""
    hole = 1 - out["mask"]
    diff = (out["norm"] - out["prediction"]).abs() * hole
    if dims is None:
        return diff.sum() / hole.sum().clamp(min=1.0)
    return diff.sum(dims) / hole.sum(dims).clamp(min=1.0)


def loss(out: dict, batch: dict, m: dict) -> torch.Tensor:
    total = hole_l1(out, None)
    if _spec(m)["ctc"]:
        logp = F.log_softmax(out["logits"], -1).transpose(0, 1)
        t = out["logits"].shape[1]
        nll = F.ctc_loss(logp, batch["labels"], torch.full_like(batch["label_lengths"], t),
                         batch["label_lengths"], blank=out["logits"].shape[-1] - 1,
                         reduction="none")
        total = total + m["ctc_loss"] * nll.mean()
    return total


def fft_flops(geo: dict) -> float:
    """One frame's FFT at 5 N log2 N."""
    n = geo["fft_length"]
    return 5 * n * math.log2(n)


def forward_flops(m: dict, geo: dict, frames: int) -> float:
    """Model operations of one utterance's forward, 2 per multiply-add,
    element-wise work left out, the STFT at an FFT's count: SSNN MLP, each
    BLSTM layer's projection and recurrence in both directions, the heads."""
    sp = _spec(m)
    af = m["audio_feat_dim"]
    macs = 0
    if sp["ssnn"]:
        macs += frames * (2 * af * SSNN + 2 * SSNN * SSNN)
    for d, h in layer_inputs(m):
        macs += 2 * frames * (d + h) * 4 * h
    macs += frames * 2 * m["net_dim"][-1] * (af + (m["num_asr_labels"] + 1 if sp["ctc"] else 0))
    return 2 * macs + frames * fft_flops(geo)


def train_flops(m: dict, geo: dict, frames: int) -> float:
    """Forward and backward of one utterance: three times the forward's
    products (the backward's input and weight gradients); the STFT once
    (its input, the waveform, takes no gradient)."""
    fwd = forward_flops(m, geo, frames)
    stft = frames * fft_flops(geo)
    return 3 * (fwd - stft) + stft

