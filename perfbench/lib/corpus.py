"""A training corpus drawn from the seed, in the host batches the port's
reader yields: int16-valued waves (`wave_scale` x N(0, 1), rounded and
clipped), gap masks from the frozen mask generator (full band, (B, T,
bins) float32), f16 video rows, CTC label rows of GRID sentences (one word
drawn for each slot of the traffic's `grid_words`, which gives each word's
phoneme count; the labels are drawn from the 33 classes), full sequence
lengths.  The waves and the video, the bulk, are drawn on the device in
chunks of `CHUNK` utterances, cast there and copied into host arrays, so no
float32 copy of the whole corpus is ever held; the rest with numpy."""

from __future__ import annotations

import numpy as np

from perfbench.lib.masks import gap_masks

LABEL_SLOTS = 50  # padded label row width of the corpus format
CHUNK = 1024  # utterances drawn on the device at a time


def frames_of(model: dict, geo: dict) -> int:
    return -(-int(model["audio_len"]) // geo["frame_step"])


def grid_label_lengths(rng: np.random.Generator, n: int, grid_words: list) -> np.ndarray:
    """Phonemes in each of n sentences: one word per slot, uniformly."""
    return sum(rng.choice(np.asarray(slot, np.int32), n) for slot in grid_words).astype(np.int32)


def draw(seed: int, model: dict, geo: dict, traffic: dict, device) -> dict:
    """The whole corpus as host arrays over utterances."""
    import torch

    gen = torch.Generator(device=device).manual_seed((seed * 7919 + 1) % 2 ** 63)
    n, t = traffic["corpus_utterances"], frames_of(model, geo)
    n_wav, n_vid = int(model["audio_len"]), int(model["video_feat_dim"])
    waves = np.empty((n, n_wav), np.int16)
    video = np.empty((n, t, n_vid), np.float16)
    for lo in range(0, n, CHUNK):
        k = min(CHUNK, n - lo)
        w = torch.randn(k, n_wav, generator=gen, device=device).mul_(traffic["wave_scale"])
        waves[lo:lo + k] = w.round_().clamp_(-32768, 32767).to(torch.int16).cpu().numpy()
        v = torch.randn(k, t, n_vid, generator=gen, device=device)
        video[lo:lo + k] = v.to(torch.float16).cpu().numpy()
        del w, v
    rng = np.random.default_rng([seed, 1])
    frames = gap_masks(rng, n, t, traffic["gaps"])
    label_lengths = grid_label_lengths(rng, n, traffic["grid_words"])
    labels = rng.integers(0, int(model["num_asr_labels"]), (n, LABEL_SLOTS)).astype(np.float32)
    labels[np.arange(LABEL_SLOTS)[None, :] >= label_lengths[:, None]] = 0
    return {"waves": waves, "frames": frames, "video": video, "labels": labels,
            "label_lengths": label_lengths, "frames_per_utt": t}


def host_batch(corpus: dict, rows: np.ndarray, bins: int) -> dict:
    """The batch of `rows` as the port's reader gives it."""
    fr = corpus["frames"][rows].astype(np.float32)
    return {
        "sequence_lengths": np.full(len(rows), corpus["frames_per_utt"], np.int32),
        "labels_lengths": corpus["label_lengths"][rows],
        "target_sources": corpus["waves"][rows],
        "labels": corpus["labels"][rows],
        "video_features": corpus["video"][rows],
        "masks": np.ascontiguousarray(np.broadcast_to(fr[:, :, None], fr.shape + (bins,))),
    }


def ref_batch(corpus: dict, rows: np.ndarray, device) -> dict:
    """The same rows for the reference, as float32 tensors."""
    import torch

    as_t = lambda a, dtype: torch.from_numpy(a[rows].astype(dtype)).to(device)  # noqa: E731
    return {"waves": as_t(corpus["waves"], np.float32),
            "frames": as_t(corpus["frames"], np.float32),
            "video": as_t(corpus["video"], np.float32),
            "labels": as_t(corpus["labels"], np.int64),
            "label_lengths": as_t(corpus["label_lengths"], np.int64)}
