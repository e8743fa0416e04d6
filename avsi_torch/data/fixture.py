"""A synthetic GRID-like corpus for tests and end-to-end runs (port of
`avsi/data/fixture.py`).

`make_fixture` writes the on-disk layout the toolchain consumes: per
speaker, clean wavs, 68-point landmarks (75 frames), phoneme transcriptions
and the video stats; then masked sample directories per split
(`generator.create_syn_dataset`, disjoint utterances, mask seeds 30 + k)
and the TFRecord splits (`generator.create_dataset`).  Audio is a sequence
of phoneme-coded harmonic segments under an amplitude envelope; landmarks
are smooth random walks whose mouth rows follow the envelope (and, with
`video_informative`, the phoneme).  Given the same arguments it writes the
reference's tree byte for byte.
"""

from __future__ import annotations

import os
import zlib
from glob import glob

import numpy as np

from avsi_torch.data import generator
from avsi_torch.utils import wav as wavio

PHONEME_SET = [
    "ah", "ao", "ay", "b", "d", "eh", "ey", "f", "g", "ih",
    "iy", "k", "l", "m", "n", "ow", "p", "r", "s", "t",
    "th", "uw", "v", "w", "y", "z", "aa", "ae", "er", "hh",
    "jh", "sh", "ch",
]  # 33 classes, as GRID's


def make_fixture(
    dest_dir: str,
    n_speakers: int = 2,
    n_samples: int | tuple = 4,
    audio_len_ms: int = 3000,
    sample_rate: int = 16000,
    seed: int = 0,
    splits=("training-set", "validation-set", "test-set"),
    gap_ms: float = 800.0,
    gap_std_ms: float = 100.0,
    n_max_intr: int = 1,
    with_embeddings: bool = False,
    video_informative: bool = False,
    mask_hop_ms: int = 12,
    mask_frame_dim: int = 257,
    mask_kind: str = "timegap",
    raw_only: bool = False,
) -> dict:
    """Build the raw corpus, the masked sample directories and the
    TFRecords; returns their paths ("raw", "dictionary", each split's
    sample directory, "tfrecords", "audio").

    n_samples: utterances per speaker in each split (one int, or one per
    split).  raw_only stops after the raw tree (then only "raw" and
    "dictionary" are returned), which is the full build's raw tree.
    with_embeddings writes a speaker-consistent 512-d embedding per sample
    (`<sample>/vgg_embeddings/target.npy`)."""
    rng = np.random.default_rng(seed)
    raw = os.path.join(dest_dir, "raw")
    n_wav = audio_len_ms * sample_rate // 1000

    dict_file = os.path.join(dest_dir, "dictionary.txt")
    os.makedirs(dest_dir, exist_ok=True)
    with open(dict_file, "w") as f:
        f.write(" ".join(PHONEME_SET) + "\n")

    counts = (tuple(n_samples) if isinstance(n_samples, (tuple, list))
              else (n_samples,) * len(splits))
    if len(counts) != len(splits):
        raise ValueError(f"n_samples {counts} does not match splits {splits}")
    # disjoint utterances per split: split k takes the next counts[k] indices
    total_utts = sum(counts)
    offsets = [sum(counts[:k]) for k in range(len(splits))]
    split_names = {split: [f"utt{offsets[k] + i:03d}" for i in range(counts[k])]
                   for k, split in enumerate(splits)}

    for spk in range(1, n_speakers + 1):
        audio_dir = os.path.join(raw, f"s{spk}", f"s{spk}_16kHz")
        lm_dir = os.path.join(raw, f"s{spk}", f"s{spk}.landmarks")
        align_dir = os.path.join(raw, f"s{spk}", "align")
        for d in (audio_dir, lm_dir, align_dir):
            os.makedirs(d, exist_ok=True)
        base_lm = rng.normal(0, 1, size=(68, 2))
        all_lm = []
        for i in range(total_utts):
            name = f"utt{i:03d}"
            t = np.arange(n_wav) / sample_rate
            env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1.5, 3.5) * t + rng.uniform(0, 6))

            # phoneme segments: fundamental and formant encode the phoneme id
            n_ph = int(rng.integers(4, 9))
            ph_ids = rng.integers(0, len(PHONEME_SET), size=n_ph)
            bounds = np.linspace(0, n_wav, n_ph + 1).astype(int)
            sig = np.zeros(n_wav)
            for ph, lo, hi in zip(ph_ids, bounds[:-1], bounds[1:]):
                seg_t = t[lo:hi]
                f0 = 100.0 + 6.0 * float(ph)
                formant = 700.0 + 90.0 * float(ph)
                seg = sum(
                    np.sin(2 * np.pi * f0 * k * seg_t + rng.uniform(0, 6)) / k
                    for k in range(1, 5)
                ) + 0.5 * np.sin(2 * np.pi * formant * seg_t + rng.uniform(0, 6))
                # raised-cosine fades: no clicks at the joins
                fade = min(160, (hi - lo) // 4)
                w = np.ones(hi - lo)
                if fade > 0:
                    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(fade) / fade)
                    w[:fade] = ramp
                    w[-fade:] = ramp[::-1]
                sig[lo:hi] = seg * w
            wave = 6000 * env * sig + 50 * rng.normal(size=n_wav)
            wavio.write_wav_int16(os.path.join(audio_dir, name + ".wav"), wave)

            # a smooth landmark random walk; the mouth rows follow the envelope
            steps = rng.normal(0, 0.02, size=(75, 68, 2)).cumsum(axis=0)
            lm = base_lm[None] + steps
            env75 = np.interp(np.linspace(0, n_wav - 1, 75), np.arange(n_wav), env)
            lm[:, 48:68, 1] += 0.3 * env75[:, None]
            if video_informative:
                # one mouth configuration per phoneme
                ph75 = ph_ids[np.minimum((np.arange(75) * n_ph) // 75, n_ph - 1)]
                for m in range(20):
                    lm[:, 48 + m, 0] += 0.25 * np.sin(2.1 * ph75 + 0.7 * m)
                    lm[:, 48 + m, 1] += 0.25 * np.cos(1.3 * ph75 + 0.9 * m)
            np.save(os.path.join(lm_dir, name + ".npy"), lm.reshape(75, 136))
            all_lm.append(lm.reshape(75, 136))

            with open(os.path.join(align_dir, name + ".lbl"), "w") as f:
                f.write(",".join(PHONEME_SET[p] for p in ph_ids))
        stacked = np.concatenate(all_lm, axis=0)
        mv = np.zeros_like(stacked)
        mv[1:] = stacked[1:] - stacked[:-1]
        np.save(os.path.join(lm_dir, "video_feat_mean.npy"), mv.mean(axis=0))
        np.save(os.path.join(lm_dir, "video_feat_std.npy"), mv.std(axis=0) + 1e-3)

    out = {"raw": raw, "dictionary": dict_file}
    if raw_only:
        return out
    for k, split in enumerate(splits):
        split_dir = os.path.join(dest_dir, "syn", split)
        generator.create_syn_dataset(
            raw, split_dir, speakers=list(range(1, n_speakers + 1)), n_samples=0,
            audio_len=audio_len_ms, n_max_intr=n_max_intr, cov_mean=gap_ms,
            cov_std=gap_std_ms, seed=30 + k, utterance_names=split_names[split],
            mask_hop_ms=mask_hop_ms, mask_frame_dim=mask_frame_dim, mask_kind=mask_kind)
        out[split] = split_dir
        if with_embeddings:
            # glob's order, as the reference draws the rng in it; a speaker's
            # seed is zlib.crc32 of its name (hash() varies per process)
            for sd in glob(os.path.join(split_dir, "*")):
                if not os.path.isdir(sd):
                    continue
                spk = os.path.basename(sd).split("_")[0]
                spk_rng = np.random.default_rng(zlib.crc32(spk.encode()))
                emb = spk_rng.normal(size=512) + 0.05 * rng.normal(size=512)
                emb_dir = os.path.join(sd, "vgg_embeddings")
                os.makedirs(emb_dir, exist_ok=True)
                np.save(os.path.join(emb_dir, "target.npy"), emb.astype(np.float32))
    generator.create_dataset(os.path.join(dest_dir, "syn"), os.path.join(dest_dir, "tfrecords"),
                             dict_file, with_embedding=with_embeddings)
    out["tfrecords"] = os.path.join(dest_dir, "tfrecords")
    out["audio"] = os.path.join(dest_dir, "syn")
    return out
