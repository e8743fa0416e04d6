"""Building a corpus: masked sample directories and TFRecord splits (port
of `avsi/data/generator.py`).

* `create_syn_dataset` / `create_syn_data_speaker`: per-sample directories
  (target.wav, mask.npy, landmarks.npy, transcription.lbl and the speaker's
  video stats) with a random time-gap or free-form mask each;
* `create_dataset` / `create_tfrecords_training`: sample directories -> one
  SequenceExample per `.tfrecord` file (fixed or var mode) and
  `seq_lengths.npy`;
* `group_tfrecords`: single-record files packed into files of `group_size`
  records, sorted by jittered length (the framed records copied verbatim).

Given the same inputs and seeds, it writes the reference's trees byte for
byte.
"""

from __future__ import annotations

import os
import shutil
from glob import glob

import numpy as np

from avsi_torch.data import avsync, landmarks as lm, masks as mask_lib, phonemes
from avsi_torch.data import tfrecord as tfr
from avsi_torch.utils import wav as wavio


def create_syn_data_speaker(
    dataset_dir: str,
    dest_dir: str,
    n_speaker: int,
    n_samples: int = 0,
    audio_len: int = 3000,
    n_max_intr: int = 1,
    cov_mean: float = 1000,
    cov_std: float = 300,
    file_ext: str = "wav",
    rng: np.random.Generator | None = None,
    utterance_names: list[str] | None = None,
    mask_hop_ms: int = 12,
    mask_frame_dim: int = 257,
    mask_kind: str = "timegap",
) -> list[float]:
    """One speaker's masked sample directories; returns their coverages.

    utterance_names keeps only those clean utterances (disjoint splits from
    one raw corpus).  mask_hop_ms / mask_frame_dim set the mask's STFT
    geometry (the BLSTMs' 12 ms hop at 257 bins, the U-Nets' 8 ms at 128);
    mask_kind "freeform" draws free-form holes, and the directory name's
    intrusion count is then the stroke count."""
    rng = rng or np.random.default_rng(30)
    clean_audio_dir = os.path.join(dataset_dir, f"s{n_speaker}", f"s{n_speaker}_16kHz")
    clean_list = sorted(glob(os.path.join(clean_audio_dir, f"*.{file_ext}")))
    if utterance_names is not None:
        wanted = set(utterance_names)
        clean_list = [p for p in clean_list
                      if os.path.splitext(os.path.basename(p))[0] in wanted]
    landmarks_dir = os.path.join(dataset_dir, f"s{n_speaker}", f"s{n_speaker}.landmarks")
    transcriptions_dir = os.path.join(dataset_dir, f"s{n_speaker}", "align")
    video_mean_file = os.path.join(landmarks_dir, "video_feat_mean.npy")
    video_std_file = os.path.join(landmarks_dir, "video_feat_std.npy")

    if n_samples > 0:
        rng.shuffle(clean_list)
        clean_list = clean_list[:n_samples]

    spec_len = audio_len // mask_hop_ms  # the hop in ms at 16 kHz
    cov_mean_ratio = cov_mean / audio_len
    cov_std_ratio = cov_std / audio_len
    mask_cov_list = []
    if mask_kind not in ("timegap", "freeform"):
        raise ValueError(f"unknown mask_kind {mask_kind!r}")
    for clean_file in clean_list:
        if mask_kind == "freeform":
            mask, cov, n_intr = mask_lib.get_freeform_mask(
                rng, mask_frame_dim, spec_len, cov_mean_ratio, cov_std_ratio)
        else:
            mask, cov, n_intr = mask_lib.get_intrusions_mask(
                rng, mask_frame_dim, spec_len, cov_mean_ratio, cov_std_ratio, n_max_intr)
        mask_cov_list.append(cov)
        base = os.path.splitext(os.path.basename(clean_file))[0]
        dest = os.path.join(dest_dir, f"s{n_speaker}_{base}_{int(cov * audio_len)}_{n_intr}")
        os.makedirs(dest, exist_ok=True)
        shutil.copy(clean_file, os.path.join(dest, "target.wav"))
        shutil.copy(os.path.join(landmarks_dir, base + ".npy"),
                    os.path.join(dest, "landmarks.npy"))
        shutil.copy(os.path.join(transcriptions_dir, base + ".lbl"),
                    os.path.join(dest, "transcription.lbl"))
        shutil.copy(video_mean_file, os.path.join(dest, "video_feat_mean.npy"))
        shutil.copy(video_std_file, os.path.join(dest, "video_feat_std.npy"))
        np.save(os.path.join(dest, "mask.npy"), mask)
    return mask_cov_list


def create_syn_dataset(
    dataset_dir: str,
    dest_dir: str,
    speakers: list[int] = (),
    n_samples: int = 0,
    audio_len: int = 3000,
    n_max_intr: int = 1,
    cov_mean: float = 1000,
    cov_std: float = 300,
    file_ext: str = "wav",
    seed: int = 30,
    utterance_names: list[str] | None = None,
    mask_hop_ms: int = 12,
    mask_frame_dim: int = 257,
    mask_kind: str = "timegap",
) -> None:
    """The masked sample directories of `speakers`, one rng seeded `seed`."""
    os.makedirs(dest_dir, exist_ok=True)
    mask_cov_list: list[float] = []
    rng = np.random.default_rng(seed)
    for s in speakers:
        print(f"Creating masks of speaker {s}...")
        mask_cov_list += create_syn_data_speaker(
            dataset_dir, dest_dir, s, n_samples, audio_len, n_max_intr, cov_mean, cov_std,
            file_ext, rng, utterance_names, mask_hop_ms=mask_hop_ms,
            mask_frame_dim=mask_frame_dim, mask_kind=mask_kind)
    print("Dataset generation completed. {:d} samples, coverage mean {:.2f} ms "
          "std {:.2f} ms".format(
              len(mask_cov_list),
              float(np.mean(mask_cov_list)) * audio_len if mask_cov_list else 0.0,
              float(np.std(mask_cov_list)) * audio_len if mask_cov_list else 0.0))


def create_tfrecords_training(
    data_path: str,
    dest_dir: str,
    ph_dict: list[str],
    with_embedding: bool = False,
    tfrecord_mode: str = "fixed",
) -> int:
    """Sample directories -> one TFRecord file each, and seq_lengths.npy;
    returns the count.  Video: landmarks synced to the mask's frames, their
    motion vectors normalized by the speaker's stats.  Labels are padded to
    MAX_LABEL_LEN in both modes."""
    sample_dirs = sorted(d for d in glob(os.path.join(data_path, "*")) if os.path.isdir(d))
    os.makedirs(dest_dir, exist_ok=True)
    serialize = tfr.serialize_sample_fixed if tfrecord_mode == "fixed" else tfr.serialize_sample_var
    file_counter = 0
    seq_lengths = []
    for sample_dir in sample_dirs:
        _, target = wavio.read_wav_int16(os.path.join(sample_dir, "target.wav"))
        mask = np.load(os.path.join(sample_dir, "mask.npy"))
        seq_len = len(mask)
        face_land = np.load(os.path.join(sample_dir, "landmarks.npy")).reshape((-1, 136))
        video_features = avsync.sync_audio_visual_features(
            mask, face_land, tot_frames=75, min_frames=70)
        if video_features is None:
            print(f"Skipped {sample_dir}. Video features corrupted.")
            continue
        video_features = lm.get_motion_vector(video_features, delta=1)
        with open(os.path.join(sample_dir, "transcription.lbl")) as f:
            transcription = f.read()
        labels = phonemes.get_labels(transcription, ph_dict)
        lab_len = len(labels)
        labels = np.pad(labels, (0, phonemes.MAX_LABEL_LEN - len(labels)))
        video_mean = np.load(os.path.join(sample_dir, "video_feat_mean.npy")).flatten()
        video_std = np.load(os.path.join(sample_dir, "video_feat_std.npy")).flatten()
        video_features = (video_features - video_mean) / video_std
        embedding = None
        if with_embedding:
            embedding = np.load(os.path.join(sample_dir, "vgg_embeddings", "target.npy")).flatten()

        seq_lengths.append(seq_len)
        file_counter += 1
        record = serialize(
            seq_len, lab_len, target.astype(np.float32), video_features.astype(np.float32),
            mask.astype(np.float32), labels.astype(np.float32), os.path.basename(sample_dir),
            embedding=embedding)
        with tfr.TFRecordWriter(os.path.join(dest_dir, f"data_{file_counter:05d}.tfrecord")) as w:
            w.write(record)
    np.save(os.path.join(dest_dir, "seq_lengths.npy"), np.asarray(seq_lengths))
    return file_counter


def create_dataset(
    data_path: str,
    dest_dir: str,
    dictionary_file: str,
    with_embedding: bool = False,
    tfrecord_mode: str = "fixed",
) -> None:
    """The training, validation and test TFRecord splits of `data_path`."""
    ph_dict = phonemes.load_dictionary(dictionary_file)
    for split in ("training-set", "validation-set", "test-set"):
        src = os.path.join(data_path, split)
        if not os.path.isdir(src):
            continue
        n = create_tfrecords_training(src, os.path.join(dest_dir, split), ph_dict,
                                      with_embedding, tfrecord_mode)
        print(f"{split}: {n} samples")


def group_tfrecords(input_dir: str, output_dir: str, group_size: int = 16,
                    delete_input_dir: bool = False) -> None:
    """Pack single-record files into files of `group_size` records, sorted
    by length jittered with an rng seeded 0 (the framed records copied
    verbatim: no decode, no new checksum)."""
    os.makedirs(output_dir, exist_ok=True)
    seq_path = os.path.join(input_dir, "seq_lengths.npy")
    if not os.path.isfile(seq_path):
        raise IOError(f"Cannot find seq_lengths.npy in directory {input_dir}")
    seq_lengths = np.load(seq_path)
    files = sorted(glob(os.path.join(input_dir, "*.tfrecord")))
    if len(files) != len(seq_lengths):
        raise ValueError(f"Non matching number of input files [{len(files)}] and "
                         f"seq_lengths.npy entries [{len(seq_lengths)}]")
    shutil.copy(seq_path, os.path.join(output_dir, "seq_lengths.npy"))
    rand = seq_lengths + np.random.default_rng(0).random(len(seq_lengths)) * 10
    files_ord = [files[i] for i in np.argsort(rand)]

    n_out = 0
    for i in range(0, len(files_ord), group_size):
        with open(os.path.join(output_dir, f"data_{n_out:05d}.tfrecord"), "wb") as w:
            for f in files_ord[i:i + group_size]:
                for frame in tfr.read_raw_records(f):
                    w.write(frame)
        n_out += 1
    if delete_input_dir:
        shutil.rmtree(input_dir)
    print(f"Grouped {len(files_ord)} samples into {n_out} TFRecords")
