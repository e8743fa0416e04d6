"""Evaluation harness (port of `avsi/eval/harness.py`): walk the sample
directories, score each one, aggregate, print and write one CSV.

`speech_inpainting_eval` is the reference's `evaluation.py` protocol (L1,
PESQ, STOI, PER and their improvements), `speech_enhancement_eval` its
PER-free `evaluation_asr.py` protocol, with its literal `STOI_I` header.
The CSV schema, the printed lines and the deviations that `avsi` states
are kept: a missing masked.wav gives a partial row instead of an error,
STOI values <= 1e-4 (the silence sentinel) count as NaN in the summaries,
and `with_sdr` adds SDR and SI-SDR columns.

Scoring is host numpy, bound by PESQ.  `num_workers > 1` fans the
samples out over a pool of worker processes started with `spawn`, not
`fork`: a caller may hold a CUDA context and threads (a command line that
trained first, a service), and a spawned worker inherits neither.  The
scoring modules make no CUDA call.
"""

from __future__ import annotations

import csv
import os
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from glob import glob

import numpy as np

from avsi_torch.eval import metrics
from avsi_torch.ops.ctc import edit_distance
from avsi_torch.utils import wav as wavio


def _score_pair(ex_dir, enhanced_rel, target, other, sr, pesq_path, pesq_mode,
                n_fft, window_size, step_size, with_sdr, suffix):
    """L1/PESQ/STOI (+optional SDR/SI-SDR) columns for one wav pair."""
    row = {
        "L1_" + suffix: metrics.l1_eval(target, other, sr, n_fft, window_size, step_size),
        "PESQ_" + suffix: metrics.pesq_eval(
            os.path.join(ex_dir, "target.wav"),
            os.path.join(ex_dir, enhanced_rel),
            pesq_path, pesq_mode,
        )[0],
        "STOI_" + suffix: metrics.stoi_eval(target, other, sr),
    }
    if with_sdr:
        row["SDR_" + suffix] = metrics.sdr_eval(target, other)
        row["SISDR_" + suffix] = metrics.sisdr_eval(
            np.asarray(target, np.float64), np.asarray(other, np.float64)
        )
    return row


def _eval_one(args):
    (ex_dir, enhanced_file, masked_eval, pesq_path, pesq_mode, n_fft,
     window_size, step_size, with_per, with_sdr) = args
    name = os.path.basename(ex_dir)
    enhanced_rel = os.path.join("enhanced", enhanced_file + ".wav")
    try:
        sr, target = wavio.read_wav_int16(os.path.join(ex_dir, "target.wav"))
        _, enhanced = wavio.read_wav_int16(os.path.join(ex_dir, enhanced_rel))
    except FileNotFoundError:
        return None
    n = min(len(target), len(enhanced))
    target, enhanced = target[:n], enhanced[:n]

    row = {"SAMPLE": name}
    row.update(_score_pair(ex_dir, enhanced_rel, target, enhanced, sr, pesq_path,
                           pesq_mode, n_fft, window_size, step_size, with_sdr, "ENH"))
    if with_per:
        tr_path = os.path.join(ex_dir, "transcription.lbl")
        labels_text = open(tr_path).read() if os.path.isfile(tr_path) else ""
        labels = [x for x in labels_text.split(",") if x]
        dec_enh_path = os.path.join(ex_dir, "transcriptions", enhanced_file + ".lbl")
        if os.path.isfile(dec_enh_path):
            with open(dec_enh_path) as f:
                dec_enh_text = f.read()
        else:
            dec_enh_text = ""
        dec_enh = [x for x in dec_enh_text.split(",") if x]
        row["PER_ENH"] = edit_distance(labels, dec_enh) / max(1, len(labels))
        row["LAB"] = labels_text
        row["DEC_ENH"] = dec_enh_text

    if masked_eval:
        try:
            _, masked = wavio.read_wav_int16(os.path.join(ex_dir, "masked.wav"))
        except FileNotFoundError:
            return row
        masked = masked[: len(target)]
        row.update(_score_pair(ex_dir, "masked.wav", target, masked, sr, pesq_path,
                               pesq_mode, n_fft, window_size, step_size, with_sdr, "MASK"))
        if with_per:
            mask_lbl = os.path.join(ex_dir, "masked.lbl")
            dec_masked_text = open(mask_lbl).read() if os.path.isfile(mask_lbl) else ""
            dec_masked = [x for x in dec_masked_text.split(",") if x]
            labels = [x for x in row["LAB"].split(",") if x]
            row["PER_MASK"] = edit_distance(labels, dec_masked) / max(1, len(labels))
            row["DEC_MASK"] = dec_masked_text
    return row


def _collect_rows(test_audio_dir, enhanced_file, masked_eval, pesq_path, pesq_mode,
                  n_fft, window_size, step_size, num_workers, with_per, with_sdr):
    sample_dirs = sorted(
        d for d in glob(os.path.join(test_audio_dir, "*")) if os.path.isdir(d)
    )
    print(f"Test dataset name: {test_audio_dir}")
    print(f"Enhanced file prefix: {enhanced_file}")
    print(f"Number of samples: {len(sample_dirs)}")
    work = [
        (d, enhanced_file, masked_eval, pesq_path, pesq_mode, n_fft,
         window_size, step_size, with_per, with_sdr)
        for d in sample_dirs
    ]
    if num_workers and num_workers > 1:
        with ProcessPoolExecutor(max_workers=num_workers,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            rows = list(pool.map(_eval_one, work))
    else:
        rows = [_eval_one(w) for w in work]
    return [r for r in rows if r is not None]


def _nstats(a):
    a = np.asarray(a, np.float64)
    if not np.isfinite(a).any():
        return (float("nan"), float("nan"))  # e.g. PESQ on unscorable files
    return (float(np.nanmean(a)), float(np.nanstd(a)))


def _write_csv(path, header, rows):
    rows = sorted(rows, key=lambda r: r["SAMPLE"])
    with open(path, "w") as f:
        wr = csv.writer(f, lineterminator="\n")
        wr.writerow(header)
        for r in rows:
            wr.writerow([r.get(k, "") for k in header])
    print(f"Results written to {path}")


def _summarize_and_write(rows, test_audio_dir, out_file, masked_eval,
                         with_sdr, with_per, stoi_imp_key):
    """Shared summary/print/CSV body of the two eval protocols; they differ
    only in the PER columns (`with_per`) and the improvement-header name
    (the reference's evaluation_asr.py literally calls it `STOI_I`)."""
    def col(key):
        return np.asarray([r.get(key, np.nan) for r in rows], np.float64)

    summary = {}
    stoi_enh = np.where(col("STOI_ENH") <= 1e-4, np.nan, col("STOI_ENH"))
    summary["l1_enhanced"] = _nstats(col("L1_ENH"))
    summary["pesq_enhanced"] = _nstats(col("PESQ_ENH"))
    summary["stoi_enhanced"] = _nstats(stoi_enh)
    if with_per:
        summary["per_enhanced"] = _nstats(col("PER_ENH"))
    print("Enhanced L1 (spectrogram): {:.5f} ({:.5f})".format(*summary["l1_enhanced"]))
    print("Enhanced PESQ: {:.5f} ({:.5f})".format(*summary["pesq_enhanced"]))
    print("Enhanced STOI: {:.5f} ({:.5f})".format(*summary["stoi_enhanced"]))
    if with_per:
        print("Enhanced PER: {:.5f} ({:.5f})".format(*summary["per_enhanced"]))
    if with_sdr:
        summary["sdr_enhanced"] = _nstats(col("SDR_ENH"))
        summary["sisdr_enhanced"] = _nstats(col("SISDR_ENH"))
        print("Enhanced SDR: {:.5f} ({:.5f})".format(*summary["sdr_enhanced"]))
        print("Enhanced SI-SDR: {:.5f} ({:.5f})".format(*summary["sisdr_enhanced"]))

    has_masked = masked_eval and any("L1_MASK" in r for r in rows)
    if has_masked:
        stoi_mask = np.where(col("STOI_MASK") <= 1e-4, np.nan, col("STOI_MASK"))
        l1_r = col("L1_MASK") - col("L1_ENH")
        pesq_i = col("PESQ_ENH") - col("PESQ_MASK")
        stoi_i = stoi_enh - stoi_mask
        per_r = col("PER_MASK") - col("PER_ENH") if with_per else None
        for i, r in enumerate(rows):
            r["L1r"], r["PESQi"], r[stoi_imp_key] = l1_r[i], pesq_i[i], stoi_i[i]
            if with_per:
                r["PERr"] = per_r[i]
        summary["l1_masked"] = _nstats(col("L1_MASK"))
        summary["pesq_masked"] = _nstats(col("PESQ_MASK"))
        summary["stoi_masked"] = _nstats(stoi_mask)
        summary["l1_reduction"] = _nstats(l1_r)
        summary["pesq_improvement"] = _nstats(pesq_i)
        summary["stoi_improvement"] = _nstats(stoi_i)
        if with_per:
            # _nstats, not bare mean: a sample with no masked transcription
            # must not turn the whole PER column into nan
            summary["per_masked"] = _nstats(col("PER_MASK"))
            summary["per_reduction"] = _nstats(per_r)
        if with_sdr:
            summary["sdr_masked"] = _nstats(col("SDR_MASK"))
            summary["sisdr_masked"] = _nstats(col("SISDR_MASK"))
        print("Masked L1 (spectrogram): {:.5f} ({:.5f})".format(*summary["l1_masked"]))
        print("Masked PESQ: {:.5f} ({:.5f})".format(*summary["pesq_masked"]))
        print("Masked STOI: {:.5f} ({:.5f})".format(*summary["stoi_masked"]))
        if with_per:
            print("Masked PER: {:.5f} ({:.5f})".format(*summary["per_masked"]))
        print("L1 (spectrogram) reduction: {:.5f} ({:.5f})".format(*summary["l1_reduction"]))
        print("PESQ improvement: {:.5f} ({:.5f})".format(*summary["pesq_improvement"]))
        print("STOI improvement: {:.5f} ({:.5f})".format(*summary["stoi_improvement"]))
        if with_per:
            print("PER reduction: {:.5f} ({:.5f})".format(*summary["per_reduction"]))

    # CSV (the reference's evaluation.py / evaluation_asr.py schemas; the
    # SDR columns are an extension)
    sdr_cols = ["SDR_MASK", "SDR_ENH", "SISDR_MASK", "SISDR_ENH"] if with_sdr else []
    per_cols = ["PER_MASK", "PER_ENH"] if with_per else []
    per_tail = (["PERr", "LAB", "DEC_ENH", "DEC_MASK"] if with_per else [])
    if has_masked:
        header = (["SAMPLE", "L1_MASK", "L1_ENH", "PESQ_MASK", "PESQ_ENH",
                   "STOI_MASK", "STOI_ENH"] + per_cols + sdr_cols +
                  ["L1r", "PESQi", stoi_imp_key] + per_tail)
    else:
        header = (["SAMPLE", "L1_ENH", "PESQ_ENH", "STOI_ENH"]
                  + (["PER_ENH"] if with_per else [])
                  + [c for c in sdr_cols if c.endswith("_ENH")]
                  + (["LAB", "DEC_ENH"] if with_per else []))
    _write_csv(os.path.join(test_audio_dir, out_file + ".csv"), header, rows)
    return summary


def speech_inpainting_eval(
    test_audio_dir: str,
    enhanced_file: str,
    out_file: str,
    masked_eval: bool = True,
    pesq_path: str | None = None,
    pesq_mode: str = "nb",
    n_fft: int = 512,
    window_size: int = 25,
    step_size: int = 10,
    num_workers: int = 0,
    with_sdr: bool = False,
) -> dict:
    rows = _collect_rows(test_audio_dir, enhanced_file, masked_eval, pesq_path,
                         pesq_mode, n_fft, window_size, step_size, num_workers,
                         with_per=True, with_sdr=with_sdr)
    if not rows:
        print("No evaluable samples found.")
        return {}
    return _summarize_and_write(rows, test_audio_dir, out_file, masked_eval,
                                with_sdr, with_per=True, stoi_imp_key="STOIi")


def speech_enhancement_eval(
    test_audio_dir: str,
    enhanced_file: str,
    out_file: str,
    masked_eval: bool = True,
    pesq_path: str | None = None,
    pesq_mode: str = "nb",
    n_fft: int = 512,
    window_size: int = 25,
    step_size: int = 10,
    num_workers: int = 0,
    with_sdr: bool = False,
) -> dict:
    """PER-free L1/PESQ/STOI surface (the reference's evaluation_asr.py).

    Matches the reference's CSV schema exactly, including its literal
    `STOI_I` improvement header; no transcription files are read.
    `with_sdr` appends SDR/SI-SDR columns."""
    rows = _collect_rows(test_audio_dir, enhanced_file, masked_eval, pesq_path,
                         pesq_mode, n_fft, window_size, step_size, num_workers,
                         with_per=False, with_sdr=with_sdr)
    if not rows:
        print("No evaluable samples found.")
        return {}
    return _summarize_and_write(rows, test_audio_dir, out_file, masked_eval,
                                with_sdr, with_per=False, stoi_imp_key="STOI_I")
