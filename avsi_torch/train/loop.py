"""Training loop for the inpainting and ASR models (port of `avsi/train/loop.py`).

`train(config_file)` keeps the reference's behaviour on one device: the
epoch loop over shuffled `drop_remainder` batches, the NaN/Inf abort every
`nan_check_every` steps, the periodic `ckpt` every 1000 steps with its
optimizer sidecar, per-epoch validation over `pad_final` batches with the
filler rows dropped on the host, the best-validation checkpoint `sinet`,
early stopping after `n_earlystop_epochs`, `training_log.txt`, a
self-contained checkpoint directory (config + stats), and resuming from
`model_ckp` (params, optimizer state and step).  `is_asr` trains a
standalone CTC ASR model (`models/asr.py`): its bundle keeps the 80-bin
log-mel stats uncut, validation reports `val_loss` and `val_per` and
selects by PER, and the best checkpoint is `asrnet`.  `av-blstm-twosteps`
restores its v-net from `model_ckp_vnet` and trains the av-net only (the
model's trainable mask).

On the device, each train step runs the model forward with `train=True`
(the BLSTM layers through K3 and K4 under autograd, `ops/lstm_train.py`),
the losses, the backward and the optimizer update; validation runs the
fused forward-only stack (K1 + K2).  A config with `lc_chunk` trains the
latency-controlled model that the streams serve: training and validation
run the LC stack (`models/core.lc_blstm_stack`, an eager scan under
autograd, as the reference scans it whatever `lstm_impl` says).  The step takes the whole host batch
to the device as it is: the reference's compaction of masks to int8 frames
and of waves to int16 is a TPU transfer trick, and the masks the model
sees are the same either way.

Not ported yet, each refused with NotImplementedError where a config asks
for it: data-parallel and tensor-parallel meshes and multi-host runs, the
device-resident corpus cache, `profile_steps` traces and TensorBoard
media.  The SIGTERM preemption checkpoint is not ported either; the port
writes no TensorBoard events.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque

import numpy as np
import torch

from avsi_torch import config as config_lib
from avsi_torch.data.reader import DataManager
from avsi_torch.data.tfrecord import list_tfrecord_files
from avsi_torch.device import resolve_device
from avsi_torch.infer import common
from avsi_torch.infer.inpaint import DEVICE_BATCH_KEYS, expand_batch
from avsi_torch.models import asr as asr_model
from avsi_torch.models import blstm as blstm_lib
from avsi_torch.models import registry
from avsi_torch.ops import ctc as ctc_ops
from avsi_torch.ops import lstm_fused
from avsi_torch.train import checkpoints
from avsi_torch.train import state as state_lib


def _log(logfile: str, msg: str) -> None:
    print(msg, flush=True)
    with open(logfile, "a") as f:
        f.write(msg + "\n")


def _refuse_unported(config: dict) -> None:
    """Raise where the config asks for what this port does not do yet."""
    asks = {
        "tensor parallelism (num_model_shards > 1)": int(config.get("num_model_shards", 1)) > 1,
        "data-parallel meshes (num_data_shards > 1)": int(config.get("num_data_shards", 0)) > 1,
        "the device-resident corpus cache (device_cache_corpus)":
            bool(int(config.get("device_cache_corpus", 0))),
        "profiler traces (profile_steps)": bool(int(config.get("profile_steps", 0))),
        "TensorBoard media (tb_media)": bool(int(config.get("tb_media", 0))),
    }
    for what, asked in asks.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported yet")


def device_batch(batch: dict, device, audio_feat_dim: int, frame_stack: int = 1) -> dict:
    """Host batch (numpy) -> tensors on `device`, plus the host-side CTC
    feasibility of each row (`ctc_infeasible`, numpy) so the loss needs no
    device sync to find infeasible alignments.  Feasibility is decided on
    the logits' frames: an ASR model's `frame_stack` k leaves ceil(T / k)."""
    out = {k: torch.as_tensor(np.asarray(batch[k])).to(device) for k in DEVICE_BATCH_KEYS
           if k in batch}
    out = expand_batch(out, audio_feat_dim)
    out["ctc_infeasible"] = asr_model.ctc_infeasible(batch, frame_stack)
    return out


def _frame_stack(config: dict, is_asr: bool) -> int:
    """The logits' time subsampling: an ASR model's `frame_stack`, else 1."""
    return int(config.get("frame_stack", 1)) if is_asr else 1


def _stats_on(stats: tuple, device) -> tuple:
    return tuple(torch.as_tensor(np.asarray(s), dtype=torch.float32).to(device) for s in stats)


def make_train_step(model, config: dict, stats: tuple, device, is_asr: bool = False):
    """Step `(state, host batch, gen) -> losses`: forward with train=True,
    losses, backward, one optimizer update of `state` in place.  The
    gradients stay on the params' `.grad` until the next step."""
    stats_t = _stats_on(stats, device)
    af, k = int(config["audio_feat_dim"]), _frame_stack(config, is_asr)

    def train_step(state: state_lib.TrainState, batch: dict, gen) -> dict:
        dev = device_batch(batch, device, af, k)
        state.optimizer.zero_grad(set_to_none=True)
        out = model.forward(state.params, dev, config, stats_t, train=True, gen=gen)
        ldict = model.losses(out, dev, config)
        ldict["loss"].backward()
        state_lib.apply_gradients(state, config)
        return {k: v.detach() for k, v in ldict.items()}

    return train_step


def make_eval_step(model, config: dict, stats: tuple, device, is_asr: bool = False):
    """Step `(params, host batch) -> per-sample results` for validation:
    per-sample L1 losses, and for CTC models the per-sequence CTC loss and
    the greedy decode (per sample, so the host can drop filler rows); an
    ASR model's CTC loss and decode on its logit lengths."""
    stats_t = _stats_on(stats, device)
    af, k = int(config["audio_feat_dim"]), _frame_stack(config, is_asr)

    @torch.inference_mode()
    def eval_step(params, batch: dict) -> dict:
        dev = device_batch(batch, device, af, k)
        out = model.forward(params, dev, config, stats_t, train=False)
        if is_asr:
            return {"loss_ps": ctc_ops.ctc_loss_per_seq(
                        out["logits"], out["logit_lengths"], dev["labels"],
                        dev["labels_lengths"], dev["ctc_infeasible"]),
                    "decoded": asr_model.decode_greedy(out)}
        total, hole = common.per_sample_losses(out, dev)
        res = {"loss_ps": total, "loss_hole_ps": hole}
        if "asr_logits" in out:
            res["ctc_ps"] = ctc_ops.ctc_loss_per_seq(
                out["asr_logits"], dev["sequence_lengths"], dev["labels"],
                dev["labels_lengths"], dev["ctc_infeasible"],
            )
            res["decoded"] = ctc_ops.greedy_decode(out["asr_logits"], dev["sequence_lengths"])
        return res

    return eval_step


def _host_per(decoded: np.ndarray, meta: dict) -> float:
    dec, labs = [], []
    for i in range(meta["num_real"]):
        dec.append([int(x) for x in decoded[i] if x >= 0])
        ll = int(meta["labels_lengths"][i])
        labs.append([int(x) for x in meta["labels"][i][:ll]])
    return ctc_ops.per_metric(dec, labs)


def _val_pairs(dm: DataManager, val_files: list[str], batch_size: int):
    """(host meta, batch) pairs of one validation pass over `pad_final`
    batches; `num_real` marks the rows that count."""
    for batch in dm.batches(val_files, batch_size, pad_final=True):
        meta = {k: np.asarray(batch[k]) for k in ("labels", "labels_lengths")}
        meta["num_real"] = batch["num_real"]
        yield meta, batch


def _validate(val_pairs, eval_step, params, select_hole: bool,
              is_asr: bool = False) -> tuple[float, str]:
    """Per-epoch validation: a window of batches in flight (the device runs
    ahead while the host reads earlier results), filler rows dropped.
    Returns (selection metric, report): an ASR model's is its PER."""
    def pipelined(depth=8):
        window: deque = deque()
        for meta, batch in val_pairs:
            window.append((meta, eval_step(params, batch)))
            if len(window) >= depth:
                yield window.popleft()
        while window:
            yield window.popleft()

    if is_asr:
        losses, pers, weights = [], [], []
        for meta, res in pipelined():
            n = meta["num_real"]
            if n:
                losses.extend(res["loss_ps"].cpu().numpy()[:n].tolist())
                pers.append(_host_per(res["decoded"].cpu().numpy(), meta) * n)
                weights.append(n)
        if not weights:
            return math.inf, "val=none"
        per = float(np.sum(pers) / np.sum(weights))
        return per, f"val_loss={np.mean(losses):.5f}\tval_per={per:.5f}"
    tot, hole, ctcs, ctc_w, pers = [], [], [], [], []
    for meta, res in pipelined():
        n = meta["num_real"]
        if not n:
            continue
        tot.extend(res["loss_ps"].cpu().numpy()[:n].tolist())
        hole.extend(res["loss_hole_ps"].cpu().numpy()[:n].tolist())
        if "ctc_ps" in res:
            ctcs.append(float(np.sum(res["ctc_ps"].cpu().numpy()[:n])))
            ctc_w.append(n)
            pers.append(_host_per(res["decoded"].cpu().numpy(), meta) * n)
    if not tot:
        return math.inf, "val=none"
    report = f"val_loss={np.mean(tot):.5f}\tval_loss_hole={np.mean(hole):.5f}"
    if ctcs:
        report += (f"\tval_ctc={np.sum(ctcs) / np.sum(ctc_w):.5f}"
                   f"\tval_per={np.sum(pers) / np.sum(ctc_w):.5f}")
    metric = float(np.mean(hole)) if select_hole else float(np.mean(tot))
    return metric, report


def train(config_file: str, is_asr: bool = False, device=None) -> dict:
    """Train one model per the config file on one device (default cuda);
    `is_asr` for a standalone ASR model (`registry.ASR_MODELS`).

    Returns {"best_val", "best_epoch", "steps", "step_seconds"}:
    `step_seconds` holds each train step's host time from batch in hand to
    the end of its NaN check, a device time only when `nan_check_every`
    is 1 (the check waits for the step's loss)."""
    config = config_lib.check_trainconfiguration(config_lib.load_configfile(config_file))
    _refuse_unported(config)
    device = resolve_device(device)
    exp_folder = config["exp_folder"]
    ckpt_dir = os.path.join(exp_folder, "netmodel")
    os.makedirs(ckpt_dir, exist_ok=True)
    logfile = os.path.join(exp_folder, "training_log.txt")

    # self-contained checkpoint dir: config + stats (an ASR model's are
    # 80-bin log-mel stats, never cut to audio_feat_dim)
    stats = checkpoints.write_bundle(ckpt_dir, config_file, config,
                                     feat_dim=None if is_asr else int(config["audio_feat_dim"]))
    checkpoints.write_meta(ckpt_dir, config)
    model = (registry.get_asr_model if is_asr else registry.get_model)(config["model"])
    seed = int(config.get("seed", 0))
    dm = DataManager(
        num_audio_samples=config["audio_len"],
        audio_feat_size=config["audio_feat_dim"],
        video_feat_size=config["video_feat_dim"],
        with_embedding=model.needs_embeddings,
        seed=seed,
    )
    train_files = list_tfrecord_files(os.path.join(config["root_folder"], "training-set"))
    val_files = list_tfrecord_files(os.path.join(config["root_folder"], "validation-set"))
    if not train_files:
        raise ValueError(f"no training tfrecords under {config['root_folder']}")
    batch_size = int(config["batch_size"])

    params = model.init(torch.Generator().manual_seed(seed), config, device=device)
    if config["model_ckp_vnet"] and config["model"] == "av-blstm-twosteps":
        # the v-net of a two-step model from a trained v-blstm's checkpoint
        params["vnet"], _ = checkpoints.restore_checkpoint(
            os.path.dirname(config["model_ckp_vnet"]) or ".",
            os.path.basename(config["model_ckp_vnet"]), device, params["vnet"])
        print(f"Restored vnet from {config['model_ckp_vnet']}")
    start_step = 0
    ckp_dir = os.path.dirname(config["model_ckp"]) or "."
    ckp_name = os.path.basename(config["model_ckp"])
    if ckp_name:
        # warm start / resume: params and step, then the optimizer state
        # when the sidecar exists
        params, start_step = checkpoints.restore_checkpoint(ckp_dir, ckp_name, device, params)
    state = state_lib.create_train_state(
        params, config, model.trainable_mask(params) if model.trainable_mask else None)
    if ckp_name:
        checkpoints.restore_opt_state(ckp_dir, ckp_name, state)
        print(f"Restored model from {config['model_ckp']} (step {start_step})")

    config["lstm_impl"] = lstm_fused.resolve_impl(
        config.get("lstm_impl"), device, config["net_dim"], blstm_lib.dtypes(config)[0])
    train_step = make_train_step(model, config, stats, device, is_asr)
    eval_step = make_eval_step(model, config, stats, device, is_asr)
    gen = torch.Generator(device=device).manual_seed(seed)  # dropout masks

    header = " | ".join(f"{k}={config[k]}" for k in (
        "model", "net_dim", "batch_size", "optimizer_type", "starter_learning_rate",
        "dropout_rate", "max_n_epochs", "n_earlystop_epochs",
    ))
    _log(logfile, f"# {header}")
    _log(logfile, f"# device={device} lstm_impl={config['lstm_impl']}")

    select_hole = bool(model.spec and model.spec.loss_on_hole_only)
    nan_check_every = int(config.get("nan_check_every", 100))
    log_every = max(200, nan_check_every)
    best_val, best_epoch, cneg_epochs = math.inf, -1, 0
    step = start_step
    step_seconds: list[float] = []
    for epoch in range(int(config["max_n_epochs"])):
        t_epoch = time.time()
        loss_accum, n_acc = None, 0
        for batch in dm.prefetch_batches(train_files, batch_size, shuffle=True,
                                         drop_remainder=True):
            t_step = time.perf_counter()
            ldict = train_step(state, batch, gen)
            step += 1
            # losses accumulate on the device; the host reads them only at
            # the NaN-check and print cadence
            loss_accum = ldict if loss_accum is None else {
                k: loss_accum[k] + v for k, v in ldict.items()}
            n_acc += 1
            do_nan = bool(nan_check_every) and step % nan_check_every == 0
            if do_nan or step % log_every == 0:
                loss = float(ldict["loss"])
                if do_nan and not np.isfinite(loss):
                    raise FloatingPointError(f"NaN/Inf loss at step {step} — aborting")
                if step % log_every == 0:
                    print(f"epoch {epoch} step {step} "
                          + " ".join(f"{k}={float(v):.5f}" for k, v in ldict.items()), flush=True)
            step_seconds.append(time.perf_counter() - t_step)
            if step % 1000 == 0:
                checkpoints.save_checkpoint(ckpt_dir, "ckpt", state.params, step=step,
                                            train_state=state)
        if n_acc == 0 and epoch == 0:
            _log(logfile, f"# WARNING: 0 training steps in epoch 0 — batch_size "
                          f"({batch_size}) likely exceeds the training corpus "
                          "(drop_remainder drops the lone short batch)")
        tr = {}
        if loss_accum is not None:
            tr = {k: float(v) / n_acc for k, v in loss_accum.items()}
            if not np.isfinite(tr["loss"]):
                raise FloatingPointError(f"NaN/Inf loss in epoch {epoch} — aborting")

        val_metric, val_report = _validate(
            _val_pairs(dm, val_files, batch_size), eval_step, state.params, select_hole, is_asr)
        if not val_files:
            # no validation split: every epoch "improves", so the best
            # checkpoint tracks the latest params
            val_metric = -float(epoch)
        dt = time.time() - t_epoch
        _log(logfile, f"epoch {epoch}\t" + "\t".join(f"train_{k}={v:.5f}" for k, v in tr.items())
             + f"\t{val_report}\ttime={dt:.1f}s")
        if val_metric < best_val:
            best_val, best_epoch, cneg_epochs = val_metric, epoch, 0
            name = "asrnet" if is_asr else "sinet"
            checkpoints.save_checkpoint(ckpt_dir, name, state.params, step=step)
            _log(logfile, f"# new best val metric {best_val:.5f} -> saved {name}")
        else:
            cneg_epochs += 1
            if cneg_epochs >= int(config["n_earlystop_epochs"]):
                _log(logfile, f"# early stop at epoch {epoch} (best epoch {best_epoch})")
                break
    _log(logfile, f"# done: best_val={best_val:.5f} at epoch {best_epoch}")
    return {"best_val": best_val, "best_epoch": best_epoch, "steps": step,
            "step_seconds": step_seconds}
