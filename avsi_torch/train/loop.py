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

A model with batch norm (`unet`, `unet-pconv`) writes its running
statistics into its params after each optimizer update
(`ModelDef.apply_aux_update`), and validates with `train=False`.

As the reference does, `train()` writes TensorBoard events to
`<exp_folder>/tb` (`train/<loss>`, `val/metric` and `train/epoch_time_s`
each epoch, and with `tb_media`, 1 by default, spectrogram images and
enhanced audio of a validation batch read once); `profile_steps = N`
traces steps 3..3+N of epoch 0 with `torch.profiler` into
`<exp_folder>/profile`; a SIGTERM lets the step in flight finish, skips
validation, writes the resume checkpoint `ckpt` with its optimizer sidecar
and returns `preempted: True` (`train_or_exit` then exits with 143).

Not ported yet, each refused with NotImplementedError where a config asks
for it: data-parallel and tensor-parallel meshes and multi-host runs, and
the device-resident corpus cache.
"""

from __future__ import annotations

import contextlib
import math
import os
import signal
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
from avsi_torch.train.tb import SummaryWriter


def _log(logfile: str, msg: str) -> None:
    print(msg, flush=True)
    with open(logfile, "a") as f:
        f.write(msg + "\n")


@contextlib.contextmanager
def _preemption_flag():
    """Catch SIGTERM (what a scheduler sends before it preempts) as a flag
    that the step loop polls, so that `train()` finishes the step in
    flight, writes a full resume checkpoint and returns.  Installed in the
    main thread only (`signal.signal` raises elsewhere); the previous
    handler is restored on exit."""
    flag = {"hit": False}

    def on_term(signum, frame):
        flag["hit"] = True

    not_installed = object()  # signal.signal returns None for a handler set in C
    try:
        prev = signal.signal(signal.SIGTERM, on_term)
    except ValueError:  # not the main thread
        prev = not_installed
    try:
        yield flag
    finally:
        if prev is not not_installed:
            signal.signal(signal.SIGTERM, prev if prev is not None else signal.SIG_DFL)


def exit_if_preempted(summary: dict, code: int = 143) -> None:
    """Exit the process if `summary` came from a SIGTERM-preempted
    `train()`: its resume checkpoint is written, and a script that trains
    several models must not start the next one.  143 = 128 + SIGTERM."""
    if summary.get("preempted"):
        print("# preempted: resume checkpoint written, exiting", flush=True)
        raise SystemExit(code)


def train_or_exit(*args, **kwargs) -> dict:
    """`train()`, but exit the process after a SIGTERM preemption instead
    of returning: the call for scripts that train several models."""
    summary = train(*args, **kwargs)
    exit_if_preempted(summary)
    return summary


def _refuse_unported(config: dict) -> None:
    """Raise where the config asks for a mesh or the device-resident corpus
    cache, which this port does not do yet."""
    asks = {
        "tensor parallelism (num_model_shards > 1)": int(config.get("num_model_shards", 1)) > 1,
        "data-parallel meshes (num_data_shards > 1)": int(config.get("num_data_shards", 0)) > 1,
        "the device-resident corpus cache (device_cache_corpus)":
            bool(int(config.get("device_cache_corpus", 0))),
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
    losses, backward, one optimizer update of `state` in place, then the
    model's auxiliary update (batch-norm running statistics) into the same
    leaves.  The gradients stay on the params' `.grad` until the next step."""
    stats_t = _stats_on(stats, device)
    af, k = int(config["audio_feat_dim"]), _frame_stack(config, is_asr)

    def train_step(state: state_lib.TrainState, batch: dict, gen) -> dict:
        dev = device_batch(batch, device, af, k)
        state.optimizer.zero_grad(set_to_none=True)
        out = model.forward(state.params, dev, config, stats_t, train=True, gen=gen)
        ldict = model.losses(out, dev, config)
        ldict["loss"].backward()
        state_lib.apply_gradients(state, config)
        if model.apply_aux_update is not None:
            model.apply_aux_update(state.params, out)
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

    Returns {"best_val", "best_epoch", "steps", "preempted",
    "step_seconds"}:
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
    tb = SummaryWriter(os.path.join(exp_folder, "tb"))
    media = _TBMedia(model, config, stats, device, dm, val_files) if (
        not is_asr and val_files and int(config.get("tb_media", 1))) else None
    profiler = _StepProfiler(int(config.get("profile_steps", 0)),
                             os.path.join(exp_folder, "profile"), device, logfile)
    best_val, best_epoch, cneg_epochs = math.inf, -1, 0
    step = start_step
    step_seconds: list[float] = []
    with _preemption_flag() as preempt:
        try:
            for epoch in range(int(config["max_n_epochs"])):
                t_epoch = time.time()
                loss_accum, n_acc = None, 0
                for batch in dm.prefetch_batches(train_files, batch_size, shuffle=True,
                                                 drop_remainder=True):
                    t_step = time.perf_counter()
                    profiler.before(step - start_step)
                    ldict = train_step(state, batch, gen)
                    step += 1
                    profiler.after(step - start_step)
                    # losses accumulate on the device; the host reads them
                    # only at the NaN-check and print cadence
                    loss_accum = ldict if loss_accum is None else {
                        k: loss_accum[k] + v for k, v in ldict.items()}
                    n_acc += 1
                    do_nan = bool(nan_check_every) and step % nan_check_every == 0
                    if do_nan or step % log_every == 0:
                        loss = float(ldict["loss"])
                        if do_nan and not np.isfinite(loss):
                            raise FloatingPointError(f"NaN/Inf loss at step {step} — aborting")
                        if step % log_every == 0:
                            print(f"epoch {epoch} step {step} " + " ".join(
                                f"{k}={float(v):.5f}" for k, v in ldict.items()), flush=True)
                    step_seconds.append(time.perf_counter() - t_step)
                    if step % 1000 == 0:
                        checkpoints.save_checkpoint(ckpt_dir, "ckpt", state.params, step=step,
                                                    train_state=state)
                    if preempt["hit"]:
                        break
                if preempt["hit"]:
                    break  # no validation: the checkpoint is written below
                if n_acc == 0 and epoch == 0:
                    _log(logfile, f"# WARNING: 0 training steps in epoch 0 — batch_size "
                                  f"({batch_size}) likely exceeds the training corpus "
                                  "(drop_remainder drops the lone short batch)")
                tr = {}
                if loss_accum is not None:
                    # in key order, as the reference's device_get of the dict gives them
                    tr = {k: float(loss_accum[k]) / n_acc for k in sorted(loss_accum)}
                    if not np.isfinite(tr["loss"]):
                        raise FloatingPointError(f"NaN/Inf loss in epoch {epoch} — aborting")

                val_metric, val_report = _validate(
                    _val_pairs(dm, val_files, batch_size), eval_step, state.params, select_hole,
                    is_asr)
                if not val_files:
                    # no validation split: every epoch "improves", so the best
                    # checkpoint tracks the latest params
                    val_metric = -float(epoch)
                dt = time.time() - t_epoch
                for k, v in tr.items():
                    tb.scalar(f"train/{k}", v, epoch)
                tb.scalar("val/metric", val_metric, epoch)
                tb.scalar("train/epoch_time_s", dt, epoch)
                if media is not None:
                    media.write(tb, state.params, epoch)
                tb.flush()
                _log(logfile, f"epoch {epoch}\t" + "\t".join(
                    f"train_{k}={v:.5f}" for k, v in tr.items()) + f"\t{val_report}\ttime={dt:.1f}s")
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
        except BaseException:
            # an abnormal exit (NaN abort, device fault, KeyboardInterrupt)
            # closes an open trace and the event file before it propagates
            profiler.close()
            tb.close()
            raise
    profiler.finish()
    if preempt["hit"]:
        # the step in flight completed: a full resume point (params,
        # optimizer state, step), the layout of the periodic checkpoint
        checkpoints.save_checkpoint(ckpt_dir, "ckpt", state.params, step=step, train_state=state)
        _log(logfile, f"# SIGTERM: preemption checkpoint at step {step} -> "
                      f"{os.path.join(ckpt_dir, 'ckpt')}; set model_ckp to resume")
    _log(logfile, f"# done: best_val={best_val:.5f} at epoch {best_epoch}")
    tb.close()
    return {"best_val": best_val, "best_epoch": best_epoch, "steps": step,
            "preempted": bool(preempt["hit"]), "step_seconds": step_seconds}


class _StepProfiler:
    """`profile_steps = n`: a `torch.profiler` trace of steps 3..3+n of
    the run (counted from its first step) into `logdir` as a Chrome trace
    (`trace.json`); a run that ends inside the window writes what it has
    and logs a partial trace."""

    FIRST = 3

    def __init__(self, n_steps: int, logdir: str, device, logfile: str):
        self.n_steps, self.logdir, self.device, self.logfile = n_steps, logdir, device, logfile
        self.prof = None

    def before(self, done: int) -> None:
        if self.n_steps and done == self.FIRST and self.prof is None:
            os.makedirs(self.logdir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def after(self, done: int) -> None:
        if self.prof is not None and done == self.FIRST + self.n_steps:
            self._stop()
            self.n_steps = 0
            _log(self.logfile, f"# profiler trace written to {self.logdir}")

    def _stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the traced steps' device work ends
        self.prof.stop()
        self.prof.export_chrome_trace(os.path.join(self.logdir, "trace.json"))
        self.prof = None

    def close(self) -> None:
        """Stop a trace still open (no log line: the run is failing)."""
        if self.prof is not None:
            self._stop()

    def finish(self) -> None:
        """End of the run: a trace still open is closed and logged partial."""
        if self.prof is not None:
            self._stop()
            _log(self.logfile, "# WARNING: run ended before profile_steps steps; "
                               f"partial trace written to {self.logdir}")


class _TBMedia:
    """TensorBoard media of inpainting models (the reference's
    models.py:200-219): spectrogram images of target, prediction and mask,
    and the enhanced audio, of the first `n` validation utterances.  The
    batch is read and uploaded once per `train()`."""

    def __init__(self, model, config: dict, stats: tuple, device, dm, val_files, n: int = 2):
        self.model, self.config, self.n = model, config, n
        self.stats = _stats_on(stats, device)
        batch = next(iter(dm.batches(val_files, n, pad_final=True)))
        self.batch = device_batch(batch, device, int(config["audio_feat_dim"]))

    @torch.inference_mode()
    def write(self, tb: SummaryWriter, params, epoch: int) -> None:
        out = self.model.forward(params, self.batch, self.config, self.stats, train=False)
        target, pred = out["target_spec_norm"].cpu().numpy(), out["prediction"].cpu().numpy()
        masks = self.batch["masks"].cpu().numpy()
        wav = None
        if self.model.enhanced_sources:
            wav = self.model.enhanced_sources(out, self.batch, self.config,
                                              self.stats).cpu().numpy()
        for i in range(min(self.n, target.shape[0])):
            # frequency up, time right
            tb.image(f"Target_spectrogram/{i}", target[i].T[::-1], epoch)
            tb.image(f"Enhanced_spectrogram/{i}", pred[i].T[::-1], epoch)
            tb.image(f"Mask/{i}", masks[i].T[::-1], epoch)
            if wav is not None:
                peak = np.abs(wav[i]).max() or 1.0
                tb.audio(f"Enhanced_audio/{i}", wav[i] / peak * 32000, epoch)
