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
autograd, as the reference scans it whatever `lstm_impl` says).  Train and
validation batches reach the device as the reference's `place` sends them:
compacted on the host (`mesh.compact_batch`: time-gap masks as int8
frames, int16-valued waves as int16, video as f16), uploaded, and expanded
inside the step (`mesh.expand_batch`).  The compaction is lossless for the
masks and the waves, but it rounds the video to f16, so the model trains on
the reference's inputs only because it takes the same route.  The
TensorBoard media batch is uploaded uncompacted, as in the reference.

`device_cache_corpus = 1` (with more than one epoch), or a `corpus_cache`
dict shared across `train()` calls, keeps the corpus on the device: epoch 0
streams the batches, compacted and uploaded, and keeps them with their host
meta; later epochs (and later calls on a filled shared cache) draw them in
the order of `np.random.default_rng(seed + 101).permutation`, as the
reference does, with no reader and no host-to-device copy of a batch.
Nothing on the step writes into its input batch, so the cached tensors
stay as they were stored.

A model with batch norm (`unet`, `unet-pconv`) writes its running
statistics into its params after each optimizer update
(`ModelDef.apply_aux_update`), and validates with `train=False`.

As the reference does, `train()` writes TensorBoard events to
`<exp_folder>/tb` (`train/<loss>`, `val/metric` and `train/epoch_time_s`
each epoch, and with `tb_media`, 1 by default, spectrogram images and
enhanced audio of a validation batch read once); `profile_steps = N`
traces steps 3..3+N of epoch 0 with `torch.profiler`, and the steps'
spans, into `<exp_folder>/profile`; a SIGTERM lets the step in flight
finish, skips validation, writes the resume checkpoint `ckpt` with its
optimizer sidecar and returns `preempted: True` (`train_or_exit` then
exits with 143).

Meshes and processes (`avsi_torch/parallel`).  A config's
`num_data_shards` / `num_model_shards` build a mesh over the process's
devices (`train(devices=...)`, default every visible card, or the CPU
once); when the batch divides the data axis, each step splits the batch
over the data shards and computes what the one-device step computes on the
whole batch: each shard's losses carry the global batch's denominators,
batch norm reduces its moments over every shard, dropout keeps each
shard's rows of the global mask, and the shards' gradients are summed.
A model axis stores the params and their optimizer state in
`param_spec` pieces (`mesh.shard_state`).  Under `torch.distributed`
(`distributed.initialize`, before `train()`) every rank runs this function:
it reads its own file shard, the ranks agree on the steps per epoch (the
least) and the validation batches (the most, padded with `num_real=0`
fillers), the gradients, losses and validation sums are summed over the
ranks, a SIGTERM is agreed every 10 steps and at the end of an epoch, every
batch's compaction signature is checked to agree, and only rank 0 writes
the bundle, the logs, TensorBoard and checkpoints (every rank gathers).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import signal
import time
from collections import deque

import numpy as np
import torch

from avsi_torch import config as config_lib
from avsi_torch.data import stats as stats_lib
from avsi_torch.data.reader import DataManager
from avsi_torch.data.tfrecord import count_records, list_tfrecord_files
from avsi_torch.device import resolve_device
from avsi_torch.infer import common
from avsi_torch.models import asr as asr_model
from avsi_torch.models import blstm as blstm_lib
from avsi_torch.models import registry
from avsi_torch.ops import ctc as ctc_ops
from avsi_torch.ops import lstm_fused
from avsi_torch.parallel import distributed
from avsi_torch.parallel import mesh as mesh_lib
from avsi_torch.train import checkpoints
from avsi_torch.train import graphs as graphs_lib
from avsi_torch.train import state as state_lib
from avsi_torch.train.tb import SummaryWriter
from avsi_torch.utils import profiling


def _log(logfile: str | None, msg: str) -> None:
    """Print; and append to `logfile` (None on the ranks that write nothing)."""
    print(msg, flush=True)
    if logfile:
        with open(logfile, "a") as f:
            f.write(msg + "\n")


class _NullTB:
    """The TensorBoard sink of the ranks other than 0."""

    def scalar(self, *a, **k): pass
    def image(self, *a, **k): pass
    def audio(self, *a, **k): pass
    def flush(self): pass
    def close(self): pass


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


_HOST_META_KEYS = ("labels", "labels_lengths", "sequence_lengths")


@dataclasses.dataclass
class Placed:
    """A batch as the steps take it: its tensors on the device (`dev`,
    compacted unless the caller asked otherwise) and its host meta (`meta`:
    labels, their lengths, the sequence lengths and `num_real`), which the
    validation's PER and the shard contexts read without a device sync."""

    dev: dict
    meta: dict


def place(batch: dict, device, compact: bool = True) -> Placed:
    """Host batch (numpy) -> `Placed`, the reference's `place`: the host
    compaction (`compact_batch`), then the upload, from pinned memory on a
    GPU so that it runs behind the host.  PyTorch's pinned-memory allocator
    keeps a pinned buffer until the copy that reads it is done, so the host
    arrays outlive the copy.  compact=False uploads the batch as it is."""
    meta = {k: np.asarray(batch[k]) for k in _HOST_META_KEYS if k in batch}
    meta["num_real"] = batch.get("num_real", len(meta["sequence_lengths"]))
    host = mesh_lib.compact_batch(batch) if compact else mesh_lib.device_batch(batch)
    device = torch.device(device)
    dev = {k: torch.as_tensor(v).to(device, non_blocking=True)
           for k, v in common.upload_source(host, device).items()}
    return Placed(dev, meta)


def step_input(placed: Placed, audio_feat_dim: int, frame_stack: int = 1) -> dict:
    """What the model reads: the batch expanded on the device (a new dict;
    the placed tensors are never written).  `frame_stack` is not read: the
    CTC loss decides which rows its logit frames can align by itself; the
    parameter stays because perfbench's controls wrap this signature."""
    return mesh_lib.expand_batch(placed.dev, audio_feat_dim)


def _stats_on(stats: tuple, device) -> tuple:
    return tuple(torch.as_tensor(np.asarray(s), dtype=torch.float32).to(device) for s in stats)


def _update(model, config: dict, state: state_lib.TrainState, out: dict,
            summed: tuple = ()) -> None:
    """Both steps' last phase, `train.optimizer`: every leaf's gradient (a
    zero one where the loss did not reach, `state.fill_grads`), summed over
    a job's ranks in one `all_reduce` with the tensors `summed`, one
    optimizer update, then the model's auxiliary update from the forward's
    `out` into the same leaves."""
    with profiling.span("train.optimizer"):
        distributed.all_sum_tensors(state_lib.fill_grads(state) + list(summed))
        state_lib.apply_gradients(state, config)
        if model.apply_aux_update is not None:
            model.apply_aux_update(state.params, out)


def make_train_step(model, config: dict, stats: tuple, device,
                    mesh: mesh_lib.Mesh | None = None):
    """Step `(state, batch, gen) -> losses` over a `Placed` batch (or a host
    batch, placed first): forward with train=True, losses, backward, one
    optimizer update of `state` in place, then the model's auxiliary update
    (batch-norm running statistics) into the same leaves.  The gradients
    stay on the params' `.grad` until the next step.

    On a CUDA device the step is captured into a CUDA graph and replayed
    (`train/graphs.py`), after `graphs.WARMUP` eager calls of its batch
    key; `train_step.slot` is its `graphs.Slot`, and `slot.eager = True`
    makes every call eager (off CUDA it is set).  Every call is one update,
    and the returned losses are the caller's to keep.

    Under a profiler session the step records its spans
    (`utils/profiling.span`): `train.step` (the step span, whose step id is
    `state.step`) around `train.input` (placing, expanding, `zero_grad`; on
    a replay, the copies into the graph's inputs), `train.forward`,
    `train.loss`, `train.backward` and `train.optimizer`; the BLSTM layers
    add theirs (`ops/lstm_train.BiLSTMLayer`).  A replay runs no Python of
    the phases, so it records `train.step` and `train.input` alone.

    With a `mesh` (data shards of this process) or inside a
    `torch.distributed` job the step is sharded (`_sharded_step`); the
    batch is placed on `device`, the mesh's first device."""
    if mesh is not None or distributed.active():
        return _sharded_step(model, config, stats, device, mesh)
    stats_t = _stats_on(stats, device)
    af = int(config["audio_feat_dim"])
    slot = graphs_lib.Slot()
    slot.eager = torch.device(device).type != "cuda"

    def phases(state: state_lib.TrainState, dev: dict, gen) -> dict:
        with profiling.span("train.forward"):
            out = model.forward(state.params, dev, config, stats_t, train=True, gen=gen)
        with profiling.span("train.loss"):
            ldict = model.losses(out, dev, config)
        with profiling.span("train.backward"):
            ldict["loss"].backward()
        _update(model, config, state, out)
        return {k: v.detach() for k, v in ldict.items()}

    def graphed(state, placed: Placed, gen) -> dict:
        return phases(state, step_input(placed, af), gen)

    def off(why: str) -> None:
        """Every later call eager; said once."""
        slot.eager = True
        slot.drop()
        print(f"# train step: CUDA graphs off, every step eager ({why})", flush=True)

    def capture(state, batch: Placed, gen) -> dict:
        try:
            held = graphs_lib.capture(graphed, state, batch, gen)
        except Exception as e:  # e.g. a host read inside the step, which capture refuses
            off(f"capture failed: {type(e).__name__}: {e}")
            state.optimizer.zero_grad(set_to_none=True)
            return graphed(state, batch, gen)
        slot.graph = held
        return held.replay(state)

    def routed(state, batch: Placed, gen):
        """Decide this call's way and ready its input (inside `train.input`);
        returns the rest of the call."""
        how = "eager"
        if not slot.eager:
            key = graphs_lib.graph_key(state, batch.dev, gen,
                                       state_lib.learning_rate(config, state.step))
            if slot.graph is not None and key == slot.key and not slot.graph.holds(state):
                slot.drop()  # the state's tensors were replaced: the key starts anew
            how = slot.route(key)
            why = graphs_lib.uncapturable(state) if how in ("warmup", "capture") else None
            if why:
                off(why)
                how = "eager"
            elif how == "capture" and (profiling.recording() or graphs_lib.unready(state)):
                how = "warmup"  # no capture under a profiler, nor of Adam's first step
        if how == "replay":
            held = slot.graph
            held.load(batch.dev)
            return lambda: held.replay(state)
        if how == "capture":
            return lambda: capture(state, batch, gen)
        dev = step_input(batch, af)
        state.optimizer.zero_grad(set_to_none=True)
        if how == "warmup":
            return lambda: graphs_lib.on_side_stream(phases, device, state, dev, gen)
        return lambda: phases(state, dev, gen)

    def train_step(state: state_lib.TrainState, batch, gen) -> dict:
        with profiling.span("train.step", step=state.step):
            with profiling.span("train.input"):
                if not isinstance(batch, Placed):
                    batch = place(batch, device)
                rest = routed(state, batch, gen)
            return rest()

    train_step.slot = slot
    return train_step


def _generator_like(state: torch.Tensor, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.set_state(state)
    return gen


def _sharded_step(model, config: dict, stats: tuple, device, mesh: mesh_lib.Mesh | None):
    """The data-parallel train step: the global batch's step, computed per
    shard.  The batch (this rank's rows) is split over the mesh's data
    shards (one shard on `device` without a mesh); each shard gathers the
    whole params onto its device and runs forward and losses under its
    `ShardContext` (the global loss denominators, its rows of the global
    dropout mask, each from a copy of `gen` at the step's start, and for
    batch norm the shards in lockstep), and the backward.  The gradients
    and the losses, summed over the shards by autograd, are summed over the
    ranks in one `all_reduce` (`_update`), then the optimizer updates the
    (possibly model-sharded) leaves."""
    shard_devs = mesh.data_devices if mesh is not None else [torch.device(device)]
    stats_on = {d: _stats_on(stats, d) for d in set(shard_devs)}
    af = int(config["audio_feat_dim"])
    lockstep = model.lockstep_shards

    def train_step(state: state_lib.TrainState, batch, gen) -> dict:
        with profiling.span("train.step", step=state.step):
            with profiling.span("train.input"):
                if not isinstance(batch, Placed):
                    batch = place(batch, device)
                dev = step_input(batch, af)
                parts = mesh_lib.split_batch(dev, mesh) if mesh is not None else [dev]
                contexts = mesh_lib.shard_contexts(mesh, len(batch.meta["sequence_lengths"]),
                                                   mesh_lib.batch_totals(dev))
                state.optimizer.zero_grad(set_to_none=True)
                gen_state = gen.get_state() if gen is not None else None
                gens = [None if gen is None else _generator_like(gen_state, d) for d in shard_devs]

            def shard(i: int):
                d = shard_devs[i]
                params = mesh_lib.gather_params(state.params, d)
                with profiling.span("train.forward"):
                    out = model.forward(params, parts[i], config, stats_on[d], train=True,
                                        gen=gens[i])
                with profiling.span("train.loss"):
                    ldict = model.losses(out, parts[i], config)
                if not lockstep:
                    with profiling.span("train.backward"):
                        ldict["loss"].backward()
                return out, ldict

            results = mesh_lib.run_shards(contexts, shard, lockstep)
            if lockstep:
                with profiling.span("train.backward"):
                    torch.stack([ld["loss"].to(device) for _, ld in results]).sum().backward()
            if gen is not None:
                gen.set_state(gens[0].get_state())
            keys = list(results[0][1])
            losses = torch.stack([sum(ld[key].detach().to(device) for _, ld in results)
                                  for key in keys])
            _update(model, config, state, results[0][0], (losses,))
            return dict(zip(keys, losses))

    return train_step


def _eval_outputs(model, config: dict, params, dev: dict, stats_t: tuple, is_asr: bool) -> dict:
    """Per-sample validation results of one expanded batch on one device."""
    out = model.forward(params, dev, config, stats_t, train=False)
    if is_asr:
        return {"loss_ps": ctc_ops.ctc_loss_per_seq(
                    out["logits"], out["logit_lengths"], dev["labels"],
                    dev["labels_lengths"]),
                "decoded": asr_model.decode_greedy(out)}
    total, hole = common.per_sample_losses(out, dev)
    res = {"loss_ps": total, "loss_hole_ps": hole}
    if "asr_logits" in out:
        res["ctc_ps"] = ctc_ops.ctc_loss_per_seq(
            out["asr_logits"], dev["sequence_lengths"], dev["labels"],
            dev["labels_lengths"],
        )
        res["decoded"] = ctc_ops.greedy_decode(out["asr_logits"], dev["sequence_lengths"])
    return res


def make_eval_step(model, config: dict, stats: tuple, device, is_asr: bool = False,
                   mesh: mesh_lib.Mesh | None = None):
    """Step `(params, batch) -> per-sample results` for validation, over a
    `Placed` batch (or a host batch, placed first):
    per-sample L1 losses, and for CTC models the per-sequence CTC loss and
    the greedy decode (per sample, so the host can drop filler rows); an
    ASR model's CTC loss and decode on its logit lengths.  With a `mesh`
    each data shard's rows run on its device and the results are
    concatenated on `device`."""
    devs = mesh.data_devices if mesh is not None else [torch.device(device)]
    stats_on = {d: _stats_on(stats, d) for d in set(devs)}
    af = int(config["audio_feat_dim"])

    @torch.inference_mode()
    def eval_step(params, batch) -> dict:
        if not isinstance(batch, Placed):
            batch = place(batch, device)
        dev = step_input(batch, af)
        if mesh is None:
            return _eval_outputs(model, config, params, dev, stats_on[devs[0]], is_asr)
        res = [_eval_outputs(model, config, mesh_lib.gather_params(params, d), part,
                             stats_on[d], is_asr)
               for d, part in zip(devs, mesh_lib.split_batch(dev, mesh))]
        return {key: mesh_lib.concat([r[key] for r in res], device) for key in res[0]}

    return eval_step


def _host_per(decoded: np.ndarray, meta: dict) -> float:
    dec, labs = [], []
    for i in range(meta["num_real"]):
        dec.append([int(x) for x in decoded[i] if x >= 0])
        ll = int(meta["labels_lengths"][i])
        labs.append([int(x) for x in meta["labels"][i][:ll]])
    return ctc_ops.per_metric(dec, labs)


def _val_batches(dm: DataManager, val_files: list[str], batch_size: int, place_fn,
                 pad_to: int | None = None):
    """The placed batches of one validation pass over `pad_final` batches;
    `meta["num_real"]` marks the rows that count.  pad_to (a job of several
    ranks): every rank runs as many eval steps, so a rank with fewer
    batches repeats its last one with `num_real=0`, which no metric counts."""
    n, last = 0, None
    for batch in dm.batches(val_files, batch_size, pad_final=True):
        last = place_fn(batch)
        n += 1
        yield last
    if pad_to is not None and n < pad_to:
        if last is None:
            raise ValueError("a host's validation shard is empty but other hosts have "
                             "batches — regroup the validation split over the hosts")
        filler = Placed(last.dev, dict(last.meta, num_real=0))
        for _ in range(pad_to - n):
            yield filler


def _validate(val_batches, eval_step, params, select_hole: bool,
              is_asr: bool = False, multihost: bool = False) -> tuple[float, str]:
    """Per-epoch validation over placed batches: a window of batches in
    flight (the device runs ahead while the host reads earlier results),
    filler rows dropped.  Returns (selection metric, report): an ASR
    model's is its PER.  multihost: the sums over this rank's rows are
    summed over the ranks, so every rank reads the same metric."""
    def pipelined(depth=8):
        window: deque = deque()
        for placed in val_batches:
            window.append((placed.meta, eval_step(params, placed)))
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
        if multihost:
            s = distributed.allreduce_sum(
                [np.sum(losses), len(losses), np.sum(pers), np.sum(weights)])
            if s[3] == 0:
                return math.inf, "val=none"
            per = float(s[2] / s[3])
            return per, f"val_loss={s[0] / s[1]:.5f}\tval_per={per:.5f}"
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
    if multihost:
        s = distributed.allreduce_sum([np.sum(tot), len(tot), np.sum(hole),
                                       np.sum(ctcs), np.sum(ctc_w), np.sum(pers)])
        if s[1] == 0:
            return math.inf, "val=none"
        report = f"val_loss={s[0] / s[1]:.5f}\tval_loss_hole={s[2] / s[1]:.5f}"
        if s[4] > 0:
            report += f"\tval_ctc={s[3] / s[4]:.5f}\tval_per={s[5] / s[4]:.5f}"
        return float(s[2] / s[1]) if select_hole else float(s[0] / s[1]), report
    if not tot:
        return math.inf, "val=none"
    report = f"val_loss={np.mean(tot):.5f}\tval_loss_hole={np.mean(hole):.5f}"
    if ctcs:
        report += (f"\tval_ctc={np.sum(ctcs) / np.sum(ctc_w):.5f}"
                   f"\tval_per={np.sum(pers) / np.sum(ctc_w):.5f}")
    metric = float(np.mean(hole)) if select_hole else float(np.mean(tot))
    return metric, report


def _train_mesh(config: dict, device, devices, batch_size: int, multihost: bool):
    """(mesh or None, data-axis size over every rank) of a `train()` run.

    The mesh spans this process's devices (`devices`; by default, this
    rank's device in a job, else every visible card, or the CPU once):
    `num_data_shards` is the reference's global data axis (split over the
    ranks), `num_model_shards` the model axis.  A batch that does not divide
    the data axis leaves the mesh off with a warning, except where a model
    axis or a job needs it (ValueError, as in `avsi/train/loop.py:316-353`)."""
    world = distributed.world_size()
    n_model = int(config.get("num_model_shards", 1))
    if devices is None:
        devices = ([distributed.rank_device(device)] if multihost
                   else mesh_lib.entry_devices(device, 1))
    n_req = int(config.get("num_data_shards", 0) or 0)
    if n_req % world:
        raise ValueError(f"num_data_shards={n_req} must divide over {world} processes")
    mesh = mesh_lib.get_mesh(n_req // world, devices, model_shards=n_model)
    n_data = world * mesh.shape["data"]
    use_mesh = batch_size % n_data == 0 and (multihost or mesh.size > 1)
    if batch_size % n_data and n_model > 1:
        raise ValueError(f"num_model_shards={n_model} requires batch_size divisible by "
                         f"the data axis ({n_data}); got {batch_size}")
    if multihost and batch_size % n_data:
        raise ValueError(f"multi-host training needs the global batch ({batch_size}) "
                         f"divisible by the data axis ({n_data})")
    n_local = len(devices) if devices is not None else len(mesh_lib.visible_cuda_devices())
    if multihost and n_model > 1 and n_local % n_model:
        raise ValueError(f"num_model_shards={n_model} must divide the local device count "
                         f"({n_local}) so tensor-parallel groups never straddle hosts")
    if world * mesh.size > 1 and not use_mesh:
        print(f"WARNING: mesh disabled — batch_size {batch_size} not divisible by "
              f"{n_data} data shards; training runs on one device", flush=True)
    return (mesh if use_mesh and mesh.size > 1 else None), (n_data if use_mesh else 1)


def train(config_file: str, is_asr: bool = False, device=None,
          corpus_cache: dict | None = None, devices=None) -> dict:
    """Train one model per the config file (default device cuda);
    `is_asr` for a standalone ASR model (`registry.ASR_MODELS`).

    devices: this process's mesh devices (see `_train_mesh`); a list may
    repeat a device (`["cpu"] * 4`).  Inside a `torch.distributed` job every
    rank calls `train()` with the same config.

    corpus_cache: a dict shared across `train()` calls in one process.  The
    first call fills it with the device-resident compacted corpus
    ({"train": [Placed], "val": [Placed], "stamp", "complete"}); later calls
    train from it with no reader and no upload (training the SI model and
    its ASR judge on one corpus pays the upload once).  The calls must share
    the corpus, the batch and the shapes (the stamp; another raises), and a
    model that needs embeddings refuses a cache built without them.  A fill
    cut short (NaN abort, SIGTERM) is not marked complete, and the next call
    discards it.

    Returns {"best_val", "best_epoch", "steps", "preempted",
    "step_seconds"}:
    `step_seconds` holds each train step's host time from batch in hand to
    the end of its NaN check, a device time only when `nan_check_every`
    is 1 (the check waits for the step's loss)."""
    config = config_lib.check_trainconfiguration(config_lib.load_configfile(config_file))
    device = resolve_device(device)
    multihost = distributed.active()
    main_host = distributed.is_main()
    exp_folder = config["exp_folder"]
    ckpt_dir = os.path.join(exp_folder, "netmodel")
    os.makedirs(ckpt_dir, exist_ok=True)
    logfile = os.path.join(exp_folder, "training_log.txt") if main_host else None
    batch_size = int(config["batch_size"])
    mesh, n_data = _train_mesh(config, device, devices, batch_size, multihost)
    if mesh is not None:
        device = mesh.grid[0][0]  # the params' and the batches' home

    # self-contained checkpoint dir: config + stats (an ASR model's are
    # 80-bin log-mel stats, never cut to audio_feat_dim), written by rank 0
    feat_dim = None if is_asr else int(config["audio_feat_dim"])
    if main_host:
        stats = checkpoints.write_bundle(ckpt_dir, config_file, config, feat_dim=feat_dim)
        checkpoints.write_meta(ckpt_dir, config)
    else:
        stats = stats_lib.load_stats(config["audio_feat_mean"], config["audio_feat_std"],
                                     feat_dim=feat_dim)
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
    # a job's ranks each read their own file shard and agree on the steps
    # per epoch (the least: a rank with more batches would wait in the
    # gradient all_reduce) and the validation batches (the most: the short
    # ranks pad) before any collective runs
    local_bs, steps_per_epoch, val_pad = batch_size, None, None
    if multihost:
        world = distributed.world_size()
        if batch_size % world:
            raise ValueError(f"batch_size {batch_size} (global) must divide over "
                             f"{world} processes")
        train_files = distributed.shard_files(train_files)
        if val_files:
            val_files = distributed.shard_files(val_files)
        local_bs = batch_size // world
        n_train = sum(count_records(f) for f in train_files)
        n_val = sum(count_records(f) for f in val_files)
        counts = distributed.gather_hosts([n_train // local_bs, -(-n_val // local_bs)])
        steps_per_epoch, val_pad = int(counts[:, 0].min()), int(counts[:, 1].max())
        if steps_per_epoch == 0:
            raise ValueError("a host's training shard holds fewer samples than its local "
                             f"batch ({local_bs}) — regroup the corpus or shrink batch_size")
    cache = _CorpusCache(config, corpus_cache, local_bs, model, n_data)

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
    if mesh is not None:
        state = mesh_lib.shard_state(state, mesh)

    config["lstm_impl"] = lstm_fused.resolve_impl(
        config.get("lstm_impl"), device, config["net_dim"], blstm_lib.dtypes(config)[0])
    train_step = make_train_step(model, config, stats, device, mesh=mesh)
    eval_step = make_eval_step(model, config, stats, device, is_asr, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(seed)  # dropout masks

    def place_batch(batch) -> Placed:
        placed = place(batch, device)
        if multihost:
            # the compaction falls back per batch on what the data holds: a
            # rank that compacts a batch the others do not must fail here,
            # on every rank, not hang a collective later
            distributed.assert_uniform("batch compaction signature", ",".join(
                f"{k}:{v.dtype}" for k, v in sorted(placed.dev.items())))
        return placed

    header = " | ".join(f"{k}={config[k]}" for k in (
        "model", "net_dim", "batch_size", "optimizer_type", "starter_learning_rate",
        "dropout_rate", "max_n_epochs", "n_earlystop_epochs",
    ))
    _log(logfile, f"# {header}")
    _log(logfile, f"# device={device} lstm_impl={config['lstm_impl']}")
    if mesh is not None or multihost:
        _log(logfile, f"# mesh={mesh} processes={distributed.world_size()} "
                      f"backend={distributed.backend()} steps/epoch={steps_per_epoch}")

    select_hole = bool(model.spec and model.spec.loss_on_hole_only)
    nan_check_every = int(config.get("nan_check_every", 100))
    log_every = max(200, nan_check_every)
    tb = SummaryWriter(os.path.join(exp_folder, "tb")) if main_host else _NullTB()
    media = _TBMedia(model, config, stats, device, dm, val_files) if (
        not is_asr and val_files and int(config.get("tb_media", 1)) and not multihost) else None
    profiler = _StepProfiler(int(config.get("profile_steps", 0)) if main_host else 0,
                             os.path.join(exp_folder, "profile"), device, logfile)
    best_val, best_epoch, cneg_epochs = math.inf, -1, 0
    step = start_step
    step_seconds: list[float] = []
    with _preemption_flag() as preempt:
        try:
            for epoch in range(int(config["max_n_epochs"])):
                t_epoch = time.time()
                loss_accum, n_acc = None, 0
                from_cache = cache.on and (epoch > 0 or cache.prefilled)
                filling = cache.on and not from_cache
                if from_cache:
                    train_iter = cache.epoch()
                else:
                    train_iter = dm.prefetch_batches(train_files, local_bs, shuffle=True,
                                                     drop_remainder=True)
                    if steps_per_epoch is not None:
                        train_iter = itertools.islice(train_iter, steps_per_epoch)
                for batch in train_iter:
                    t_step = time.perf_counter()
                    profiler.before(step - start_step)
                    placed = batch if from_cache else place_batch(batch)
                    if filling:
                        cache.train.append(placed)
                    ldict = train_step(state, placed, gen)
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
                    if multihost:
                        # act on a flag the ranks agree on, at a fixed
                        # cadence: SIGTERM reaches ranks at different steps,
                        # and a rank that broke alone would leave the others
                        # waiting in the next step's all_reduce
                        if step % 10 == 0:
                            preempt["hit"] = bool(
                                distributed.gather_hosts([float(preempt["hit"])]).max())
                        else:
                            continue
                    if preempt["hit"]:
                        break
                if multihost:
                    # a flag raised after the last cadence point of the epoch
                    preempt["hit"] = bool(distributed.gather_hosts([float(preempt["hit"])]).max())
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

                val_batches = _val_batches(dm, val_files, local_bs, place_batch, pad_to=val_pad)
                if from_cache:
                    val_batches = cache.val
                elif filling:
                    cache.val[:] = val_batches
                    val_batches = cache.val
                val_metric, val_report = _validate(val_batches, eval_step,
                                                   mesh_lib.gather_tree(state.params),
                                                   select_hole, is_asr, multihost)
                if filling and cache.train:
                    _log(logfile, cache.filled())
                if not val_files:
                    # no validation split: every epoch "improves", so the best
                    # checkpoint tracks the latest params
                    val_metric = -float(epoch)
                dt = time.time() - t_epoch
                for k, v in tr.items():
                    tb.scalar(f"train/{k}", v, epoch)
                tb.scalar("val/metric", val_metric, epoch)
                tb.scalar("train/epoch_time_s", dt, epoch)
                if media is not None and main_host:
                    media.write(tb, mesh_lib.gather_tree(state.params), epoch)
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


class _CorpusCache:
    """The device-resident corpus of one `train()` call (the reference's
    `device_cache_corpus`, `avsi/train/loop.py:436-488`): on when the config
    asks for it and trains more than one epoch, or when the caller shares a
    `corpus_cache` dict; `prefilled` when a previous call filled that dict."""

    def __init__(self, config: dict, shared: dict | None, batch_size: int, model,
                 n_data: int = 1):
        self.on = (bool(int(config.get("device_cache_corpus", 0)))
                   and int(config["max_n_epochs"]) > 1) or shared is not None
        self.shared = shared
        if shared is None:
            self.train, self.val = [], []
        else:
            self.train = shared.setdefault("train", [])
            self.val = shared.setdefault("val", [])
            # the parameters the batches were built under: another corpus or
            # geometry must not train on this one's batches
            stamp = {
                "root_folder": os.path.abspath(str(config["root_folder"])),
                "batch_size": batch_size,
                "audio_len": int(config["audio_len"]),
                "audio_feat_dim": int(config["audio_feat_dim"]),
                "video_feat_dim": int(config["video_feat_dim"]),
                # the resolved data axis: batches placed for another mesh
                # geometry must not be reused
                "mesh_data_axis": n_data,
            }
            prev = shared.setdefault("stamp", stamp)
            if prev != stamp:
                raise ValueError(f"shared corpus_cache was built for {prev} but this train() "
                                 f"call uses {stamp} — use a separate cache")
            if self.train and not shared.get("complete"):
                # a fill cut short in epoch 0 holds part of the corpus
                self.train.clear()
                self.val.clear()
        self.prefilled = bool(self.train)
        if self.prefilled and model.needs_embeddings and "embeddings" not in self.train[0].dev:
            raise ValueError(f"shared corpus_cache was built without speaker embeddings but "
                             f"model {config['model']} needs them — use a separate cache")
        self.rng = np.random.default_rng(int(config.get("seed", 0)) + 101)

    def epoch(self):
        """The cached training batches in a fresh random order."""
        return (self.train[i] for i in self.rng.permutation(len(self.train)))

    def filled(self) -> str:
        """Mark a shared cache complete (epoch 0 streamed the whole corpus
        and validation cached its batches); the log line of what it holds."""
        if self.shared is not None:
            self.shared["complete"] = True
        nbytes = sum(t.nbytes for p in self.train + self.val for t in p.dev.values())
        return (f"# corpus cache: {len(self.train)} train + {len(self.val)} val batches, "
                f"{nbytes / 2**30:.2f} GB in HBM")


class _StepProfiler:
    """`profile_steps = n`: a `profiling.Session` trace of steps 3..3+n of
    the run (counted from its first step) into `logdir` as a Chrome trace
    (`trace.json`: the host, the device's kernels and the steps' spans); a
    run that ends inside the window writes what it has and logs a partial
    trace."""

    FIRST = 3

    def __init__(self, n_steps: int, logdir: str, device, logfile: str):
        self.n_steps, self.logdir, self.device, self.logfile = n_steps, logdir, device, logfile
        self.prof = None

    def before(self, done: int) -> None:
        if self.n_steps and done == self.FIRST and self.prof is None:
            os.makedirs(self.logdir, exist_ok=True)
            self.prof = profiling.Session(self.device).start()

    def after(self, done: int) -> None:
        if self.prof is not None and done == self.FIRST + self.n_steps:
            self._stop()
            self.n_steps = 0
            _log(self.logfile, f"# profiler trace written to {self.logdir}")

    def _stop(self) -> None:
        self.prof.stop(os.path.join(self.logdir, "trace.json"))
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
        self.batch = step_input(place(batch, device, compact=False),
                                int(config["audio_feat_dim"]))

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
