"""Training traffic: `train()`'s step on a device-resident corpus.

Set-up draws the corpus (`lib/corpus.py`) and the weights from the seed,
places every batch with the port's `train.loop.place` (compacted on the
host, uploaded: the `device_cache_corpus` form), builds the train state
(`train.state.create_train_state`) and the step (`train.loop.make_train_step`),
and drives that step through its first `checked_steps` steps, then
`warmup_steps` more.  The window goes on with the same state: batches in a
seeded order each epoch, the loss read at `train()`'s NaN-check cadence,
and a synchronise at the end.  `train_utt_per_s` is the utterances of every
step launched in the window over the window's seconds; the memory peak is
the window's (the corpus held on the device, the state and the steps).

`correct`: the reference follows the checked steps from the same weights
on the same rows; each step's loss, the first gradient (the program's read
from Adam's first moment after one step) and the change of the parameters
after them are compared leaf by leaf (`reference/training.py`).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from perfbench.lib import corpus as corpus_lib
from perfbench.lib import weights
from perfbench.lib.devtrace import DeviceTrace
from perfbench.lib.outcome import Outcome, Run
from perfbench.lib.spec import reference_module
from perfbench.reference.arith import Arith
from perfbench.reference.training import B1, adam_steps, compare


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def plan(seed: int, traffic: dict):
    """(the batches' rows (n_batches, batch), the generator of each epoch's
    order of batches)."""
    batch = int(traffic["batch"])
    n_batches = traffic["corpus_utterances"] // batch
    groups = np.random.default_rng([seed, 2]).permutation(n_batches * batch)
    return groups.reshape(n_batches, batch), np.random.default_rng([seed, 3])


def run(r: Run) -> Outcome:
    from avsi_torch import config as config_lib
    from avsi_torch.device import resolve_device
    from avsi_torch.models import blstm as blstm_lib
    from avsi_torch.models import registry
    from avsi_torch.ops import lstm_fused
    from avsi_torch.train import loop as train_loop
    from avsi_torch.train import state as state_lib

    m, geo, tr = r.config["model"], r.config["geometry"], r.traffic
    dev = resolve_device(r.device)  # as train() does: on the card, TF32 off
    ref = reference_module(r.config)
    bins, batch = int(m["audio_feat_dim"]), int(tr["batch"])

    mark = lambda: round(time.perf_counter() - r.t0, 3)  # noqa: E731
    phases = {"imports": mark()}
    corpus = corpus_lib.draw(r.seed, m, geo, tr, dev)
    phases["corpus"] = mark()
    groups, order_rng = plan(r.seed, tr)
    n_batches = len(groups)
    placed = [train_loop.place(corpus_lib.host_batch(corpus, g, bins), dev) for g in groups]
    phases["placed"] = mark()
    flat = weights.draw(ref.param_shapes(m), r.seed, dev)
    init = {k: v.detach().clone() for k, v in flat.items()}
    mean, std = weights.stats(r.seed, bins, r.config["stats"])
    cfg = config_lib.check_trainconfiguration(dict(
        m, root_folder=r.tmp, exp_folder=r.tmp, audio_feat_mean="", audio_feat_std="",
        batch_size=batch, max_n_epochs=1, n_earlystop_epochs=1))
    cfg["lstm_impl"] = lstm_fused.resolve_impl(None, dev, cfg["net_dim"], blstm_lib.dtypes(cfg)[0])
    model = registry.get_model(cfg["model"])
    state = state_lib.create_train_state(weights.nest(flat), cfg)
    step = train_loop.make_train_step(model, cfg, (mean, std), dev)
    gen = torch.Generator(device=dev).manual_seed(r.seed % 2 ** 63)

    order = list(order_rng.permutation(n_batches))
    checked = int(tr["checked_steps"])
    checked_rows = [groups[order[k]] for k in range(checked)]
    losses, grad1, change = [], {}, {}
    for k in range(checked + int(tr["warmup_steps"])):
        ldict = step(state, placed[order[k]], gen)
        if k < checked:
            losses.append(ldict["loss"])
        if k == 0:
            # the first gradient as Adam took it: its first moment after one
            # step is (1 - b1) g (a leaf with no moment took none)
            opt = state.optimizer.state
            grad1 = {key: float(opt[v]["exp_avg"].norm()) / (1 - B1) if "exp_avg" in opt.get(v, {})
                     else 0.0 for key, v in flat.items()}
        if k == checked - 1:
            change = {key: float((v.detach() - init[key]).norm()) for key, v in flat.items()}
    prog = {"losses": [float(x) for x in losses], "grad1": grad1, "change": change}
    done = checked + int(tr["warmup_steps"])
    _sync(dev)
    phases["first_steps"] = mark()
    if dev.type == "cuda":  # the peak of the window, not of drawing the corpus
        torch.cuda.reset_peak_memory_stats(dev)

    # the window
    nan_every = int(tr["nan_check_every"])
    trace_at, trace_len = tr["trace_part_s"]
    tracer = DeviceTrace(dev)
    trace, phase, steps, traced_from = None, "before", 0, 0
    t_start = time.perf_counter()
    setup_s = t_start - r.t0
    while True:
        if done % n_batches == 0:
            order = list(order_rng.permutation(n_batches))
        ldict = step(state, placed[order[done % n_batches]], gen)
        done += 1
        steps += 1
        if steps % nan_every == 0 and not math.isfinite(float(ldict["loss"])):
            raise FloatingPointError(f"non-finite loss at window step {steps}")
        now = time.perf_counter() - t_start
        # the traced part: at least one step, closed before the window is
        if r.trace and phase == "before" and (now >= trace_at or now >= r.seconds):
            tracer.start()
            phase, traced_from = "on", steps
        elif phase == "on" and (now >= trace_at + trace_len or now >= r.seconds):
            trace, phase, traced_steps = tracer.stop(), "done", steps - traced_from
        if now >= r.seconds and phase != "on":
            break
    _sync(dev)
    window_s = time.perf_counter() - t_start

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state, step, placed, ldict, flat
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    batches = [corpus_lib.ref_batch(corpus, rows, dev) for rows in checked_rows]
    ref_stats = tuple(torch.from_numpy(s).to(dev) for s in (mean, std))
    want = adam_steps(ref, Arith(), init, batches, m, geo, ref_stats)
    nums, why = compare(prog, want)
    limits = r.config["limits"]["train"]
    frames = corpus["frames_per_utt"]
    return Outcome(
        attempted=steps, failed=0,
        e2e={"train_utt_per_s": steps * batch / window_s, "setup_s": setup_s},
        checks={k: (v, limits[k]) for k, v in nums.items() if k in limits},
        memory_peak_bytes=peak,
        layer={"trace": trace, "traced_steps": traced_steps if trace else 0, "batch": batch,
               # the window's seconds of training: less the reading of the trace
               "window_s": window_s - (trace.reading_s if trace else 0.0),
               "utterances": steps * batch,
               "flops_per_utt": ref.train_flops(m, geo, frames), "model": m, "frames": frames},
        notes={"steps": steps, "window_s": window_s, "setup_s": setup_s, "setup_phases": phases,
               "losses_program": prog["losses"], "losses_reference": want["losses"],
               "readings": nums, **why},
    )
