"""The single-device train step as a CUDA graph, captured once and
replayed (`train/loop.make_train_step`).

A step holds one graph at most, in its `Slot`, and a call of the step on a
CUDA device goes one of four ways:

  * "warmup": the first `WARMUP` calls of a key run eagerly on a side
    stream, as `torch.cuda.graph` requires (lazy initialisation, Adam's
    state, the kernels' attributes, all happen outside any capture);
  * "capture": the next call copies the batch into static buffers,
    captures the whole step from them (the batch's expansion, forward,
    losses, backward, the zero-fill of grads the loss does not reach, the
    optimizer update and the auxiliary update) into a `torch.cuda.CUDAGraph`
    and replays it once, so that the call is one real update like the
    others;
  * "replay": later calls of that key copy the batch's device tensors into
    the static buffers (`copy_`, device to device) and replay the graph;
  * "eager": every call of another key once the graph is held, and every
    call of a step whose slot is `eager`: the eager twin the tests hold
    replays against, a step whose capture failed or whose optimizer cannot
    be captured (each logged once), and a step off CUDA.  A call due for
    capture while a profiler session records, or before Adam's state
    exists, is one more warm-up.

Until the graph is held the slot follows the key of the latest call: a
call of another key starts the warm-ups over.  `train()` batches with
`drop_remainder` and compacts the batches of a corpus alike
(`parallel.mesh.compact_batch`), so it gives one key, as the benchmark's
cell does; a batch whose waves keep float32 among int16 ones would be a
second key, and runs eagerly.

The key (`graph_key`) holds what the captured step reads from the host:
the placed tensors' names, shapes and dtypes, the learning rate (which
the capture records as a constant; Adam's never changes), and the train
state and the dropout generator by identity.  The step reads none of the
batch's host meta.  A graph also holds the identities of the tensors it
reads and writes (the params, Adam's moments and count); a call that
finds them changed (a reloaded optimizer state) drops the graph and
starts the key anew.

A replay makes no host sync.  It counts the hand-written kernels it runs
into `ops._build.launch_counts`, as many as the capture recorded (the
capture's own host calls ran nothing and are taken back out), so the
counts keep meaning launches run on the device.  The returned losses are
a fresh clone of the graph's static losses, which the next replay
overwrites.
"""

from __future__ import annotations

import dataclasses

import torch

from avsi_torch.ops import _build

WARMUP = 2  # eager calls of a key before its capture


def graph_key(state, dev: dict, gen, rate: float) -> tuple:
    """What a captured step reads from the host besides its tensors."""
    return (id(state), id(gen), rate,
            tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(dev.items())))


class Slot:
    """A step's one graph (`graph`, a `Captured`, or None), the key it
    serves and that key's warm-ups so far; `eager` sends every call eager.
    Plain Python: it runs and is tested without a device."""

    def __init__(self):
        self.eager = False
        self.key = None
        self.graph = None
        self.calls = 0

    def route(self, key) -> str:
        """"replay", "capture", "warmup" or "eager" for this call of `key`."""
        if self.eager:
            return "eager"
        if self.graph is not None:
            return "replay" if key == self.key else "eager"
        if key != self.key:
            self.key, self.calls = key, 0
        if self.calls >= WARMUP:
            return "capture"
        self.calls += 1
        return "warmup"

    def drop(self) -> None:
        """Forget the graph: its key warms up anew."""
        self.graph, self.calls = None, 0


def _leaves(state) -> list:
    return [p for g in state.optimizer.param_groups for p in g["params"]]


def _bound(state) -> tuple:
    """The tensors a captured step reads and writes, in a fixed order."""
    opt = state.optimizer.state
    out = []
    for p in _leaves(state):
        s = opt.get(p, {})
        out += [p, s.get("exp_avg"), s.get("exp_avg_sq"), s.get("step")]
    return tuple(out)


def uncapturable(state) -> str | None:
    """Why `state`'s optimizer cannot run inside a graph, or None."""
    opt = state.optimizer
    if not opt.defaults.get("capturable"):
        return f"{type(opt).__name__} is not capturable"
    return None


def unready(state) -> bool:
    """True until every leaf has its Adam state: a capture must not create
    it (the zero fill would be recorded and replayed)."""
    opt = state.optimizer.state
    return any("exp_avg" not in opt.get(p, {}) for p in _leaves(state))


@dataclasses.dataclass
class Captured:
    graph: torch.cuda.CUDAGraph
    inputs: dict  # static copies of the placed tensors
    names: tuple  # the losses' names, in the order of `losses`
    losses: torch.Tensor  # the step's losses, stacked by the graph
    grads: list  # (leaf, its grad in the graph's pool)
    bound: tuple  # `_bound(state)` at capture
    launches: dict  # hand-written kernel launches of one replay
    refs: tuple  # the state and generator the key names by identity

    def holds(self, state) -> bool:
        now = _bound(state)
        return len(now) == len(self.bound) and all(a is b for a, b in zip(now, self.bound))

    def load(self, dev: dict) -> None:
        for k, v in dev.items():
            self.inputs[k].copy_(v)

    def replay(self, state) -> dict:
        self.graph.replay()
        for name, n in self.launches.items():
            _build.launch_counts[name] += n
        for p, g in self.grads:  # the gradients stay on `.grad`, as after an eager step
            if p.grad is not g:
                p.grad = g
        state.step += 1
        return dict(zip(self.names, self.losses.clone().unbind()))


def capture(phases, state, batch, gen) -> Captured:
    """Capture `phases(state, placed, gen) -> losses` on static copies of
    the `Placed` batch's tensors; the graph is not replayed yet, and the
    state is left as it was (the capture ran nothing)."""
    inputs = {k: v.clone() for k, v in batch.dev.items()}
    graph = torch.cuda.CUDAGraph()
    if gen is not None:
        graph.register_generator_state(gen)
    state.optimizer.zero_grad(set_to_none=True)  # the backward allocates the grads in the pool
    before, count = dict(_build.launch_counts), state.step
    # `torch.cuda.graph` would first empty the device's and the pinned host
    # memory's caches: 1.2-1.5 s once a placed corpus has gone through the
    # pinned cache.  The capture itself is the same: a side stream, "global".
    device = next(iter(inputs.values())).device
    main, side = torch.cuda.current_stream(device), torch.cuda.Stream(device)
    torch.cuda.synchronize(device)
    side.wait_stream(main)
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="global")
            try:
                ldict = phases(state, dataclasses.replace(batch, dev=inputs), gen)
                names = tuple(ldict)
                losses = torch.stack([ldict[k] for k in names])
            finally:
                graph.capture_end()
    finally:
        main.wait_stream(side)
        state.step = count
        launches = {k: v - before.get(k, 0) for k, v in _build.launch_counts.items()
                    if v != before.get(k, 0)}
        for name, n in launches.items():  # recorded, not run
            _build.launch_counts[name] -= n
    grads = [(p, p.grad) for p in _leaves(state)]
    return Captured(graph, inputs, names, losses, grads, _bound(state), launches, (state, gen))


def on_side_stream(fn, device, *args):
    """`fn(*args)` on a side stream that waits for the current one, which
    then waits for it (the warm-ups `torch.cuda.graph` asks for)."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn(*args)
    main.wait_stream(side)
    return out
