"""Device mesh, data-parallel sharding and model-axis storage (port of
`avsi/parallel/mesh.py`).

A `Mesh` is an in-process grid of torch devices that plays the part of
`jax.sharding.Mesh`: a `data` axis, and with `model_shards > 1` a `model`
axis.  Where JAX's GSPMD partitions one program, the port runs the
single-device code once per data shard:

* a batch is split along `data` (`split_batch`), each shard's rows on its
  own device (the first device of its model group), and the per-sample
  results are concatenated back (`concat`);
* params are replicated to every data shard (`replicate`; a shard on the
  params' own device takes the tensors themselves, so a mesh that repeats
  one device costs no copy);
* on a `(data, model)` mesh, `shard_state` stores every leaf that
  `param_spec` splits as a `ModelShards` (piece j on model device j), with
  its optimizer state split alike.  Each data shard gathers the whole
  leaves onto its device before its forward (`gather_params`, a
  differentiable concatenation, so each piece takes its slice of the
  gradient), and the optimizer's elementwise update runs on the pieces.
  `gather_state` is the inverse: whole leaves and whole optimizer state.

The losses and batch statistics of a sharded train step are those of the
global batch.  A step runs each shard under a `ShardContext`
(`shard_context()` reads it): its rows of the global batch, the global
loss denominators (`batch_total`, `batch_mean`), and `all_sum`, a
differentiable sum over every shard of the step (the shards of this
process, then the ranks of a `torch.distributed` job).  Batch norm reads
its moments through `all_sum`, which needs the shards in lockstep:
`run_shards(lockstep=True)` runs them in threads that meet at each sum.
Dropout draws the global batch's mask and keeps the shard's rows.

The mesh takes the devices it is given.  `get_mesh` without `devices`
takes every visible CUDA device once; a repeated device (`["cpu"] * 8`,
`[cuda:0, cuda:0]`) is only ever the caller's choice.

`compact_batch` / `expand_batch` are the host-side batch compaction and
its inverse on the device, as in the reference (`mesh.py:123-178`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from avsi_torch.parallel import distributed

# batch keys carried to the device; anything else (sample_paths, num_real) is host-only
DEVICE_BATCH_KEYS = ("sequence_lengths", "labels_lengths", "target_sources", "labels",
                     "video_features", "masks", "mask_frames", "embeddings")


class Mesh:
    """A (data, model) grid of torch devices; `grid[i][j]` is data shard
    i's model device j.  `shape` maps each axis name to its size."""

    def __init__(self, grid: list[list[torch.device]], axis_names: tuple[str, ...]):
        self.grid = [[torch.device(d) for d in row] for row in grid]
        self.axis_names = axis_names
        self.shape = {"data": len(self.grid)}
        if "model" in axis_names:
            self.shape["model"] = len(self.grid[0])

    @property
    def size(self) -> int:
        return sum(len(row) for row in self.grid)

    @property
    def data_devices(self) -> list[torch.device]:
        """Where each data shard computes: the first device of its model group."""
        return [row[0] for row in self.grid]

    @property
    def model_devices(self) -> list[torch.device]:
        """Where the model-axis pieces of a sharded state live."""
        return list(self.grid[0])

    def __repr__(self) -> str:
        axes = "x".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({axes}, {[[str(d) for d in row] for row in self.grid]})"


def visible_cuda_devices() -> list[torch.device]:
    """Every visible CUDA device, once each."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def get_mesh(num_shards: int = 0, devices=None, model_shards: int = 1) -> Mesh:
    """1-D `data` mesh, or 2-D `(data, model)` when model_shards > 1.

    `num_shards` is the DATA-axis size (0 = as many as fit); the device
    count used is data * model.  `devices` defaults to every visible CUDA
    device; a list may repeat a device.  Asking for more than there are
    raises ValueError."""
    if devices is None:
        devices = visible_cuda_devices()
        if not devices:
            raise RuntimeError("get_mesh: no CUDA device is visible; pass devices "
                               "(e.g. ['cpu'] * n) to build a mesh on the CPU")
    devices = [torch.device(d) for d in devices]
    m = max(1, int(model_shards))
    if m == 1:
        n = num_shards if num_shards > 0 else len(devices)
        if n > len(devices):
            raise ValueError(f"mesh needs {n} data shards, have {len(devices)} devices")
        return Mesh([[d] for d in devices[:n]], ("data",))
    n_data = num_shards if num_shards > 0 else max(1, len(devices) // m)
    total = n_data * m
    if total > len(devices):
        raise ValueError(f"mesh {n_data}x{m} needs {total} devices, have {len(devices)}")
    return Mesh([devices[i * m:(i + 1) * m] for i in range(n_data)], ("data", "model"))


def entry_devices(device, n: int):
    """The `devices` of an entry point's n-shard data mesh when it runs on
    `device`: the CPU n times (the CPU is one device that the port splits,
    as JAX's virtual host devices do), or None on CUDA, which makes
    `get_mesh` take each visible card once."""
    return [torch.device("cpu")] * n if torch.device(device).type == "cpu" else None


# ------------------------------------------------------------ batches


def shard_slices(n_rows: int, n_shards: int) -> list[slice]:
    """Each data shard's rows of an n_rows batch; the batch must divide."""
    if n_rows % n_shards:
        raise ValueError(f"a batch of {n_rows} rows does not divide over {n_shards} data shards")
    per = n_rows // n_shards
    return [slice(i * per, (i + 1) * per) for i in range(n_shards)]


def _rows(batch: dict) -> int:
    return next(len(v) for v in batch.values() if getattr(v, "ndim", 0) > 0)


def split_batch(batch: dict, mesh: Mesh) -> list[dict]:
    """A batch of tensors (and host numpy arrays) -> one dict per data
    shard: its rows, its tensors on its device (a view where the shard
    computes on the batch's device)."""
    devices = mesh.data_devices
    parts = []
    for dev, rows in zip(devices, shard_slices(_rows(batch), len(devices))):
        parts.append({k: v[rows].to(dev, non_blocking=True) if isinstance(v, torch.Tensor)
                      else v[rows] for k, v in batch.items()})
    return parts


def concat(parts: list[torch.Tensor], device) -> torch.Tensor:
    """Per-shard results with a leading batch axis -> one tensor on `device`."""
    return torch.cat([p.to(device) for p in parts])


# ------------------------------------------------------------ params and state


class ModelShards:
    """One parameter leaf stored as its `param_spec` pieces along `axis`,
    piece j on the mesh's model device j."""

    def __init__(self, pieces: list[torch.Tensor], axis: int):
        self.pieces, self.axis = pieces, axis

    @property
    def shape(self) -> torch.Size:
        shape = list(self.pieces[0].shape)
        shape[self.axis] = sum(p.shape[self.axis] for p in self.pieces)
        return torch.Size(shape)

    @property
    def device(self) -> torch.device:
        return self.pieces[0].device

    @property
    def requires_grad(self) -> bool:
        return self.pieces[0].requires_grad

    def gather(self, device) -> torch.Tensor:
        """The whole leaf on `device`; differentiable, so each piece takes
        its slice of the gradient."""
        return torch.cat([p.to(device) for p in self.pieces], self.axis)

    @torch.no_grad()
    def copy_(self, whole: torch.Tensor) -> "ModelShards":
        """Write a whole tensor into the pieces (the U-Nets' running batch
        statistics after an update)."""
        for piece, part in zip(self.pieces, whole.chunk(len(self.pieces), self.axis)):
            piece.copy_(part)
        return self


def tree_map(fn, tree):
    """`fn` over the leaves of nested dicts/lists (a `ModelShards` is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def replicate(tree, mesh: Mesh) -> list:
    """The params on each data shard's device (the tensors themselves on
    their own device), one tree per data shard."""
    return [gather_params(tree, dev) for dev in mesh.data_devices]


def gather_params(tree, device):
    """Whole leaves on `device`: model-axis pieces concatenated, the rest
    moved.  Differentiable: under autograd the gradients reach the stored
    leaves and pieces."""
    return tree_map(lambda leaf: leaf.gather(device) if isinstance(leaf, ModelShards)
                    else leaf.to(device), tree)


@torch.no_grad()
def gather_tree(tree):
    """Whole leaves, each on its (first) storage device, detached."""
    return tree_map(lambda leaf: leaf.gather(leaf.device) if isinstance(leaf, ModelShards)
                    else leaf.detach(), tree)


def param_spec(shape, n_model: int) -> int | None:
    """The axis a parameter-shaped leaf is split along over `model`, or
    None (replicated): the LAST axis when it divides evenly (LSTM gate dims
    4H, dense output dims), else the contraction axis of a matrix whose
    output dim does not divide (the 257-bin head (2H, 257)); scalars and
    small or indivisible leaves stay whole.  The reference's rule
    (`avsi/parallel/mesh.py:86-101`)."""
    shape = tuple(shape)
    if not shape:
        return None
    if shape[-1] % n_model == 0 and shape[-1] >= 2 * n_model:
        return len(shape) - 1
    if len(shape) >= 2 and shape[-2] % n_model == 0 and shape[-2] >= 2 * n_model:
        return len(shape) - 2
    return None


def _restate(state, make):
    """`state` with each param leaf replaced by `make(leaf)` -> (new leaf,
    its new optimizer leaves, convert), where `convert` maps one optimizer
    slot's tensors of the old optimizer leaves to those of the new ones.
    The optimizer is rebuilt over the new leaves with the same groups and
    hyperparameters; 0-d state (Adam's step) is copied to each."""
    old_opt = state.optimizer
    owner: dict[int, tuple] = {}

    def conv(leaf):
        new, news, convert = make(leaf)
        olds = leaf.pieces if isinstance(leaf, ModelShards) else [leaf]
        for o in olds:
            owner[id(o)] = (olds, news, convert)
        return new

    params = tree_map(conv, state.params)
    groups, new_state = [], {}
    for group in old_opt.param_groups:
        leaves, seen = [], set()
        for p in group["params"]:
            olds, news, convert = owner[id(p)]
            if id(olds[0]) in seen:
                continue
            seen.add(id(olds[0]))
            leaves.extend(news)
            slots = [old_opt.state.get(o, {}) for o in olds]
            if not slots[0]:
                continue
            per = [{} for _ in news]
            for key, v0 in slots[0].items():
                if torch.is_tensor(v0) and v0.dim() > 0:
                    parts = convert([s[key] for s in slots])
                else:
                    parts = [v0.to(n.device, copy=True) if torch.is_tensor(v0) else v0
                             for n in news]  # an Adam count stays beside its leaf
                for d, part in zip(per, parts):
                    d[key] = part
            new_state.update(zip(news, per))
        groups.append(dict(group, params=leaves))
    opt = type(old_opt)(groups)
    for leaf, slot in new_state.items():
        opt.state[leaf] = slot
    return dataclasses.replace(state, params=params, optimizer=opt)


def shard_state(state, mesh: Mesh):
    """Place a `TrainState` on the mesh (a new state; `state` is left as it
    was).  A 1-D data mesh keeps every leaf whole on its first device; a
    `(data, model)` mesh stores each leaf that `param_spec` splits as a
    `ModelShards`, with its optimizer state split alike."""
    home = mesh.model_devices
    n_model = int(mesh.shape.get("model", 1))
    leaves = tree_leaves(state.params)
    if n_model == 1 and all(isinstance(x, torch.Tensor) and x.device == home[0] for x in leaves):
        return state

    def make(leaf):
        if isinstance(leaf, ModelShards):
            raise ValueError("shard_state: the state is model-sharded already")
        axis = param_spec(leaf.shape, n_model) if n_model > 1 else None
        if axis is None:
            new = leaf.detach().to(home[0]).requires_grad_(leaf.requires_grad)
            return new, [new], lambda ts: [ts[0].to(home[0])]
        pieces = [c.to(d).clone().requires_grad_(leaf.requires_grad)
                  for c, d in zip(leaf.detach().chunk(n_model, axis), home)]
        return (ModelShards(pieces, axis), pieces,
                lambda ts: [c.to(d).clone() for c, d in zip(ts[0].chunk(n_model, axis), home)])

    return _restate(state, make)


def gather_state(state):
    """The inverse of `shard_state` on a model axis: a `TrainState` of whole
    leaves (each on its first piece's device) and whole optimizer state;
    `state` itself when nothing is model-sharded."""
    if not any(isinstance(x, ModelShards) for x in tree_leaves(state.params)):
        return state

    def make(leaf):
        if not isinstance(leaf, ModelShards):
            return leaf, [leaf], lambda ts: ts
        whole = torch.cat([p.detach().to(leaf.device) for p in leaf.pieces], leaf.axis)
        whole.requires_grad_(leaf.requires_grad)
        return whole, [whole], lambda ts: [torch.cat([t.to(leaf.device) for t in ts], leaf.axis)]

    return _restate(state, make)


# ------------------------------------------------------------ shard context


@dataclasses.dataclass
class ShardContext:
    """What one data shard's forward and losses read in a sharded step."""

    rows: slice  # this shard's rows of the global batch (every rank's rows)
    global_rows: int
    totals: dict  # the global batch's loss denominators (`batch_totals`)
    index: int = 0  # the shard's index in this process
    n_local: int = 1  # the shards of this process
    collective: "_Lockstep | None" = None

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum of `t` over every shard of the step: this
        process's shards (in lockstep), then the ranks."""
        if self.collective is not None:
            return self.collective.all_sum(self.index, t)
        if self.n_local > 1:
            raise RuntimeError("a batch statistic over shards needs the shards in lockstep "
                               "(run_shards(lockstep=True))")
        return distributed.all_sum_differentiable(t)


_local = threading.local()


def shard_context() -> ShardContext | None:
    """The context of the shard this thread runs, or None outside a sharded step."""
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def use_shard(ctx: ShardContext):
    prev = shard_context()
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


def batch_totals(batch: dict) -> dict:
    """The loss denominators of a (local, expanded) batch, summed over the
    ranks: the mask's sum and the hole's.  They do not depend on the
    params, so a step takes them before its forward."""
    m = batch["masks"]
    both = distributed.all_sum(torch.stack([torch.sum(m), torch.sum(1 - m)]))
    return {"mask": both[0], "hole": both[1]}


def batch_total(name: str, local: torch.Tensor) -> torch.Tensor:
    """`local` (this batch's denominator `name`), or under a sharded step
    the global batch's."""
    ctx = shard_context()
    return local if ctx is None else ctx.totals[name].to(local.device)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """`x.mean()`, or under a sharded step this shard's share of the global
    batch's mean (its sum over the global element count)."""
    ctx = shard_context()
    if ctx is None:
        return x.mean()
    local_rows = ctx.rows.stop - ctx.rows.start
    return x.sum() / (x.numel() / local_rows * ctx.global_rows)


class _Lockstep:
    """The meeting point of a process's shards, one thread each: `all_sum`
    waits for every shard's tensor, and shard 0 sums them in shard order
    (then over the ranks), so every shard reads the same total."""

    def __init__(self, n: int, timeout: float = 600.0):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots: list = [None] * n
        self.total = None

    def all_sum(self, index: int, t: torch.Tensor) -> torch.Tensor:
        self.slots[index] = t
        self.barrier.wait()
        if index == 0:
            total = self.slots[0]
            for other in self.slots[1:]:
                total = total + other.to(total.device)
            self.total = distributed.all_sum_differentiable(total)
        self.barrier.wait()
        out = self.total.to(t.device)
        self.barrier.wait()  # every shard has read before the slots are reused
        return out

    def abort(self) -> None:
        self.barrier.abort()


def run_shards(contexts: list[ShardContext], fn, lockstep: bool = False) -> list:
    """`fn(i)` for each shard under its context: one after the other, or
    with `lockstep` in one thread per shard, meeting at `all_sum`.  The
    first error of a shard is raised (the others are released)."""
    if not lockstep or len(contexts) == 1:
        out = []
        for i, ctx in enumerate(contexts):
            with use_shard(ctx):
                out.append(fn(i))
        return out
    coll = _Lockstep(len(contexts))
    results: list = [None] * len(contexts)
    errors: list = [None] * len(contexts)

    def work(i):
        try:
            with use_shard(dataclasses.replace(contexts[i], collective=coll)):
                results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e
            coll.abort()

    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(len(contexts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    raised = [e for e in errors if e is not None]
    if raised:
        raise next((e for e in raised if not isinstance(e, threading.BrokenBarrierError)),
                   raised[0])
    return results


def shard_contexts(mesh: Mesh | None, local_rows: int, totals: dict) -> list[ShardContext]:
    """One context per data shard of this process: its rows of the global
    batch, whose rows are every rank's in rank order."""
    n_local = len(mesh.data_devices) if mesh is not None else 1
    world, rank = distributed.world_size(), distributed.rank()
    base = rank * local_rows
    return [ShardContext(rows=slice(base + s.start, base + s.stop),
                         global_rows=world * local_rows, totals=totals, index=i, n_local=n_local)
            for i, s in enumerate(shard_slices(local_rows, n_local))]


# ------------------------------------------------------------ batch compaction


def device_batch(batch: dict) -> dict:
    """Strip the host-only fields (sample paths, `num_real`) from a batch."""
    return {k: v for k, v in batch.items() if k in DEVICE_BATCH_KEYS}


def compact_batch(batch: dict) -> dict:
    """Shrink a host batch before its upload: time-gap masks (every bin of a
    frame zeroed together) travel as one int8 per frame (`mask_frames`),
    int16-valued waves as int16, video as f16.  Falls back silently where an
    assumption does not hold: a mask that is not bin-uniform, or soft (its
    values would not survive int8), stays f32, and so does a wave with
    non-integer values.  `expand_batch` restores the rest inside the step."""
    out = device_batch(batch)
    m = out.get("masks")
    if m is not None and m.ndim == 3:
        m = np.asarray(m)
        mf = m[:, :, 0]
        mi = mf.astype(np.int8)
        if np.array_equal(mi.astype(m.dtype), mf) and np.array_equal(
            m, np.broadcast_to(mf[:, :, None], m.shape)
        ):
            out["mask_frames"] = mi
            del out["masks"]
    w = out.get("target_sources")
    if w is not None:
        w = np.asarray(w)
        if w.dtype == np.float32 and np.abs(w).max() < 32767.5:
            wi = w.astype(np.int16)
            if np.array_equal(wi.astype(np.float32), w):
                out["target_sources"] = wi
    v = out.get("video_features")
    if v is not None and np.asarray(v).dtype == np.float32:
        out["video_features"] = np.asarray(v).astype(np.float16)
    return out


def expand_batch(batch: dict, audio_feat_dim: int) -> dict:
    """Inverse of `compact_batch`, on the device: per-frame int8 masks ->
    (B, T, audio_feat_dim) f32 masks; int16 waves and f16 video -> f32."""
    out = dict(batch)
    mf = out.pop("mask_frames", None)
    if mf is not None:
        out["masks"] = mf.float()[:, :, None].expand(
            mf.shape[0], mf.shape[1], audio_feat_dim
        )
    out["target_sources"] = out["target_sources"].float()
    if "video_features" in out:
        out["video_features"] = out["video_features"].float()
    return out
