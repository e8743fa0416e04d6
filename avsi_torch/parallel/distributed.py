"""Multi-process runs on `torch.distributed` (port of `avsi/parallel/distributed.py`).

`initialize()` joins this process to a job (`init_process_group` over
`tcp://<coordinator>`), once per process, before training.  Every rank then
runs the same `train()`: it reads its own file shard (`shard_files`), holds
its own rows of the global batch (the ranks' local batches in rank order),
and the sharded train step sums the loss denominators and the gradients
over the ranks with `all_reduce`.  Host-side metric reductions go through
`gather_hosts` / `allreduce_sum`, so every rank takes the same best-val,
early-stop and preemption branches.

The reference's `global_batch` (assembling a global array from each
host's rows) and `host_rows` (this host's rows of a global result) have no
counterpart: here a rank's batch and its per-sample results never leave
the rank, so there is nothing to assemble or pick out.

A job of one rank is a job all the same: `active()` is true once a process
group exists, so its collectives run (through NCCL on a card).  Two ranks
on one GPU need `backend="gloo"`: NCCL refuses a GPU that two ranks share,
and `initialize` says so before it tries.  Gloo sums CUDA tensors but does
not gather them, so `gather_hosts` works on host tensors under Gloo.
"""

from __future__ import annotations

import datetime
import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
_LOOPBACK = ("localhost", "127.0.0.1", "::1")


def active() -> bool:
    """True once this process has joined a `torch.distributed` job."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def backend() -> str | None:
    """The job's backend ("nccl", "gloo"), or None outside a job."""
    return str(dist.get_backend()) if active() else None


def is_main() -> bool:
    """True on the rank that owns file writes (checkpoints, logs, TensorBoard)."""
    return rank() == 0


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the job: `init_process_group(backend, init_method="tcp://<coordinator>")`.

    Arguments left None come from torchrun's environment (`MASTER_ADDR`,
    `MASTER_PORT`, `WORLD_SIZE`, `RANK`), PyTorch's counterpart of
    `jax.distributed`'s auto-detection.  The backend is `nccl` for a CUDA
    `device` (the default) and `gloo` for the CPU; pass `backend="gloo"`
    for ranks that share one card.  Under NCCL each rank takes the GPU
    `LOCAL_RANK` (else its rank) modulo the visible count, and more ranks
    on this host than GPUs raises ValueError: the host's rank count is
    `LOCAL_WORLD_SIZE`, else the whole job when the coordinator is a
    loopback address."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs the coordinator address, the number of processes "
                         "and this process's id (or torchrun's MASTER_ADDR, MASTER_PORT, "
                         "WORLD_SIZE and RANK)")
    dev = torch.device("cuda" if device is None else device)
    backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a GPU; pass device='cpu' (gloo) without one")
        host = coordinator_address.rsplit(":", 1)[0].strip("[]")
        local_world = int(env.get("LOCAL_WORLD_SIZE",
                                  num_processes if host in _LOOPBACK else 1))
        n_gpu = torch.cuda.device_count()
        if local_world > n_gpu:
            raise ValueError(f"{local_world} ranks on this host share {n_gpu} GPU(s), and NCCL "
                             "refuses two ranks on one GPU; pass backend='gloo' for ranks "
                             "that share a card")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)) % n_gpu)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))


def rank_device(device) -> torch.device:
    """This rank's device of type `device`: the current CUDA device (the
    one `initialize` set), or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def gather_hosts(values) -> np.ndarray:
    """Stack a small host-side float vector across ranks: (world,
    len(values)), identical on every rank; (1, len(values)) outside a job.
    The building block of the metric reductions that must agree bit for
    bit, so that best-checkpoint and early-stop decisions stay in lockstep."""
    vec = np.asarray(values, dtype=np.float64).reshape(-1)
    if not active():
        return vec[None, :]
    t = torch.from_numpy(vec.copy())
    if dist.get_backend() == "nccl":
        t = t.cuda()
    out = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def allreduce_sum(values) -> np.ndarray:
    """Sum a small host-side float vector across ranks (the same result on
    every rank).  Outside a job: the values."""
    return gather_hosts(values).sum(axis=0)


def assert_uniform(tag: str, payload: str) -> None:
    """Fail on every rank if `payload` differs across ranks (a batch's
    compaction signature, so that one rank shipping another dtype fails
    fast instead of hanging a collective)."""
    if not active():
        return
    digest = np.frombuffer(hashlib.sha256(payload.encode()).digest()[:8], np.int32)
    rows = gather_hosts(digest.astype(np.float64))
    if not (rows == rows[0]).all():
        raise AssertionError(f"{tag} differs across hosts: {payload!r} (this host)")


def shard_files(file_list: list[str], process_index: int | None = None,
                process_count: int | None = None) -> list[str]:
    """Deterministic per-rank file shard (round-robin over sorted files).

    Raises when there are fewer files than ranks: a rank with an empty
    shard would fail (or hang in the first collective) long after startup."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    if len(file_list) < pc:
        raise ValueError(
            f"{len(file_list)} tfrecord file(s) cannot be sharded over {pc} "
            "processes — some hosts would get an empty shard; regroup the "
            "corpus into at least one file per host (tfrecords_grouping)"
        )
    return [f for i, f in enumerate(sorted(file_list)) if i % pc == pi]


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks, in place (outside a job: `t`)."""
    if active():
        dist.all_reduce(t)
    return t


def all_sum_differentiable(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks under autograd: the backward sums the
    ranks' gradients the same way (outside a job: `t`)."""
    if not active():
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


def all_sum_tensors(tensors: list[torch.Tensor]) -> None:
    """Sum each tensor over the ranks in place, one `all_reduce` per device
    and dtype over their concatenation (the gradients of a step)."""
    if not active() or not tensors:
        return
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
