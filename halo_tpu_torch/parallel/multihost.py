"""Process coordination over ``torch.distributed`` (port of
``halo_tpu/parallel/multihost.py``).

One process, rank 0 (the coordinator), makes the writes that must happen
once: the initial masks, checkpoints, ``metrics.jsonl``, the test
entry's artifacts. Each process reads its contiguous slice of every
global batch (``loader_shard``). Barriers (``sync_hosts``) order the
coordinator's writes before the other processes read them.

Every function is the identity, or a no-op, when no process group is
initialised, so a process started without the torchrun environment runs
as one process does. The collectives here run on CPU tensors, which the
group's gloo backend carries (``mesh.init_from_env`` pairs NCCL with
gloo for them), and are all ``all_reduce`` or ``broadcast``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _group_active() else 0


def process_count() -> int:
    return dist.get_world_size() if _group_active() else 1


def is_coordinator() -> bool:
    """True on the one process that makes the once-per-run writes."""
    return process_index() == 0


def _all_reduce(values, dtype, op):
    t = torch.as_tensor(np.asarray(values), dtype=dtype).reshape(-1)
    dist.all_reduce(t, op=op)
    return t


def sync_hosts(name: str = "") -> None:
    """Barrier across the processes (a no-op in one process): an
    all-reduce every process must join before any returns. ``name`` only
    labels the call site."""
    if process_count() > 1:
        _all_reduce([0], torch.int64, dist.ReduceOp.SUM)


def loader_shard():
    """(shard index, shard count) for slicing the global batches, or None
    in one process. Process p takes the p-th contiguous slice."""
    n = process_count()
    return None if n == 1 else (process_index(), n)


def any_host_flag(flag: bool) -> bool:
    """Logical OR of a process-local flag across the processes. Every
    process must take the same branch on a process-local event (a SIGTERM
    that reached one) before a barrier or a collective."""
    if process_count() == 1:
        return bool(flag)
    return bool(_all_reduce([int(bool(flag))], torch.int64,
                            dist.ReduceOp.MAX)[0])


def sum_over_hosts(values: dict) -> dict:
    """Element-wise sum of a {str: number} dict across the processes (the
    identity in one process). Integer entries are summed as int64 (exact
    at any magnitude), the others as float64. Every process must hold the
    same keys; which keys are integers is agreed first (an all-reduce
    MIN), so a key that is an int on one process and a float on another
    cannot split the keys differently and mismatch the collectives."""
    if process_count() == 1:
        return values
    keys = sorted(values)
    local_is_int = [int(isinstance(values[k], (int, np.integer))
                        and not isinstance(values[k], bool)) for k in keys]
    agreed = _all_reduce(local_is_int, torch.int64, dist.ReduceOp.MIN)
    int_keys = [k for k, flag in zip(keys, agreed.tolist()) if flag]
    flt_keys = [k for k in keys if k not in int_keys]
    out = {}
    if int_keys:
        tot = _all_reduce([int(values[k]) for k in int_keys], torch.int64,
                          dist.ReduceOp.SUM).tolist()
        out.update({k: type(values[k])(tot[i])
                    for i, k in enumerate(int_keys)})
    if flt_keys:
        tot = _all_reduce([float(values[k]) for k in flt_keys],
                          torch.float64, dist.ReduceOp.SUM).tolist()
        # a plain float even where this process's value was an int, so
        # every process returns the same total
        out.update({k: float(tot[i]) for i, k in enumerate(flt_keys)})
    return out


def broadcast_seed(seed: int) -> int:
    """The coordinator's seed on every process (the identity in one). The
    loader slices assume every process shuffles the same global order,
    and the wall-clock fallback seed differs between processes."""
    if process_count() == 1:
        return int(seed)
    t = torch.tensor([int(seed)], dtype=torch.int64)
    dist.broadcast(t, src=0)
    return int(t[0])
