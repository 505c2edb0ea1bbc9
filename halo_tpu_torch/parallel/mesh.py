"""The process group of a data-parallel run (port of
``halo_tpu/parallel/mesh.py``).

The JAX package runs one program over a device mesh and lets GSPMD insert
the gradient psum, the global BatchNorm statistics and the histogram
psum. The port runs one process a device, as torchrun starts them, and
makes those reductions explicit (``collectives``): the layout of DDP with
the semantics of the JAX package's global batch.

``init_from_env`` reads the torchrun environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). A
process without it runs alone, with no group. The JAX package's ``model``
axis (``TPU.SPATIAL_PARALLEL``) has no counterpart in the learners;
``active.scoring.spatial_region_score`` takes an explicit group.
"""

from __future__ import annotations

import os
import socket
import zlib
from typing import Optional

import torch
import torch.distributed as dist

def group():
    """The world group when one is initialised, else None (one process)."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def _device_for(device, local_rank: int) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` unless the caller names one
    (``cuda`` without an index also means ``cuda:LOCAL_RANK``); raises
    when that CUDA device does not exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.index >= count:
            raise RuntimeError(
                f"LOCAL_RANK {local_rank} runs on {dev}, and this host has "
                f"{count} CUDA device(s); start at most {count} processes a "
                "host, or pass device='cpu' to run on the CPU explicitly")
    return dev


def _refuse_shared_devices(dev: torch.device, rank: int, world: int):
    """NCCL cannot put two ranks on one device: each rank contributes a
    key of (host, device index) through the group's gloo side, and a key
    seen twice raises ValueError on every rank."""
    key = (zlib.crc32(socket.gethostname().encode()) << 8) | dev.index
    keys = torch.zeros(world, dtype=torch.int64)
    keys[rank] = key
    dist.all_reduce(keys)
    keys = keys.tolist()
    if len(set(keys)) != world:
        dup = [r for r, k in enumerate(keys) if keys.count(k) > 1]
        dist.destroy_process_group()
        raise ValueError(
            f"ranks {dup} share one CUDA device, which NCCL does not allow; "
            "give each rank its own device, or pass backend='gloo'")


def init_from_env(device=None, backend: Optional[str] = None,
                  init_method: Optional[str] = None):
    """Join the process group the torchrun environment describes and
    return this rank's device; without ``RANK`` and ``WORLD_SIZE`` in the
    environment return ``device`` as given (one process, no group).

    The backend is NCCL for a CUDA device (with gloo beside it for the
    host's CPU tensors) and gloo for the CPU; an explicit ``backend``
    wins (gloo carries CUDA tensors too, through ``all_reduce`` and
    ``broadcast``, so ranks may share a card). ``init_method`` defaults to
    ``env://``. A group that is already initialised is kept (checked
    against the environment)."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return device
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    dev = _device_for(device, local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError(
                f"a process group of rank {dist.get_rank()} of "
                f"{dist.get_world_size()} is initialised, and the "
                f"environment says rank {rank} of {world}")
        return dev
    dist.init_process_group(
        backend="cpu:gloo,cuda:nccl" if backend == "nccl" else "gloo",
        init_method=init_method or "env://", rank=rank, world_size=world)
    if backend == "nccl":
        _refuse_shared_devices(dev, rank, world)
    return dev


def destroy():
    """Destroy the process group, if one is initialised."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
