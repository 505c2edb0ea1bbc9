"""Profiling and tracing (port of ``halo_tpu/utils/profiling.py``):
``trace`` through ``torch.profiler``, ``annotate`` through
``record_function``, and ``StepTimer``, whose ``stop`` synchronises the
CUDA devices of what it is given, so asynchronous launches do not hide
device time."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the host and, when there is one, the
    CUDA device, written under ``log_dir`` as a chrome trace that
    TensorBoard's profiler plugin reads; yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """A named range on the trace's timeline (a context manager)."""
    return torch.profiler.record_function(name)


def _synchronize(tree):
    """Synchronise every CUDA device a tensor of ``tree`` (a tensor, or
    lists, tuples and dicts of them) lives on."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _synchronize(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _synchronize(v)


class StepTimer:
    """Wall-clock step timing with an exponential moving average;
    ``stop(block_on)`` first waits for the devices ``block_on``'s tensors
    live on."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg_s: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, block_on=None) -> float:
        if block_on is not None:
            _synchronize(block_on)
        dt = time.perf_counter() - self._t0
        self.avg_s = dt if self.avg_s is None else (
            self.ema * self.avg_s + (1 - self.ema) * dt)
        return dt

    def stats(self, items_per_step: float = 1.0) -> Dict[str, float]:
        if self.avg_s is None:
            return {}
        return {"step_time_s": self.avg_s,
                "throughput": items_per_step / self.avg_s}
