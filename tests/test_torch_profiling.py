"""Port parity, ``halo_tpu_torch/utils/profiling.py`` against
``halo_tpu/utils/profiling.py``: ``StepTimer``'s moving average and
``stats()`` under one fake clock, and ``annotate``/``trace`` as ranges of a
CPU ``torch.profiler`` trace."""

import glob
import json
import os
import time

import pytest
import torch

from halo_tpu.utils import profiling as jax_profiling
from halo_tpu_torch.utils import profiling


def _run(timer_cls, monkeypatch, ticks):
    clock = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    timer = timer_cls(ema=0.8)
    assert timer.stats() == {}
    laps = []
    for _ in range(len(ticks) // 2):
        timer.start()
        laps.append(timer.stop(block_on=[{"x": torch.ones(2)}]
                               if timer_cls is profiling.StepTimer
                               else None))
    return laps, timer.avg_s, timer.stats(items_per_step=4.0)


def test_step_timer_matches_jax(monkeypatch):
    ticks = [0.0, 0.5, 1.0, 1.25, 2.0, 2.125, 3.0, 4.0]
    got = _run(profiling.StepTimer, monkeypatch, ticks)
    want = _run(jax_profiling.StepTimer, monkeypatch, ticks)
    assert got == want
    laps, avg, stats = got
    assert laps == [0.5, 0.25, 0.125, 1.0]
    assert avg == pytest.approx(0.8 * (0.8 * (0.8 * 0.5 + 0.2 * 0.25)
                                       + 0.2 * 0.125) + 0.2 * 1.0)
    assert stats == {"step_time_s": avg, "throughput": 4.0 / avg}


def test_annotate_is_a_range_of_the_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("halo/test_range"):
            torch.ones(8).add_(1).sum()
    names = [e.key for e in prof.key_averages()]
    assert "halo/test_range" in names
    files = glob.glob(os.path.join(str(tmp_path), "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "halo/test_range" for e in events)
