"""Start a few local processes together and join them within one deadline,
as the ranks of a data-parallel run are started on one host without
``torchrun`` (the CPU tests' gloo ranks, the card smoke's runs).

A process still running at the deadline is killed, so a hung collective
costs no more than the timeout.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, List, Optional, Sequence

# the variables through which torchrun tells a process its place in a group
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def run_processes(commands: Sequence[List[str]], envs: Sequence[dict],
                  logs: Sequence[str], timeout: float, cwd: str,
                  on_start: Optional[Callable[[list], None]] = None) -> None:
    """Start every ``commands[i]`` at once, with environment ``envs[i]``
    and its output (standard output and error) to the file ``logs[i]``,
    then join them all within ``timeout`` seconds. ``on_start(procs)``
    runs once all are started, before any is joined. Raises RuntimeError,
    with the tail of every log, when a process had to be killed at the
    deadline or exited with another code than 0."""
    procs, files = [], []
    try:
        for command, env, log in zip(commands, envs, logs):
            files.append(open(log, "w"))
            procs.append(subprocess.Popen(
                command, cwd=cwd, env=env, stdout=files[-1],
                stderr=subprocess.STDOUT))
        if on_start is not None:
            on_start(procs)
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                break
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
        for p in hung:
            p.wait()
        for f in files:
            f.close()
    if not hung and not any(p.returncode for p in procs):
        return
    tails = "".join(f"\n--- process {i} (exit {p.returncode}) ---\n"
                    + open(log).read()[-6000:]
                    for i, (p, log) in enumerate(zip(procs, logs)))
    if hung:
        raise RuntimeError(f"{len(hung)} of {len(procs)} processes still "
                           f"ran after {timeout} s and were killed{tails}")
    raise RuntimeError(f"a process failed{tails}")
