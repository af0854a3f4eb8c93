"""Tracing and timing hooks.

Counterpart of ``paddlexde_tpu/utils/profiling.py``: a ``torch.profiler``
trace context that writes a Chrome/Perfetto trace (the JAX package writes a
``jax.profiler`` TensorBoard trace), a wall-clock timer and the demo
harness's running-average meter. Field-evaluation counts come from the
solvers themselves (``AdaptiveStats.nfe`` with ``options={"return_stats":
True}``).
"""

from __future__ import annotations

import contextlib
import os
import time

__all__ = ["trace", "Timer", "RunningAverageMeter"]


@contextlib.contextmanager
def trace(logdir: str, with_stack: bool = False):
    """Profile the block on the CPU and, where there is one, the card, and
    write ``logdir/trace.json`` (open it in Perfetto or chrome://tracing).
    Yields the profiler (``prof.key_averages()`` tabulates it)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities, with_stack=with_stack) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


class RunningAverageMeter:
    """Exponential moving average (the reference's ``example/demo_utils.py``
    meter)."""

    def __init__(self, momentum: float = 0.99):
        self.momentum = momentum
        self.val = None
        self.avg = 0.0

    def update(self, val: float):
        self.avg = val if self.val is None else (
            self.avg * self.momentum + val * (1 - self.momentum))
        self.val = val
