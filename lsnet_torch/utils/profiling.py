"""Profiling / timing utilities (counterpart of
``lsnet_tpu/utils/profiling.py``).

``profile_time`` times a block with the current CUDA device synchronised
before and after it (the reference's ``mmdet/utils/profiling.py``), in
the JAX package's printed format; ``trace`` records a ``torch.profiler``
trace (host and CUDA activity) that TensorBoard's profiler plugin reads;
``StepTimer`` keeps the data and step times of the reference's
``IterTimerHook``.
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_time(trace_name: str, name: str, enabled: bool = True,
                 stream=sys.stdout, end: str = "\n"):
    """Time a block, synchronising outstanding device work first; prints
    ``{trace_name} {name} elapsed_time {ms:.2f} ms``."""
    if not enabled:
        yield
        return
    _sync()
    t0 = time.monotonic()
    try:
        yield
    finally:
        _sync()
        dt = time.monotonic() - t0
        print(f"{trace_name} {name} elapsed_time {dt * 1000:.2f} ms",
              file=stream, end=end)


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Record the block with ``torch.profiler`` (CPU, and CUDA where the
    card is there) and write ``log_dir/<host>_<pid>.<time>.pt.trace.json``,
    the layout TensorBoard's profiler plugin reads. Yields the profiler."""
    if not enabled:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        _sync()


class StepTimer:
    """data_time / step_time running stats (reference IterTimerHook)."""

    def __init__(self):
        self._last = time.monotonic()
        self.data_time = 0.0
        self.step_time = 0.0

    def mark_data(self):
        now = time.monotonic()
        self.data_time = now - self._last
        self._last = now

    def mark_step(self):
        now = time.monotonic()
        self.step_time = now - self._last
        self._last = now

    def metrics(self) -> dict:
        return {"data_time": self.data_time, "time": self.step_time}
