"""Profiling hooks: a ``torch.profiler`` trace around a window of work, and
a steps/s and items/s counter.

Port of ``recnet_tpu.utils.profiling`` with ``torch.profiler`` in place of
``jax.profiler``: the trace records host and CUDA activity and is written
as a Chrome trace (viewable in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional


def start_trace():
    """A started ``torch.profiler.profile`` over the host and, where there
    is one, the CUDA card; stop it with :func:`stop_trace`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str) -> Optional[str]:
    """Stop ``prof`` and write its Chrome trace under ``log_dir``; returns
    the trace's path."""
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{int(time.time() * 1000)}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace_if(enabled: bool, log_dir: str) -> Iterator[None]:
    """A ``torch.profiler`` trace written to ``log_dir`` when enabled, a
    no-op otherwise."""
    if not enabled:
        yield
        return
    prof = start_trace()
    try:
        yield
    finally:
        stop_trace(prof, log_dir)


class StepTimer:
    """Rolling steps/sec + items/sec over a logging window."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._steps = 0
        self._items = 0

    def tick(self, items: int = 0) -> None:
        self._steps += 1
        self._items += items

    def rates(self) -> tuple[float, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return self._steps / dt, self._items / dt

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
        self._items = 0
