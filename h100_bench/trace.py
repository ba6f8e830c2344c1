"""One torch.profiler session over the traced window, read in memory (no
file is written).

The profiler records the device's activities alone (host operations would
slow the host-paced steps they time). The session opens with spin kernels
(the profiler on the card may miss a session's first device events), left
out. The window is the traced calls' host time, from a synchronized start
to their closing synchronize. ``busy_s`` is the union of the device's
activities (kernels, copies, fills). The breakdown gives the device
operations that took most time and the longest idle gaps between them,
each named by the innermost host call the trace holds at the gap's middle
(the CUDA runtime's: a launch, a copy, a synchronize; "host" where there
is none) and the device operation that ends it.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import torch

PAD_KERNELS = 4
PAD_NAME = "spin_kernel"
TOP = 10
NAME = 64


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def time_s(self, *needles: str) -> float:
        """Device seconds of the operations whose name holds a needle."""
        return sum(e - s for n, s, e in self.ops
                   if any(x in n for x in needles)) / 1e6


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def short(name: str) -> str:
    """A kernel's name without "void", anonymous namespaces and its
    argument list, cut to NAME characters."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0][:NAME]


def read(events, device_type, window_s: float) -> Trace:
    """A Trace from ``prof.events()``: the activities of ``device_type``
    (a ``torch.autograd.DeviceType``) but the spin kernels, in a window of
    ``window_s`` host seconds."""
    from torch.autograd import DeviceType
    ops = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == device_type and PAD_NAME not in e.name]
    busy = _union([(s, e) for _, s, e in ops])
    by_name = collections.Counter()
    for n, s, e in ops:
        by_name[short(n)] += (e - s) / 1e6
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:TOP]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    starts = sorted(ops, key=lambda o: o[1])
    named = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        around = [e for e in host
                  if e.time_range.start <= mid <= e.time_range.end]
        doing = (max(around, key=lambda e: e.time_range.start).name
                 if around else "host")
        after = next(n for n, s, _ in starts if s >= b)
        named.append((f"{doing[:40]} -> {short(after)}", length / 1e6))
    return Trace(window_s=window_s, busy_s=sum(e - s for s, e in busy) / 1e6,
                 ops=ops, device_ops=by_name.most_common(TOP),
                 idle_gaps=named)


def traced(run: Callable[[], None], device: torch.device) -> Trace:
    """Profile ``run`` (which ends on a synchronize) with the device's
    activities alone, and read the trace; the window is ``run``'s host
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        if cuda:
            for _ in range(PAD_KERNELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        window_s = time.perf_counter() - t0
    return read(prof.events(), DeviceType.CUDA if cuda else DeviceType.CPU,
                window_s)
