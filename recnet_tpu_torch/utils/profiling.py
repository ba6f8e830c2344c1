"""Profiling hooks: the program's own spans, and a ``torch.profiler`` trace
around a window of work that carries them.

A span (:func:`span`) marks a phase of the program on the host: a train
step's forward, backward and optimizer, a decode's preparation, segments
and waits. Spans are off unless :func:`enable_spans` turned them on; off, a
span costs one check of a module global and returns a shared object that
does nothing. On, each records, as it closes, its name, its start and end
on ``time.time_ns()`` (the Unix-epoch clock of ``torch.profiler``'s Kineto
events, so a span and the device activities it enqueued share one time
base), whether it waits for the device (``waits``: a host read of device
data) and its thread, into a list of at most ``limit`` spans; later ones
are counted as dropped. :func:`spans` reads them with the index of the
span around each on its thread.

:func:`start_trace` / :func:`stop_trace` give the operator's trace
(``--profile_dir``): host and CUDA activity, written as a Chrome trace
(viewable in Perfetto or chrome://tracing) with the spans recorded while
it ran on a track of their own.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, NamedTuple, Optional

SPAN_LIMIT = 1 << 20
SPAN_TRACK = "recnet_tpu_torch spans"


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int        # index of the enclosing span on its thread; -1: none
    waits: bool
    thread: int


class _Recorder:
    """One recording: the closed spans as rows (name, start, end, waits,
    thread) in the order they closed, at most ``limit``, and the count of
    those dropped past it."""
    __slots__ = ("limit", "rows", "dropped")

    def __init__(self, limit: int):
        self.limit = limit
        self.rows: List[tuple] = []
        self.dropped = 0


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_recorder: Optional[_Recorder] = None      # recording now
_last: Optional[_Recorder] = None          # the last recording, once off


class _OpenSpan:
    __slots__ = ("rec", "name", "waits", "start")

    def __init__(self, rec: _Recorder, name: str, waits: bool):
        self.rec, self.name, self.waits = rec, name, waits

    def __enter__(self):
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        if len(rec.rows) < rec.limit:
            rec.rows.append((self.name, self.start, end, self.waits,
                             threading.get_ident()))
        else:
            rec.dropped += 1
        return False


def span(name: str, waits: bool = False):
    """A context manager marking ``name`` on the host; ``waits`` where it
    reads device data (``bool``/``int`` of a device tensor, ``.cpu()``)."""
    rec = _recorder
    if rec is None:
        return _NO_SPAN
    return _OpenSpan(rec, name, waits)


def enable_spans(limit: int = SPAN_LIMIT) -> None:
    """Record spans from now on, into an empty list of at most ``limit``."""
    global _recorder
    _recorder = _Recorder(limit)


def disable_spans() -> None:
    """Stop recording; what was recorded stays readable until the next
    :func:`enable_spans`."""
    global _recorder, _last
    _last, _recorder = _recorder or _last, None


def _current() -> Optional[_Recorder]:
    return _recorder or _last


def spans() -> List[Span]:
    """The closed spans of the current (or last) recording in the order
    they opened, each with the index of the span around it on its thread:
    spans nest on a thread, so that is the latest one opened there before
    it that closed after it."""
    rec = _current()
    if rec is None:
        return []
    rows = sorted(enumerate(list(rec.rows)),
                  key=lambda ir: (ir[1][1], -ir[1][2], -ir[0]))
    out: List[Span] = []
    stacks = {}                    # thread -> [(close order, index)]
    for closed, (name, start, end, waits, thread) in rows:
        stack = stacks.setdefault(thread, [])
        while stack and stack[-1][0] < closed:
            stack.pop()
        out.append(Span(name, start, end, stack[-1][1] if stack else -1,
                        waits, thread))
        stack.append((closed, len(out) - 1))
    return out


def dropped_spans() -> int:
    """Spans past the limit of the current (or last) recording."""
    rec = _current()
    return rec.dropped if rec is not None else 0


def clear_spans() -> None:
    """Empty the current recording."""
    rec = _recorder
    if rec is not None:
        enable_spans(rec.limit)


def start_trace():
    """A started ``torch.profiler.profile`` over the host and, where there
    is one, the CUDA card, with spans on; stop it with :func:`stop_trace`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    enable_spans()
    prof.start()
    return prof


def stop_trace(prof, log_dir: str) -> Optional[str]:
    """Stop ``prof`` and the spans, and write its Chrome trace under
    ``log_dir`` with the spans as complete events on their own track;
    returns the trace's path."""
    prof.stop()
    disable_spans()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{int(time.time() * 1000)}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    # Kineto writes ts in us past baseTimeNanoseconds, on time_ns's clock
    base = trace.get("baseTimeNanoseconds", 0)
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "span", "name": s.name, "pid": SPAN_TRACK,
         "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"waits": s.waits}}
        for s in spans())
    with open(path, "w") as f:
        json.dump(trace, f)
    return path
