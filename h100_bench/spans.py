"""The program's spans (``recnet_tpu_torch.utils.profiling``) read against
the card's trace: where each device activity was enqueued from, and what
the host was doing when the card ran out of work.

    python3 h100_bench/spans.py --workload <name> --seed <n> --seconds <s>

runs one cell as ``run.py --trace 1`` does, with the traced part replaced
by :func:`traced`. It first runs the traffic's ``trace_calls`` with the
spans on and the profiler off (the spans-only pass: each span's host time
free of the profiler's cost, and the spans' own cost against the untraced
window's rate), then profiles them as ``trace.traced`` does with the spans
on. It prints a ``spans`` line after the ``window`` line (with a span's
host cost, off and on, timed on this host), and the result line with the
per-layer metrics of ``SPAN_METRICS`` added to the cell's.

Attribution, on the one clock the spans and the profiler's Kineto events
share (``time.time_ns``):

- a device activity belongs to the innermost span open when the CUDA
  runtime call that enqueued it ran (matched by CUPTI correlation id,
  whatever thread made the call; on the CPU, where there is no runtime
  call, the activity's own start);
- an idle gap of the card (the traced window less the union of its
  activities) belongs to the innermost span open at the gap's start, in
  one of three classes: ``wait`` (a span with ``waits``: a sync drained
  the queue), ``dispatch`` (any other span: the host fell behind the
  card), ``caller`` (no span: the calling generator's own code).

Where the program has no spans (a checkout before them), :func:`traced`
is ``trace.traced`` and the span metrics read nothing.
"""

from __future__ import annotations

import bisect
import collections
import importlib
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench import trace as trace_mod  # noqa: E402
from h100_bench.manifest import Manifest  # noqa: E402

_PLAIN = trace_mod.traced

CLASSES = ("wait", "dispatch", "caller")
STOP_CHECK = "decode.stop_check"
SEGMENT = "decode.segment"
CLOCK_US = 20            # a stop check's end past the K2 end it waited for
# the wrappers' launch counters (function attributes of the program)
COUNTERS = {
    "whole_greedy_decode.n_launches":
        ("recnet_tpu_torch.ops.cuda.whole_decode", "whole_greedy_decode"),
    "whole_greedy_decode_segment.n_launches":
        ("recnet_tpu_torch.ops.cuda.whole_decode",
         "whole_greedy_decode_segment"),
    "outproj_topk.n_launches":
        ("recnet_tpu_torch.ops.cuda.topk_proj", "outproj_topk"),
    "fused_gru_attn_step.n_launches":
        ("recnet_tpu_torch.ops.cuda.fused_step", "fused_gru_attn_step"),
    "cell_rollout_forward.n_launches":
        ("recnet_tpu_torch.ops.cuda.rollout", "cell_rollout_forward"),
    "cell_rollout_backward.n_launches":
        ("recnet_tpu_torch.ops.cuda.rollout", "cell_rollout_backward"),
}
_TRAIN = ["msvd-global-train-f32-b1024", "msvd-local-train-f32-b1024"]
_DECODE = ["msvd-global-greedy-b1024", "msvd-global-beam5-b1024"]
# the per-layer metrics that read the spans, as BENCHMARK.json entries
SPAN_METRICS = [
    dict(name=f"{phase}_ms.train", unit="ms", better="lower",
         source="device_trace", layer="train step",
         moves="train_samples_per_s", workloads=_TRAIN)
    for phase in ("forward", "backward", "optimizer")
] + [
    dict(name=f"idle_share.decode.{kind}", unit="%", better="lower",
         source="device_trace", layer="device", moves="captions_per_s",
         workloads=_DECODE)
    for kind in CLASSES
]


@dataclass
class Activity:
    name: str
    start_ns: int
    end_ns: int
    host_ns: int         # when the call that enqueued it ran


@dataclass
class SpanReport:
    """What one traced pass's spans claim, in ns over the whole pass."""
    count: Dict[str, int] = field(default_factory=dict)
    host_ns: Dict[str, int] = field(default_factory=dict)
    device_ns: Dict[str, int] = field(default_factory=dict)  # innermost
    idle_ns: Dict[str, Dict[str, int]] = field(default_factory=dict)
    idle_class_ns: Dict[str, int] = field(
        default_factory=lambda: dict.fromkeys(CLASSES, 0))
    unclaimed_ns: int = 0            # device time enqueued outside spans
    device_total_ns: int = 0
    clock: Dict[str, float] = field(default_factory=dict)


class Innermost:
    """The innermost span open at a time: spans nest on each thread, and
    of the threads' innermost spans the one that opened last."""

    def __init__(self, spans: Sequence):
        self.spans = spans
        self.lines = []
        by_thread = collections.defaultdict(list)
        for i, s in enumerate(spans):
            by_thread[s.thread].append(i)
        for idx in by_thread.values():
            times, owner, stack = [], [], []
            for i in sorted(idx, key=lambda i: (spans[i].start_ns,
                                                -spans[i].end_ns)):
                self._close(stack, times, owner, spans[i].start_ns)
                stack.append(i)
                times.append(spans[i].start_ns)
                owner.append(i)
            self._close(stack, times, owner, None)
            self.lines.append((times, owner))

    def _close(self, stack, times, owner, until):
        while stack and (until is None
                         or self.spans[stack[-1]].end_ns <= until):
            j = stack.pop()
            times.append(self.spans[j].end_ns)
            owner.append(stack[-1] if stack else -1)

    def at(self, t: int) -> int:
        """The index of the innermost span open at ``t`` (start <= t <
        end), or -1."""
        best = -1
        for times, owner in self.lines:
            k = bisect.bisect_right(times, t) - 1
            i = owner[k] if k >= 0 else -1
            if i >= 0 and (best < 0 or self.spans[i].start_ns
                           > self.spans[best].start_ns):
                best = i
        return best


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def attribute(activities: Sequence[Activity], spans: Sequence,
              window: Tuple[int, int]) -> SpanReport:
    """Each activity to the span open where it was enqueued; each idle gap
    of ``window`` (ns) to the span open at its start, by class."""
    find = Innermost(spans)
    rep = SpanReport()
    for s in spans:
        rep.count[s.name] = rep.count.get(s.name, 0) + 1
        rep.host_ns[s.name] = (rep.host_ns.get(s.name, 0)
                               + s.end_ns - s.start_ns)
    owners = []
    for a in activities:
        i = find.at(a.host_ns)
        owners.append(i)
        d = a.end_ns - a.start_ns
        rep.device_total_ns += d
        if i < 0:
            rep.unclaimed_ns += d
        else:
            name = spans[i].name
            rep.device_ns[name] = rep.device_ns.get(name, 0) + d
    w0, w1 = window
    busy = _union([(max(a.start_ns, w0), min(a.end_ns, w1))
                   for a in activities if a.end_ns > w0 and a.start_ns < w1])
    edges = [w0] + [x for b in busy for x in b] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        i = find.at(a)
        kind = ("caller" if i < 0 else
                "wait" if spans[i].waits else "dispatch")
        rep.idle_class_ns[kind] += b - a
        if i >= 0:
            per = rep.idle_ns.setdefault(spans[i].name, {})
            per[kind] = per.get(kind, 0) + b - a
    rep.clock = _stop_check_clock(activities, owners, spans)
    return rep


def _stop_check_clock(activities, owners, spans) -> Dict[str, float]:
    """For each stop check that follows a segment: whether the end of the
    segment's longest activity (K2) lies inside the check, how far before
    the check's end (``lag``: within CLOCK_US?), and how far before it the
    last activity the check waited for ended (``last_lag``: the flag's
    copy, so the host's own wake-up)."""
    longest = {}
    for a, i in zip(activities, owners):
        if i >= 0 and spans[i].name == SEGMENT and (
                i not in longest or a.end_ns - a.start_ns
                > longest[i].end_ns - longest[i].start_ns):
            longest[i] = a
    ends = sorted(a.end_ns for a in activities)
    last_segment, lags, last_lags, inside = {}, [], [], 0
    for i, s in enumerate(spans):
        if s.name == SEGMENT:
            last_segment[s.parent] = i
        elif s.name == STOP_CHECK:
            j = last_segment.pop(s.parent, None)
            if j is None or j not in longest:
                continue
            end = longest[j].end_ns
            lags.append((s.end_ns - end) / 1e3)
            inside += s.start_ns <= end <= s.end_ns
            last = ends[bisect.bisect_right(ends, s.end_ns) - 1]
            last_lags.append((s.end_ns - last) / 1e3)
    if not lags:
        return {}
    lags.sort()
    last_lags.sort()
    mid = len(lags) // 2
    return {"checks": len(lags), "inside": inside,
            "within_us": sum(0 <= x <= CLOCK_US for x in lags),
            "lag_us_median": lags[mid], "lag_us_max": lags[-1],
            "last_within_us": sum(0 <= x <= CLOCK_US for x in last_lags),
            "last_lag_us_median": last_lags[mid],
            "last_lag_us_max": last_lags[-1]}


def activities_of(kineto_events, cuda: bool) -> List[Activity]:
    """The device's activities (but the spin kernels) with the host time
    of the runtime call that enqueued each (same correlation id); on the
    CPU each op's own start."""
    from torch.autograd import DeviceType
    device = DeviceType.CUDA if cuda else DeviceType.CPU
    calls = {}
    if cuda:
        for e in kineto_events:
            c = e.correlation_id()
            if e.device_type() == DeviceType.CPU and c:
                calls[c] = min(calls.get(c, e.start_ns()), e.start_ns())
    out = []
    for e in kineto_events:
        if e.device_type() != device or trace_mod.PAD_NAME in e.name():
            continue
        host = calls.get(e.correlation_id()) if cuda else e.start_ns()
        out.append(Activity(e.name(), e.start_ns(), e.end_ns(),
                            e.start_ns() if host is None else host))
    return out


@dataclass
class SpanTrace(trace_mod.Trace):
    """``trace.Trace`` with the spans' reading of the same pass."""
    spans: Optional[SpanReport] = None


def program_spans():
    """The program's span recorder, or None where it has none."""
    mod = importlib.import_module("recnet_tpu_torch.utils.profiling")
    return mod if hasattr(mod, "enable_spans") else None


def launch_counts() -> Dict[str, int]:
    out = {}
    for key, (module, fn) in COUNTERS.items():
        try:
            out[key] = getattr(importlib.import_module(module), fn).n_launches
        except (ImportError, AttributeError):
            pass
    return out


def span_cost_us(rec, n: int = 100_000) -> Dict[str, float]:
    """Host us a span costs on this host, off and on, in a plain loop
    (the recording is left off and empty)."""
    out = {}
    for state in ("off", "on"):
        if state == "on":
            rec.enable_spans(limit=n)
        t0 = time.perf_counter()
        for _ in range(n):
            with rec.span("cost"):
                pass
        out[state] = (time.perf_counter() - t0) / n * 1e6
        rec.disable_spans()
    rec.enable_spans()
    rec.disable_spans()
    return out


def _units(work: Dict) -> Tuple[str, float]:
    for key in ("captions", "train_steps"):
        if work.get(key):
            return key, work[key]
    return "", 0


def traced(run, device) -> trace_mod.Trace:
    """``trace.traced`` after a spans-only pass, with the spans on; the
    ``spans`` line printed. ``run`` is a cell's bound ``traced_calls``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rec = program_spans()
    if rec is None:
        return _PLAIN(run, device)
    cell = run.__self__
    cuda = device.type == "cuda"
    rec.enable_spans()
    t0 = time.perf_counter()
    run()
    only_s = time.perf_counter() - t0
    rec.disable_spans()
    only_spans, only_work = rec.spans(), dict(cell.counts()["trace"])
    only = attribute([], only_spans, (0, 0))

    before = launch_counts()
    rec.enable_spans()
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        if cuda:
            for _ in range(trace_mod.PAD_KERNELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        w0, t0 = time.time_ns(), time.perf_counter()
        run()
        window_s, w1 = time.perf_counter() - t0, time.time_ns()
    rec.disable_spans()
    spans, dropped = rec.spans(), rec.dropped_spans()
    after = launch_counts()
    base = trace_mod.read(prof.events(),
                          DeviceType.CUDA if cuda else DeviceType.CPU,
                          window_s)
    rep = attribute(activities_of(prof.profiler.kineto_results.events(),
                                  cuda), spans, (w0, w1))
    line = spans_line(rep, only, cell, only_s, only_work, dropped,
                      {k: after[k] - before.get(k, 0) for k in after})
    line["span_us"] = span_cost_us(rec)
    print("spans " + json.dumps(line), flush=True)
    return SpanTrace(**vars(base), spans=rep)


def spans_line(rep: SpanReport, only: SpanReport, cell, only_s: float,
               only_work: Dict, dropped: int, launches: Dict) -> Dict:
    """Per traced call: each span's count, host ms (spans-only pass,
    profiled pass), device ms it enqueued, idle ms at its start by class;
    the unclaimed device ms; the counters' deltas; the spans-only pass's
    time a unit of work against the untraced window's."""
    calls = cell.traffic["trace_calls"]
    ms = lambda ns: ns / 1e6 / calls
    names = sorted(set(rep.count) | set(only.count))
    line = {"calls": calls, "spans": {
        n: {"count": rep.count.get(n, 0) / calls,
            "host_ms": [ms(only.host_ns.get(n, 0)), ms(rep.host_ns.get(n, 0))],
            "device_ms": ms(rep.device_ns.get(n, 0)),
            "idle_ms": {k: ms(v) for k, v in rep.idle_ns.get(n, {}).items()}}
        for n in names}}
    line["idle_ms"] = {k: ms(v) for k, v in rep.idle_class_ns.items()}
    line["device_ms"] = ms(rep.device_total_ns)
    line["unclaimed_device_ms"] = ms(rep.unclaimed_ns)
    line["launches"] = launches
    line["dropped"] = dropped
    window = cell.counts()["window"]
    key, n = _units(window)
    _, m = _units(only_work)
    if n and m and window.get("elapsed_s"):
        per_window, per_only = window["elapsed_s"] / n, only_s / m
        line["rate"] = {"unit": key, "window_s": per_window,
                        "spans_only_s": per_only,
                        "cost": per_only / per_window - 1.0}
    if rep.clock:
        line["stop_check_clock"] = rep.clock
    return line


def _metric(name: str):
    return Manifest(ROOT).metric_module(name)


def phase_ms(r, span: str) -> Optional[float]:
    """Device ms a train step that ``span`` enqueued, or None."""
    rep = getattr(r.trace, "spans", None)
    steps = r.counts["trace"].get("train_steps")
    if rep is None or not steps or span not in rep.count:
        return None
    return rep.device_ns.get(span, 0) / 1e6 / steps


def decode_idle_share(r, kind: str) -> Optional[float]:
    """``idle_share.decode`` times the traced idle of class ``kind`` over
    all the traced idle, or None."""
    rep = getattr(r.trace, "spans", None)
    if rep is None or not r.counts["trace"].get("captions"):
        return None
    total = sum(rep.idle_class_ns.values())
    share = _metric("idle_share.decode").read(r)
    if share is None or total <= 0:
        return None
    return share * rep.idle_class_ns[kind] / total


class SpanManifest(Manifest):
    """The manifest with ``SPAN_METRICS`` among each cell's per-layer
    metrics."""

    def per_layer(self, workload: str) -> List[Dict]:
        return super().per_layer(workload) + [
            m for m in SPAN_METRICS if workload in m["workloads"]]


def run_cell(manifest: Manifest, workload: str, seed: int,
             seconds: float, device, program_root: Path = None) -> Dict:
    """``run.run_cell`` with the trace on, its traced part :func:`traced`
    and the span metrics added."""
    from h100_bench import run as run_mod
    trace_mod.traced = traced          # run_cell looks it up when it runs
    try:
        return run_mod.run_cell(SpanManifest(manifest.root), workload, seed,
                                seconds, True, device,
                                program_root=program_root)
    finally:
        trace_mod.traced = _PLAIN


def main(argv=None) -> int:
    import argparse
    import os

    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "build" / "h100_bench" / sub))
    manifest = Manifest(ROOT)
    chips = manifest.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"spans.py: {args.workload} needs {chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      "cuda")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
