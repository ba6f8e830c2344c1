"""``spans.py``: device activities put down to the program's spans by
correlation id, idle gaps by the span open at their start, the three decode
shares summing to ``idle_share.decode``, the span metrics reading nothing
without spans, and a cell run through it on the CPU."""

from __future__ import annotations

import math
import types

import pytest
from torch.autograd import DeviceType

from h100_bench import spans as spans_mod
from h100_bench import trace as trace_mod
from h100_bench.manifest import Manifest
from h100_bench.tests import tiny

MAIN, AUTOGRAD = 11, 22


def span(name, start, end, parent=-1, waits=False, thread=MAIN):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end,
                                 parent=parent, waits=waits, thread=thread)


class Event:
    """A Kineto event as ``prof.profiler.kineto_results.events()`` gives
    it."""

    def __init__(self, name, device, start, end, corr, thread=1):
        self._v = (name, device, start, end, corr, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def cpu(name, start, end, corr, thread=1):
    return Event(name, DeviceType.CPU, start, end, corr, thread)


def gpu(name, start, end, corr):
    return Event(name, DeviceType.CUDA, start, end, corr)


# a step: forward launches on the main thread, backward's launches come
# from autograd's thread while the main thread sits in train.backward
STEP = [span("train.step", 0, 1000),
        span("train.forward", 10, 300, parent=0),
        span("train.backward", 300, 700, parent=0),
        span("train.optimizer", 700, 990, parent=0)]
EVENTS = [
    cpu("cudaLaunchKernel", 20, 25, 1), gpu("fwd_gemm", 30, 320, 1),
    cpu("Runtime Triggered Module Loading", 21, 24, 1),
    cpu("cudaLaunchKernel", 310, 315, 2, thread=9),
    gpu("bwd_gemm", 320, 600, 2),
    cpu("cuLaunchKernel", 650, 655, 3, thread=9),
    gpu("indexing_backward_kernel", 660, 800, 3),
    cpu("cudaLaunchKernel", 710, 712, 4), gpu("adam", 800, 850, 4),
    cpu("cudaLaunchKernel", 1100, 1101, 5), gpu("after", 1105, 1110, 5),
    gpu("spin_kernel", 0, 5, 6),
]


def test_activities_take_their_runtime_calls_host_time_across_threads():
    acts = spans_mod.activities_of(EVENTS, cuda=True)
    assert [(a.name, a.host_ns) for a in acts] == [
        ("fwd_gemm", 20), ("bwd_gemm", 310),
        ("indexing_backward_kernel", 650), ("adam", 710), ("after", 1100)]
    rep = spans_mod.attribute(acts, STEP, (0, 1200))
    assert rep.device_ns == {"train.forward": 290, "train.backward": 280 + 140,
                             "train.optimizer": 50}
    assert rep.unclaimed_ns == 5
    assert rep.device_total_ns == 290 + 280 + 140 + 50 + 5
    assert rep.count == {"train.step": 1, "train.forward": 1,
                         "train.backward": 1, "train.optimizer": 1}
    assert rep.host_ns["train.backward"] == 400


def test_on_the_cpu_an_op_is_its_own_host_time():
    ops = [Event("aten::mm", DeviceType.CPU, 320, 400, 0)]
    acts = spans_mod.activities_of(ops, cuda=False)
    assert [(a.name, a.host_ns) for a in acts] == [("aten::mm", 320)]
    rep = spans_mod.attribute(acts, STEP, (0, 1000))
    assert rep.device_ns == {"train.backward": 80}


def test_innermost_span_at_boundaries_and_across_threads():
    spans = [span("a", 0, 100), span("b", 10, 50, parent=0),
             span("c", 50, 60, parent=0), span("x", 40, 80, thread=AUTOGRAD)]
    find = spans_mod.Innermost(spans)
    got = {t: find.at(t) for t in (0, 9, 10, 40, 49, 50, 59, 60, 80, 99,
                                   100, 200)}
    assert got == {0: 0, 9: 0, 10: 1, 40: 3, 49: 3, 50: 2, 59: 2, 60: 3,
                   80: 0, 99: 0, 100: -1, 200: -1}


def test_idle_gaps_are_classed_by_the_span_open_at_their_start():
    spans = [span("decode.greedy", 0, 240),
             span("decode.segment", 5, 20, parent=0),
             span("decode.stop_check", 20, 160, parent=0, waits=True),
             span("decode.segment", 160, 170, parent=0)]
    acts = [spans_mod.Activity("k2", 10, 50, 6),
            spans_mod.Activity("copy", 60, 150, 8),
            spans_mod.Activity("k2", 210, 260, 161)]
    rep = spans_mod.attribute(acts, spans, (0, 300))
    # [0, 10) in decode.greedy; [50, 60), [150, 210) in the stop check;
    # [260, 300) after every span closed
    assert rep.idle_class_ns == {"dispatch": 10, "wait": 10 + 60,
                                 "caller": 40}
    assert rep.idle_ns == {"decode.greedy": {"dispatch": 10},
                           "decode.stop_check": {"wait": 70}}
    assert sum(rep.idle_class_ns.values()) == 300 - 40 - 90 - 50


def test_the_stop_check_clock():
    spans = [span("decode.greedy", 0, 1000),
             span("decode.segment", 10, 20, parent=0),
             span("decode.stop_check", 30, 515, parent=0, waits=True),
             span("decode.segment", 520, 530, parent=0),
             span("decode.stop_check", 540, 900_000, parent=0, waits=True)]
    acts = [spans_mod.Activity("k2", 40, 500, 12),
            spans_mod.Activity("tokens", 500, 505, 15),
            spans_mod.Activity("k2", 600, 800, 522)]
    clock = spans_mod.attribute(acts, spans, (0, 1000)).clock
    assert clock["checks"] == 2 and clock["inside"] == 2
    assert clock["within_us"] == 1
    assert clock["lag_us_max"] == pytest.approx((900_000 - 800) / 1e3)
    # the first check's last activity is the copy ending at 505
    assert clock["last_within_us"] == 1
    assert clock["last_lag_us_max"] == pytest.approx((900_000 - 800) / 1e3)


def _reading(trace, window_idle=20.0):
    """A decode cell's reading whose idle_share.decode is
    ``window_idle`` %."""
    captions = 1000
    busy_a_caption = trace.busy_s / captions
    elapsed = busy_a_caption * captions / (1 - window_idle / 100)
    return types.SimpleNamespace(
        trace=trace, config={}, traffic={}, vocab=10,
        counts={"window": {"captions": captions, "elapsed_s": elapsed},
                "trace": {"captions": captions}})


METRICS = [m["name"] for m in spans_mod.SPAN_METRICS]


def _read(name, r):
    return Manifest(tiny.REPO).metric_module(name).read(r)


def test_the_decode_shares_sum_to_idle_share_decode():
    rep = spans_mod.SpanReport(idle_class_ns={"wait": 7, "dispatch": 2,
                                              "caller": 1})
    trace = spans_mod.SpanTrace(window_s=1.0, busy_s=0.5, spans=rep)
    r = _reading(trace)
    whole = _read("idle_share.decode", r)
    parts = [_read(f"idle_share.decode.{k}", r) for k in spans_mod.CLASSES]
    assert whole == pytest.approx(20.0)
    assert parts == pytest.approx([14.0, 4.0, 2.0])
    assert math.isclose(sum(parts), whole, rel_tol=1e-12)


def test_train_phases_read_device_ms_a_step():
    rep = spans_mod.SpanReport(
        count={"train.forward": 4, "train.backward": 4,
               "train.optimizer": 4},
        device_ns={"train.forward": 8_000_000, "train.backward": 16_000_000})
    r = types.SimpleNamespace(
        trace=spans_mod.SpanTrace(window_s=1.0, busy_s=0.9, spans=rep),
        counts={"trace": {"train_steps": 4}})
    assert [_read(f"{p}_ms.train", r)
            for p in ("forward", "backward", "optimizer")] == [2.0, 4.0, 0.0]


@pytest.mark.parametrize("name", METRICS)
def test_span_metrics_read_nothing_without_spans(name):
    plain = trace_mod.Trace(window_s=1.0, busy_s=0.5)
    r = _reading(plain)
    r.counts["trace"]["train_steps"] = 3
    assert _read(name, r) is None


@pytest.mark.parametrize("entry", spans_mod.SPAN_METRICS, ids=METRICS)
def test_span_metric_modules_declare_their_entry(entry):
    module = Manifest(tiny.REPO).metric_module(entry["name"])
    assert (module.UNIT, module.LAYER, module.MOVES, module.SOURCE) == (
        entry["unit"], entry["layer"], entry["moves"], entry["source"])
    cells = {w["name"] for w in Manifest(tiny.REPO).data["workloads"]}
    assert set(entry["workloads"]) <= cells


@pytest.mark.parametrize("workload", ["msvd-global-train-f32-b1024",
                                      "msvd-global-greedy-b1024"])
def test_a_cell_through_spans_reports_the_span_metrics(tmp_path, capsys,
                                                       workload):
    manifest = tiny.tiny_manifest(tmp_path)
    result = spans_mod.run_cell(manifest, workload, 2 ** 31 + 5, 0.2, "cpu",
                                program_root=tiny.REPO)
    assert trace_mod.traced is spans_mod._PLAIN
    out = capsys.readouterr().out.splitlines()
    heads = [line.split(" ", 1)[0] for line in out]
    assert heads.index("window") < heads.index("spans")
    line = __import__("json").loads(out[heads.index("spans")][6:])
    m = result["metrics"]
    if "train" in workload:
        for phase in ("forward", "backward", "optimizer"):
            assert f"train.{phase}" in line["spans"]
            assert m[f"{phase}_ms.train"]["value"] >= 0
        assert line["spans"]["train.step"]["count"] == tiny.TRAIN[
            "steps_per_call"]
    else:
        assert "decode.segment" in line["spans"]
        parts = [m[f"idle_share.decode.{k}"]["value"]
                 for k in spans_mod.CLASSES]
        assert sum(parts) == pytest.approx(m["idle_share.decode"]["value"])
    assert line["rate"]["spans_only_s"] > 0 and line["dropped"] == 0
    assert 0 < line["span_us"]["off"] < line["span_us"]["on"]
    assert result["correct"]


def test_a_program_without_spans_is_traced_as_before(tmp_path, capsys,
                                                     monkeypatch):
    """Over a checkout whose program records no spans, the trace is
    ``trace.traced``'s and the span metrics are left out."""
    monkeypatch.setattr(spans_mod, "program_spans", lambda: None)
    manifest = tiny.tiny_manifest(tmp_path)
    result = spans_mod.run_cell(manifest, "msvd-global-beam5-b1024",
                                2 ** 31 + 7, 0.2, "cpu",
                                program_root=tiny.REPO)
    out = capsys.readouterr().out.splitlines()
    assert not [line for line in out if line.startswith("spans ")]
    assert not set(METRICS) & set(result["metrics"])
    assert "idle_share.decode" in result["metrics"]
