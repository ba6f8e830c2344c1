"""The port's span recorder (``utils/profiling.py``): off by default and
free of records, nesting, ``waits``, its bound, its clock against
``torch.profiler``'s, the spans the train step and the decodes record, and
the operator's Chrome trace carrying them."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from recnet_tpu_torch import decoding
from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.models import decoder as dec_mod
from recnet_tpu_torch.training import step as step_mod
from recnet_tpu_torch.utils import profiling as prof

TINY = dict(caption_max_len=7, batch_size=4, embedding_size=12,
            encoder_output_size=20, encoder_output_len=5,
            decoder_hidden_size=16, decoder_attn_size=8,
            reconstructor_hidden_size=20, reconstructor_attn_size=8)
VOCAB = 30


@pytest.fixture(autouse=True)
def spans_off():
    prof.disable_spans()
    yield
    prof.disable_spans()


def _recorded(fn, **kw):
    prof.enable_spans(**kw)
    try:
        fn()
    finally:
        prof.disable_spans()
    return prof.spans()


def _names(spans, parent=None):
    return [s.name for s in spans if parent is None or s.parent == parent]


def test_off_records_nothing_and_returns_the_shared_object():
    prof.enable_spans()
    with prof.span("kept"):
        pass
    prof.disable_spans()
    first = prof.span("a")
    assert first is prof.span("b", waits=True)
    with first:
        with prof.span("c"):
            pass
    assert _names(prof.spans()) == ["kept"]


def test_nesting_gives_parents_and_waits_and_thread():
    def run():
        with prof.span("a"):
            with prof.span("b"):
                with prof.span("c", waits=True):
                    pass
            with prof.span("d"):
                pass
        with prof.span("e"):
            pass

    spans = _recorded(run)
    assert _names(spans) == ["a", "b", "c", "d", "e"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1]
    assert [s.waits for s in spans] == [False, False, True, False, False]
    assert {s.thread for s in spans} == {threading.get_ident()}
    for s in spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_threads_keep_their_own_parents():
    gate = threading.Barrier(2)

    def worker(tag):
        with prof.span(f"{tag}.outer"):
            gate.wait(timeout=10)
            with prof.span(f"{tag}.inner"):
                gate.wait(timeout=10)

    def run():
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in ("x", "y")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()

    spans = _recorded(run)
    assert len(spans) == 4
    for s in spans:
        if s.name.endswith("inner"):
            p = spans[s.parent]
            assert p.name == s.name.replace("inner", "outer")
            assert p.thread == s.thread
        else:
            assert s.parent == -1


def test_the_bound_counts_dropped_spans_and_clear_empties():
    def run():
        for i in range(5):
            with prof.span(f"s{i}"):
                pass
        assert prof.dropped_spans() == 2
        prof.clear_spans()
        assert prof.spans() == [] and prof.dropped_spans() == 0
        with prof.span("after"):
            pass

    assert _names(_recorded(run, limit=3)) == ["after"]


def test_a_span_still_open_is_not_listed():
    prof.enable_spans()
    with prof.span("open"):
        with prof.span("closed"):
            pass
        spans = prof.spans()
    assert [(s.name, s.parent) for s in spans] == [("closed", -1)]
    assert _names(prof.spans()) == ["open", "closed"]


def test_parents_follow_nesting_at_equal_clock_readings(monkeypatch):
    """A coarse clock gives a span and the one inside it the same start
    and end; the one that closed later is the parent."""
    monkeypatch.setattr(prof.time, "time_ns", lambda: 7)
    spans = _recorded(lambda: _nest(3))
    assert [(s.name, s.parent) for s in spans] == [
        ("d0", -1), ("d1", 0), ("d2", 1)]


def _nest(depth, i=0):
    if i < depth:
        with prof.span(f"d{i}"):
            _nest(depth, i + 1)


def test_spans_share_the_profilers_clock():
    """A ``record_function`` event of a CPU-only profile lies inside the
    program span around it, on ``time_ns``, to within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function
    prof.enable_spans()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.span("outer"):
            time.sleep(0.002)
            with record_function("inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.002)
    outer, = prof.spans()
    inner, = [e for e in p.profiler.kineto_results.events()
              if e.name() == "inner"]
    slack = 1_000_000
    assert outer.start_ns - slack <= inner.start_ns() <= outer.end_ns
    assert outer.start_ns <= inner.end_ns() <= outer.end_ns + slack


def _train_setup(k):
    tc = TrainConfig(**TINY, use_recon=True, reconstructor_type="global",
                     steps_per_dispatch=k)
    state, dcfg, rcfg = step_mod.init_train_state(0, tc, VOCAB, "cpu")
    rng = np.random.default_rng(0)
    T = tc.caption_max_len + 1
    cache = torch.from_numpy(rng.standard_normal(
        (10, tc.encoder_output_len, tc.encoder_output_size)
    ).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, 10, (k, tc.batch_size)))
    caps = np.zeros((k, T, tc.batch_size), np.int32)
    caps[:, :3] = rng.integers(3, VOCAB, (k, 3, tc.batch_size))
    caps[:, 3] = 2
    fn = step_mod.build_train_multi_step_cached(tc, dcfg, rcfg, k)
    return lambda: fn(state, cache, rows, torch.from_numpy(caps))


def test_train_call_records_its_steps_and_phases():
    spans = _recorded(_train_setup(2))
    call, = [i for i, s in enumerate(spans) if s.name == "train.call"]
    assert spans[call].parent == -1
    steps = [i for i, s in enumerate(spans) if s.name == "train.step"]
    assert len(steps) == 2
    for i in steps:
        assert spans[i].parent == call
        assert _names(spans, parent=i) == [
            "train.forward", "train.backward", "train.optimizer"]
    assert len(spans) == 1 + 2 * 4


def _decode_setup(B=3, seed=4):
    tc = TrainConfig(**TINY)
    dcfg = dec_mod.config_from_train(tc, VOCAB)
    params = dec_mod.init_decoder_params(
        torch.Generator().manual_seed(seed), dcfg)
    enc = torch.randn(B, tc.encoder_output_len, tc.encoder_output_size,
                      generator=torch.Generator().manual_seed(seed + 1))
    return params, dcfg, enc, tc.caption_max_len


@pytest.mark.parametrize("early_exit", [False, True])
def test_beam_decode_records_each_step(early_exit):
    params, dcfg, enc, max_len = _decode_setup()
    res = []
    spans = _recorded(lambda: res.append(decoding.beam_decode(
        params, dcfg, enc, 3, max_len, early_exit=early_exit)))
    top, = [i for i, s in enumerate(spans) if s.name == "decode.beam"]
    steps = [i for i, s in enumerate(spans) if s.name == "decode.beam_step"]
    assert len(steps) == res[0].n_steps if early_exit else max_len + 1
    for i in steps:
        assert spans[i].parent == top
        assert _names(spans, parent=i) == [
            "decode.beam_cell", "decode.beam_topk", "decode.beam_select"]
    below = _names(spans, parent=top)
    assert below[0] == "decode.prepare" and below[-1] == "decode.n_steps"
    checks = [s for s in spans if s.name == "decode.stop_check"]
    assert len(checks) == (len(steps) + (len(steps) <= max_len)
                           if early_exit else 0)
    waits = {s.name for s in spans if s.waits}
    assert waits == ({"decode.n_steps", "decode.stop_check"} if early_exit
                     else {"decode.n_steps"})


@pytest.mark.parametrize("segment", [2, 3])
def test_segmented_greedy_records_segments_and_waits(segment):
    params, dcfg, enc, max_len = _decode_setup()
    res = []
    spans = _recorded(lambda: res.append(
        decoding.greedy_decode_whole_segmented(
            params, dcfg, enc, max_len, segment=segment, eos_stop=True)))
    top, = [i for i, s in enumerate(spans) if s.name == "decode.greedy"]
    below = _names(spans, parent=top)
    assert below[0] == "decode.prepare" and below[-1] == "decode.n_steps"
    middle = below[1:-1]
    n_seg = middle.count("decode.segment")
    assert n_seg >= 1
    # a stop check before each segment, and one more where the loop broke
    assert middle[: 2 * n_seg] == ["decode.stop_check",
                                   "decode.segment"] * n_seg
    assert middle[2 * n_seg:] in ([], ["decode.stop_check"])
    whole = -(-(max_len + 1) // segment)
    assert (middle[2 * n_seg:] == []) == (n_seg == whole)
    assert {s.name for s in spans if s.waits} == {"decode.stop_check",
                                                 "decode.n_steps"}
    assert res[0].n_steps <= n_seg * segment


def test_spans_off_leave_the_decodes_unrecorded():
    params, dcfg, enc, max_len = _decode_setup()
    prof.enable_spans()
    prof.disable_spans()
    decoding.beam_decode(params, dcfg, enc, 2, max_len)
    decoding.greedy_decode_whole_segmented(params, dcfg, enc, max_len,
                                           segment=4)
    assert prof.spans() == []


def test_the_profile_trace_holds_the_train_steps(tmp_path):
    call = _train_setup(1)
    trace = prof.start_trace()
    call()
    path = prof.stop_trace(trace, str(tmp_path))
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"]
    steps = [e for e in events
             if e.get("name") == "train.step" and e.get("cat") == "span"]
    assert len(steps) == 1
    step = steps[0]
    assert step["ph"] == "X" and step["pid"] == prof.SPAN_TRACK
    # on the trace's time base: the step holds the ops it ran
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops
    inside = [e for e in ops
              if step["ts"] <= e["ts"] <= step["ts"] + step["dur"]]
    assert len(inside) >= len(ops) // 2
    assert prof.span("after") is prof.span("off")
