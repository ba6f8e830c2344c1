"""The plain reference against the program at a size the CPU holds: sound
runs come out correct, the control (the reference in TF32 in the
program's place) and every fault a cell can have come out not correct,
under the cells' own limits."""

from __future__ import annotations

import math

import pytest
import torch

from h100_bench import calibrate, oracle
from h100_bench import run as run_mod
from h100_bench.reference.recnet import Products, tf32_round
from h100_bench.tests import tiny

WORKLOADS = ["msvd-global-train-f32-b1024", "msvd-local-train-f32-b1024",
             "msvd-global-greedy-b1024", "msvd-global-beam5-b1024"]
TRAIN = WORKLOADS[:2]
# decoding's control needs near-ties to flip: the vocabulary and the steps
# of the configuration, a narrower decoder
DECODE_WIDTHS = dict(tiny.WIDTHS, decoder_hidden_size=64, vocab_size=4188,
                     caption_max_len=30)
DECODE_TRAFFIC = dict(tiny.CAPTION, batch_size=64, sample_rows=128)


@pytest.fixture
def manifest(tmp_path, monkeypatch):
    monkeypatch.setattr(tiny, "CAPTION", DECODE_TRAFFIC)
    return tiny.tiny_manifest(tmp_path)


@pytest.fixture
def decode_manifest(tmp_path, monkeypatch):
    monkeypatch.setattr(tiny, "CAPTION", DECODE_TRAFFIC)
    return tiny.tiny_manifest(tmp_path, DECODE_WIDTHS)


def run(manifest, workload, seed=2 ** 31 + 5, trace=False):
    return run_mod.run_cell(manifest, workload, seed, 0.2, trace, "cpu",
                            program_root=tiny.REPO)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_runs_are_correct(manifest, workload):
    result = run(manifest, workload)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


def _readings(manifest, workload, seed, monkeypatch):
    monkeypatch.setattr(run_mod, "_program_in",
                        lambda root, f=run_mod._program_in: f(tiny.REPO))
    return calibrate.readings(manifest, workload, seed, True, "cpu")


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload", TRAIN)
def test_training_control_and_faults_are_not_correct(manifest, workload,
                                                     seed, monkeypatch):
    out = _readings(manifest, workload, seed, monkeypatch)
    limits = manifest.limits(workload)
    assert oracle.judge(out["program"], limits)[0]
    for stand_in in ("control_tf32", "fault_half_batch",
                     "fault_state_unchanged"):
        assert not oracle.judge(out[stand_in], limits)[0], stand_in
    assert out["fault_state_unchanged"]["change_gap"] == 1.0


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload", WORKLOADS[2:])
def test_decoding_control_and_fault_are_not_correct(decode_manifest,
                                                    workload, seed,
                                                    monkeypatch):
    out = _readings(decode_manifest, workload, seed, monkeypatch)
    limits = decode_manifest.limits(workload)
    assert oracle.judge(out["program"], limits)[0]
    for stand_in in ("control_tf32", "fault_token_altered"):
        assert not oracle.judge(out[stand_in], limits)[0], stand_in


def _state_unchanged(monkeypatch):
    """Each train step puts the parameters back as they were."""
    from recnet_tpu_torch.training import step as step_mod
    real = step_mod._make_step_fn

    def make(*args, **kw):
        step_fn = real(*args, **kw)

        def fn(state, videos, captions):
            leaves = [p for opt in (state.dec_opt, state.rec_opt)
                      for p in opt.param_groups[0]["params"]]
            kept = [p.detach().clone() for p in leaves]
            out = step_fn(state, videos, captions)
            with torch.no_grad():
                for p, k in zip(leaves, kept):
                    p.copy_(k)
            return out
        return fn
    monkeypatch.setattr(step_mod, "_make_step_fn", make)


def _half_batch(monkeypatch):
    """Each call leaves out half of every batch; the means run over the
    rest."""
    from recnet_tpu_torch.training import step as step_mod
    real = step_mod.build_train_multi_step_cached

    def build(*args, **kw):
        fn = real(*args, **kw)
        return lambda state, cache, rows, caps: fn(
            state, cache, rows[:, : rows.shape[1] // 2],
            caps[:, :, : caps.shape[2] // 2])
    monkeypatch.setattr(step_mod, "build_train_multi_step_cached", build)


def _greedy_token_altered(monkeypatch):
    """K2 serves every row's first token of each segment altered."""
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    real = wd.whole_greedy_decode_segment

    def segment(*args, **kw):
        tokens, h, c, tok = real(*args, **kw)
        tokens = tokens.clone()
        tokens[:, 0] = (tokens[:, 0] + 1) % args[0]["out_b"].shape[0]
        return tokens, h, c, tok
    monkeypatch.setattr(wd, "whole_greedy_decode_segment", segment)


def _beam_token_altered(monkeypatch):
    """The beam search serves every row's sixth word altered."""
    from recnet_tpu_torch import decoding
    real = decoding.beam_decode

    def beam(*args, **kw):
        res = real(*args, **kw)
        tokens = res.tokens.clone()
        tokens[:, 5] = (tokens[:, 5] + 1) % args[0]["out_b"].shape[0]
        return res._replace(tokens=tokens)
    monkeypatch.setattr(decoding, "beam_decode", beam)


@pytest.mark.parametrize("workload,fault", [
    (TRAIN[0], _state_unchanged), (TRAIN[0], _half_batch),
    (TRAIN[1], _state_unchanged), (TRAIN[1], _half_batch),
    (WORKLOADS[2], _greedy_token_altered),
    (WORKLOADS[3], _beam_token_altered)],
    ids=["global-state-unchanged", "global-half-batch",
         "local-state-unchanged", "local-half-batch",
         "greedy-token-altered", "beam-token-altered"])
def test_a_run_with_the_timed_path_broken_is_not_correct(manifest, workload,
                                                         fault, monkeypatch):
    assert run(manifest, workload)["correct"]
    fault(monkeypatch)
    result = run(manifest, workload)
    assert not result["correct"], result["checks"]


def test_tf32_round_keeps_ten_mantissa_bits_nearest_even():
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10
    cases = [(1 + ulp / 2, 1.0), (1 + 3 * ulp / 2, 1 + 2 * ulp),
             (1 + ulp / 2 + 2 ** -20, 1 + ulp), (-(1 + 3 * ulp / 2),
                                                  -(1 + 2 * ulp))]
    for x, want in cases:
        assert float(tf32_round(one * x)) == want, x


def test_tf32_products_differ_from_f32_in_both_directions():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(8, 64, generator=g, requires_grad=True)
    b = torch.randn(64, 16, generator=g, requires_grad=True)
    f32, tf32 = Products("float32"), Products("tf32")
    ya, yb = f32.mm(a, b), tf32.mm(a, b)
    ga = torch.autograd.grad(ya.square().sum(), a)[0]
    gb = torch.autograd.grad(yb.square().sum(), a)[0]
    for x, y in ((ya.detach(), yb.detach()), (ga, gb)):
        assert 0 < float((x - y).abs().max() / x.abs().max()) < 1e-2


def test_norm_gap_takes_the_worst_leaf_over_the_larger_scale():
    ref = {"dec/a": 1.0, "dec/b": 3.0, "dec/c": 1e-9, "rec/x": 10.0}
    prog = dict(ref, **{"dec/b": 3.3, "dec/c": 2e-9})
    # dec/b: 0.3 / 3; dec/c: 1e-9 over the median leaf of dec (1.0)
    assert math.isclose(oracle.norm_gap(prog, ref, ref), 0.1)
    assert oracle.moved_leaves(ref) == ["dec/a", "dec/b", "rec/x"]
    assert oracle.norm_gap({}, ref, ref) == math.inf


def test_gaps_along_served_tokens():
    ref = torch.tensor([[[0.0, 2.0, 1.0, 0.5]]])          # (1, 1, V)
    best, second = torch.tensor([[1]]), torch.tensor([[2]])
    assert oracle.greedy_gap(ref, best, [1]) == 0.0
    assert oracle.greedy_gap(ref, second, [1]) == 1.0
    assert oracle.topk_gap(ref, second, 2) == 0.0
    assert oracle.topk_gap(ref, torch.tensor([[3]]), 2) == 0.5
    ctl = torch.tensor([[[0.0, 2.0, 0.4, 0.5]]])
    assert oracle.control_topk_gap(ref, ctl, 2) == 0.5
    eos = 2
    lengths = oracle.served_lengths(
        torch.tensor([[5, 2, 7], [5, 6, 7]]).numpy(), eos)
    assert list(lengths) == [2, 3]
    ok, rows = oracle.judge({"a": 1.0}, {"a": {"limit": 2.0}})
    assert ok and rows == [("a", 1.0, 2.0)]
    assert not oracle.judge({}, {"a": {"limit": 2.0}})[0]
