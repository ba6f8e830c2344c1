"""The port's train and val steps against the JAX package's on the CPU:
three-step trajectories from the same state (no recon, global, local; the
clip firing), the val step's tokens, and the step variants (k steps per
call, the device feature cache, its bf16 storage, bf16 compute)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recnet_tpu.training import optim as j_optim
from recnet_tpu.training import step as j_step
from recnet_tpu_torch.checkpoint import state_leaves
from recnet_tpu_torch.models import decoder as t_dec
from recnet_tpu_torch.models import reconstructors as t_rec
from recnet_tpu_torch.training import optim as t_optim
from recnet_tpu_torch.training import step as t_step
from recnet_tpu_torch.utils.misc import tree_leaves

from torch_train_fixtures import (NO_DROPOUT, VOCAB, assert_trees_close,
                                  batch, both_states, configs, t)

torch.backends.cuda.matmul.allow_tf32 = False


def _port_cfgs(ttc):
    return (t_dec.config_from_train(ttc, VOCAB),
            t_rec.config_from_train(ttc) if ttc.use_recon else None)


@pytest.mark.parametrize("recon,clip", [(None, 50.0), ("global", 50.0),
                                        ("local", 50.0), ("global", 0.05)],
                         ids=["none", "global", "local", "global-clip"])
def test_three_steps_match_jax(recon, clip):
    """Dropout 0, teacher forcing 1.0, AMSGrad on for the decoder: each
    step's losses (and grad_norm), then every leaf of the state (params and
    both Adam states)."""
    jtc, ttc = configs(recon, gradient_clip=clip, decoder_use_amsgrad=True,
                       **NO_DROPOUT)
    jstate, dcfg, rcfg, tstate = both_states(jtc, ttc)
    j_fn = j_step.build_train_step(jtc, dcfg, rcfg)
    t_fn = t_step.build_train_step(ttc, *_port_cfgs(ttc))
    rng = np.random.default_rng(11)
    key = jax.random.PRNGKey(3)
    for i in range(3):
        videos, captions = batch(rng, jtc)
        jstate, jm = j_fn(jstate, jnp.asarray(videos), jnp.asarray(captions),
                          key)
        tm = t_fn(tstate, t(videos), t(captions))
        for name in ("loss", "dec_loss", "rec_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {name}")
        assert float(tm["n_tokens"]) == float(jm["n_tokens"])
        if clip < 1.0:
            assert float(jm["grad_norm"]) > clip     # the clip fired
    assert tstate.step == int(jstate.step) == 3
    leaves = state_leaves(tstate)
    want = jax.tree_util.tree_leaves(jstate)
    assert_trees_close(leaves, want, rtol=1e-4, atol=1e-6, what=str(recon))


def test_clip_coefficient_matches_jax_just_above_the_limit():
    rng = np.random.default_rng(2)
    grads = {"a": rng.standard_normal((5, 3)).astype(np.float32),
             "b": [rng.standard_normal(4).astype(np.float32)]}
    norm = float(np.sqrt(sum(np.square(g).sum()
                             for g in jax.tree_util.tree_leaves(grads))))
    for limit in (norm * (1 - 1e-4), norm * 0.5, norm * 2):
        want, want_norm = j_optim.clip_by_global_norm(grads, limit)
        params = {"a": torch.zeros(5, 3, requires_grad=True),
                  "b": [torch.zeros(4, requires_grad=True)]}
        for p, g in zip(tree_leaves(params),
                        jax.tree_util.tree_leaves(grads)):
            p.grad = t(g).clone()
        got_norm = t_optim.clip_by_global_norm(params, limit)
        np.testing.assert_allclose(float(got_norm), float(want_norm),
                                   rtol=1e-6)
        for p, g in zip(tree_leaves(params),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(g),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("recon", ["global", "local"])
def test_val_step_matches_jax(recon):
    """Teacher forcing off, eval mode: the greedy tokens equal JAX's."""
    jtc, ttc = configs(recon)
    jstate, dcfg, rcfg, tstate = both_states(jtc, ttc, seed=4)
    videos, captions = batch(np.random.default_rng(8), jtc)
    jm = j_step.build_val_step(jtc, dcfg, rcfg)(
        jstate.dec_params, jstate.rec_params, jnp.asarray(videos),
        jnp.asarray(captions))
    tm = t_step.build_val_step(ttc, *_port_cfgs(ttc))(
        tstate.dec_params, tstate.rec_params, t(videos), t(captions))
    np.testing.assert_array_equal(tm["greedy_tokens"].numpy(),
                                  np.asarray(jm["greedy_tokens"]))
    for name in ("loss", "dec_loss", "rec_loss"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5, err_msg=name)


def _fresh(ttc, seed=0):
    state, dcfg, rcfg = t_step.init_train_state(seed, ttc, VOCAB, "cpu")
    return state, dcfg, rcfg


def _equal_states(a, b):
    for x, y in zip(state_leaves(a), state_leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_k_steps_per_call_equal_single_steps():
    """Dropout on: the draws depend on the step only, so one k = 2 call
    equals two single steps bit for bit."""
    _, ttc = configs("global")
    a, dcfg, rcfg = _fresh(ttc)
    b, _, _ = _fresh(ttc)
    rng = np.random.default_rng(9)
    batches = [batch(rng, ttc) for _ in range(2)]
    single = t_step.build_train_step(ttc, dcfg, rcfg)
    ms = [single(a, t(v), t(c)) for v, c in batches]
    multi = t_step.build_train_multi_step(ttc, dcfg, rcfg, 2)
    mk = multi(b, t(np.stack([v for v, _ in batches])),
               t(np.stack([c for _, c in batches])))
    assert a.step == b.step == 2
    for i, m in enumerate(ms):
        assert float(mk["loss"][i]) == float(m["loss"])
    _equal_states(a, b)


@pytest.mark.parametrize("k", [1, 2])
def test_cached_step_equals_uncached(k):
    _, ttc = configs("global")
    a, dcfg, rcfg = _fresh(ttc)
    b, _, _ = _fresh(ttc)
    rng = np.random.default_rng(7)
    cache = rng.standard_normal((10, ttc.encoder_output_len,
                                 ttc.encoder_output_size)).astype(np.float32)
    rows = rng.integers(0, 10, (k, ttc.batch_size)).astype(np.int32)
    caps = np.stack([batch(rng, ttc)[1] for _ in range(k)])
    if k == 1:
        plain = t_step.build_train_step(ttc, dcfg, rcfg)
        cached = t_step.build_train_step_cached(ttc, dcfg, rcfg)
        ma = plain(a, t(cache[rows[0]]), t(caps[0]))
        mb = cached(b, t(cache), t(rows[0]), t(caps[0]))
    else:
        plain = t_step.build_train_multi_step(ttc, dcfg, rcfg, k)
        cached = t_step.build_train_multi_step_cached(ttc, dcfg, rcfg, k)
        ma = plain(a, t(cache[rows]), t(caps))
        mb = cached(b, t(cache), t(rows), t(caps))
    assert torch.equal(ma["loss"], mb["loss"])
    _equal_states(a, b)


def test_bf16_cache_equals_prerounded_rows():
    """A bfloat16 feature cache is the float32 step on once-rounded
    features: gather, then widen."""
    _, ttc = configs("global")
    a, dcfg, rcfg = _fresh(ttc)
    b, _, _ = _fresh(ttc)
    rng = np.random.default_rng(11)
    cache = torch.from_numpy(rng.standard_normal(
        (10, ttc.encoder_output_len, ttc.encoder_output_size)
    ).astype(np.float32)).to(torch.bfloat16)
    rows = torch.from_numpy(rng.integers(0, 10, ttc.batch_size))
    caps = t(batch(rng, ttc)[1])
    ma = t_step.build_train_step(ttc, dcfg, rcfg)(a, cache[rows].float(),
                                                  caps)
    mb = t_step.build_train_step_cached(ttc, dcfg, rcfg)(b, cache, rows, caps)
    assert float(ma["loss"]) == float(mb["loss"])
    _equal_states(a, b)


def test_bf16_step_stays_close_to_f32():
    """train_precision='bfloat16': autocast over float32 masters tracks
    the float32 recipe over five steps (as the JAX package's
    test_bf16_close_to_f32_early_trajectory), and the masters and the
    Adam state stay float32."""
    rng = np.random.default_rng(1)
    videos, captions = batch(rng, configs()[1])
    losses = {}
    for prec in ("float32", "bfloat16"):
        _, ttc = configs("global", train_precision=prec, **NO_DROPOUT)
        state, dcfg, rcfg = _fresh(ttc)
        fn = t_step.build_train_step(ttc, dcfg, rcfg)
        losses[prec] = np.asarray([float(fn(state, t(videos),
                                            t(captions))["loss"])
                                   for _ in range(5)])
        _, mu, nu, _ = t_optim.adam_state(state.dec_opt)
        assert all(x.dtype == torch.float32 for x in
                   tree_leaves(state.dec_params) + mu + nu)
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"],
                               rtol=0.05)
    assert losses["float32"][-1] < losses["float32"][0]


def test_teacher_forcing_draws_follow_the_ratio_and_the_step():
    draws = [t_step._step_draws(1, s, 0.3, "cpu")[0] for s in range(3000)]
    assert abs(np.mean(draws) - 0.3) < 0.03
    # a function of (seed, step): a resumed run draws the same
    assert draws[:50] == [t_step._step_draws(1, s, 0.3, "cpu")[0]
                          for s in range(50)]
    g1 = t_step._step_draws(1, 7, 0.3, "cpu")[1]
    g2 = t_step._step_draws(1, 7, 0.3, "cpu")[1]
    assert torch.equal(torch.rand(8, generator=g1),
                       torch.rand(8, generator=g2))


def test_ratio_below_one_takes_the_generic_rollout_with_dropout():
    """Ratio 0.5 with dropout on: the same state and batch give the same
    losses twice (the draws are seeded), and training moves the loss."""
    _, ttc = configs("local", decoder_teacher_forcing_ratio=0.5)
    runs = []
    for _ in range(2):
        state, dcfg, rcfg = _fresh(ttc)
        fn = t_step.build_train_step(ttc, dcfg, rcfg)
        videos, captions = batch(np.random.default_rng(3), ttc)
        runs.append([float(fn(state, t(videos), t(captions))["loss"])
                     for _ in range(4)])
    assert runs[0] == runs[1]
    assert np.isfinite(runs[0]).all()


def test_invalid_train_precision_rejected():
    _, ttc = configs(train_precision="bf16")
    _, dcfg, rcfg = _fresh(configs()[1])
    with pytest.raises(ValueError, match="train_precision"):
        t_step.build_train_step(ttc, dcfg, rcfg)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_step.init_train_state(0, configs()[1], VOCAB, "cuda")
