"""The port's training forward against the JAX package on the CPU: the
losses, the teacher-forced rollouts, the reconstructors, the gradients of
the joint forward, and the statistics of the initialisers and dropout
(JAX's draws cannot be reproduced)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recnet_tpu.models import decoder as j_dec
from recnet_tpu.models import reconstructors as j_rec
from recnet_tpu.ops import losses as j_losses
from recnet_tpu.training import step as j_step
from recnet_tpu_torch.models import decoder as t_dec
from recnet_tpu_torch.models import reconstructors as t_rec
from recnet_tpu_torch.ops import losses as t_losses
from recnet_tpu_torch.training import step as t_step
from recnet_tpu_torch.utils.misc import tree_leaves
from recnet_tpu_torch.weights import params_from_jax

from torch_train_fixtures import (NO_DROPOUT, VOCAB, batch, both_states,
                                  configs, t)

torch.backends.cuda.matmul.allow_tf32 = False
# the largest |port - jax| / max|jax| over every gradient leaf of the 12
# cases below (GRU/LSTM, generic and fast rollouts, no recon / global /
# local) measured 6.2e-7 on a CPU through autograd over plain loops, and
# 5.3e-7 with the fast rollout and the one-layer global reconstructor on
# their custom-backward Functions; the bound leaves 8x room for other
# summation orders
GRAD_REL_BOUND = 5e-6


def test_step_mean_ce_l2_norm_sum_and_mse_match_jax():
    rng = np.random.default_rng(0)
    T, B, V = 6, 5, 11
    logits = rng.standard_normal((T, B, V)).astype(np.float32) * 3
    targets = rng.integers(0, V, (T, B)).astype(np.int32)
    mask = rng.random((T, B)) < 0.6
    mask[2] = False                       # a step with an all-zero mask
    mask[-2:] = False
    want, want_n = j_losses.step_mean_ce(jnp.asarray(logits),
                                         jnp.asarray(targets),
                                         jnp.asarray(mask))
    got, got_n = t_losses.step_mean_ce(t(logits), t(targets), t(mask))
    assert abs(float(got) - float(want)) <= 1e-6
    assert float(got_n) == float(want_n)
    # all-zero mask: 0 loss, 0 tokens, no NaN
    z, zn = t_losses.step_mean_ce(t(logits), t(targets),
                                  torch.zeros((T, B), dtype=torch.bool))
    assert float(z) == 0.0 and float(zn) == 0.0
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [{"c": rng.standard_normal(7).astype(np.float32)}]}
    assert abs(float(t_losses.l2_norm_sum(params_from_jax(tree)))
               - float(j_losses.l2_norm_sum(tree))) <= 1e-6
    pred, target = logits[0] / 6, logits[1] / 6    # an O(1) loss
    assert abs(float(t_losses.mse(t(pred), t(target)))
               - float(j_losses.mse(jnp.asarray(pred),
                                    jnp.asarray(target)))) <= 1e-6


def _decoder(cell, n_layers, seed=0):
    jtc, ttc = configs(decoder_model=cell, decoder_n_layers=n_layers)
    dcfg = j_dec.config_from_train(jtc, VOCAB)
    jp = j_dec.init_decoder_params(jax.random.PRNGKey(seed), dcfg)
    return dcfg, t_dec.config_from_train(ttc, VOCAB), jp, params_from_jax(jp)


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_rollouts_match_jax_in_eval_mode(cell, n_layers):
    dcfg, tcfg, jp, tp = _decoder(cell, n_layers)
    jtc, _ = configs()
    videos, captions = batch(np.random.default_rng(1), jtc)
    runs = [(j_dec.teacher_forced_rollout(jp, dcfg, jnp.asarray(videos),
                                          jnp.asarray(captions),
                                          jnp.asarray(tf)),
             t_dec.teacher_forced_rollout(tp, tcfg, t(videos), t(captions),
                                          tf))
            for tf in (False, True)]
    runs.append((j_dec.teacher_forced_rollout_fast(
        jp, dcfg, jnp.asarray(videos), jnp.asarray(captions)),
        t_dec.teacher_forced_rollout_fast(tp, tcfg, t(videos),
                                          t(captions))))
    for want, got in runs:
        for name in ("logits", "hiddens"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(got.greedy_tokens.numpy(),
                                      np.asarray(want.greedy_tokens))
    # the fast rollout is the generic one with teacher forcing on
    np.testing.assert_allclose(runs[2][1].logits.numpy(),
                               runs[1][1].logits.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind,n_layers", [("global", 1), ("global", 2),
                                           ("local", 1)])
def test_reconstructor_losses_match_jax(kind, n_layers):
    jtc, ttc = configs(kind, reconstructor_n_layers=n_layers)
    jcfg, tcfg = j_rec.config_from_train(jtc), t_rec.config_from_train(ttc)
    jp = j_rec.init_reconstructor_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)
    T = jtc.caption_max_len + 1
    hiddens = np.tanh(rng.standard_normal(
        (T, 1, jtc.batch_size, jtc.decoder_hidden_size))).astype(np.float32)
    enc = rng.standard_normal((jtc.batch_size, jtc.encoder_output_len,
                               jtc.encoder_output_size)).astype(np.float32)
    step_mask = np.ones(T, np.float32)
    step_mask[-3:] = 0.0
    t_eff = np.float32(step_mask.sum())
    want = j_rec.recon_loss(jp, jcfg, jnp.asarray(hiddens), jnp.asarray(enc),
                            jnp.asarray(step_mask), jnp.asarray(t_eff))
    got = t_rec.recon_loss(params_from_jax(jp), tcfg, t(hiddens), t(enc),
                           t(step_mask), torch.tensor(t_eff))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _grad_case(cell, recon, fast):
    jtc, ttc = configs(recon, decoder_model=cell, **NO_DROPOUT)
    jstate, dcfg, rcfg, tstate = both_states(jtc, ttc)
    videos, captions = batch(np.random.default_rng(5), jtc)
    pad = jtc.init_word2idx_dict["<PAD>"]
    args = (pad, jtc.lambda_recon, jtc.decoder_lambda_reg,
            jtc.reconstructor_lambda_reg)
    rec_j = jstate.rec_params if recon else None

    def j_loss(dp, rp):
        return j_step._forward(dp, rp, dcfg, rcfg, *args,
                               jnp.asarray(videos), jnp.asarray(captions),
                               jnp.asarray(True), None, False,
                               always_tf=fast)[0]
    want_total, (jg_dec, jg_rec) = jax.value_and_grad(
        j_loss, argnums=(0, 1))(jstate.dec_params, rec_j)
    tdcfg = t_dec.config_from_train(ttc, VOCAB)
    trcfg = t_rec.config_from_train(ttc) if recon else None
    total, _ = t_step._forward(
        tstate.dec_params, tstate.rec_params, tdcfg, trcfg, *args, t(videos),
        t(captions), True, None, False, always_tf=fast)
    total.backward()
    pairs = [(p.grad, g) for p, g in zip(
        tree_leaves(tstate.dec_params), jax.tree_util.tree_leaves(jg_dec))]
    if recon:
        pairs += [(p.grad, g) for p, g in zip(
            tree_leaves(tstate.rec_params),
            jax.tree_util.tree_leaves(jg_rec))]
    return float(total), float(want_total), pairs


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
@pytest.mark.parametrize("recon", [None, "global", "local"])
@pytest.mark.parametrize("fast", [False, True], ids=["generic", "fast"])
def test_forward_gradients_match_jax_grad(cell, recon, fast):
    """The port's gradients against jax.grad of the JAX ``_forward``: its
    custom-backward Functions where the JAX package takes its custom VJPs
    (the fast rollout; the one-layer global reconstructor), autograd over
    plain loops elsewhere."""
    got, want, pairs = _grad_case(cell, recon, fast)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(pairs) == (21 if recon == "local" else 17 if recon else 11)
    for i, (a, b) in enumerate(pairs):
        a, b = a.numpy(), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-30)
        rel = np.abs(a - b).max() / scale
        assert rel <= GRAD_REL_BOUND, f"leaf {i}: {rel:.3g}"


def test_dropout_keeps_the_rate_and_scales():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    for rate in (0.1, 0.5):
        y = t_dec._dropout(x, rate, g, train=True)
        kept = (y != 0).float().mean().item()
        assert abs(kept - (1 - rate)) < 5e-3
        assert torch.allclose(y[y != 0], torch.tensor(1 / (1 - rate)))
    assert t_dec._dropout(x, 0.5, g, train=False) is x
    assert t_dec._dropout(x, 0.5, None, train=True) is x
    # a fresh mask per call: the global reconstructor's per-step masks
    a = t_dec._dropout(x[:1000], 0.5, g, True)
    b = t_dec._dropout(x[:1000], 0.5, g, True)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("recon", [None, "global", "local"])
def test_init_distributions_and_shapes_match_jax(recon):
    jtc, ttc = configs(recon, decoder_hidden_size=64, embedding_size=48,
                       reconstructor_hidden_size=96)
    jstate, _, _ = j_step.init_train_state(jax.random.PRNGKey(0), jtc, 300)
    tstate, _, _ = t_step.init_train_state(0, ttc, 300, "cpu")
    again, _, _ = t_step.init_train_state(0, ttc, 300, "cpu")
    trees = [(tstate.dec_params, jstate.dec_params, again.dec_params)]
    if recon:
        trees.append((tstate.rec_params, jstate.rec_params,
                      again.rec_params))
    for port, ref, same in trees:
        for a, b, c in zip(tree_leaves(port), jax.tree_util.tree_leaves(ref),
                           tree_leaves(same)):
            a, b = a.detach().numpy(), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(torch.from_numpy(a), c.detach())  # seeded
            if a.size < 500:
                continue
            # the same law: uniform leaves share their bound, the
            # embedding is N(0, 1); moments within sampling error
            assert abs(a.mean() - b.mean()) < 0.1 * b.std() + 1e-3
            np.testing.assert_allclose(a.std(), b.std(), rtol=0.1)
            if np.abs(b).max() < 1.0:
                np.testing.assert_allclose(np.abs(a).max(), np.abs(b).max(),
                                           rtol=0.05)
    np.testing.assert_array_equal(
        tstate.dec_params["attention"]["b"].detach().numpy(), 1.0)
