"""recnet_tpu_torch.models.decoder and the weight bridge against JAX, f32.

The JAX initialiser makes the weights; ``params_from_jax`` copies them.
Logits within rtol 1e-5 (atol 1e-5): the same f32 math, summed in another
order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recnet_tpu.models import decoder as j_dec
from recnet_tpu.ops import attention as j_attn
from recnet_tpu_torch.models import decoder as t_dec
from recnet_tpu_torch.ops import attention as t_attn
from recnet_tpu_torch.weights import (cast_params, params_from_jax,
                                      params_to_numpy, random_params)

B, L, F, E, H, A, V = 6, 7, 24, 12, 16, 8, 40
TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(cell, n_layers=1, seed=0, scale=1.0):
    kw = dict(cell_type=cell, n_layers=n_layers, vocab_size=V,
              embedding_size=E, embedding_scale=scale, encoder_size=F,
              hidden_size=H, attn_size=A)
    jcfg, tcfg = j_dec.DecoderConfig(**kw), t_dec.DecoderConfig(**kw)
    jp = j_dec.init_decoder_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, L, F)).astype(np.float32)
    token = rng.integers(0, V, B).astype(np.int32)
    state = (rng.standard_normal((2, n_layers, B, H)) * 0.5).astype(
        np.float32)
    return jcfg, tcfg, jp, tp, enc, token, state


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cell,n_layers", [("GRU", 1), ("LSTM", 1),
                                           ("GRU", 2), ("LSTM", 2)])
def test_decoder_step_matches_jax(cell, n_layers):
    jcfg, tcfg, jp, tp, enc, token, state = _setup(cell, n_layers, seed=1,
                                                   scale=0.5)
    j_uv = j_attn.precompute_uv(jp["attention"], jnp.asarray(enc))
    jl, (jh, jc) = j_dec.decoder_step(
        jp, jcfg, jnp.asarray(token), (jnp.asarray(state[0]),
                                       jnp.asarray(state[1])),
        jnp.asarray(enc), j_uv)
    t_enc = torch.from_numpy(enc)
    t_uv = t_attn.precompute_uv(tp["attention"], t_enc)
    tl, (th, tc) = t_dec.decoder_step(
        tp, tcfg, torch.from_numpy(token).long(),
        (torch.from_numpy(state[0]), torch.from_numpy(state[1])), t_enc, t_uv)
    _close(tl, jl)
    _close(th, jh)
    _close(tc, jc)


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_hoisted_step_matches_jax(cell):
    jcfg, tcfg, jp, tp, enc, token, state = _setup(cell, seed=2, scale=0.5)
    j_enc, t_enc = jnp.asarray(enc), torch.from_numpy(enc)
    j_tables = j_dec.hoisted_decode_tables(jp, jcfg, j_enc)
    t_tables = t_dec.hoisted_decode_tables(tp, tcfg, t_enc)
    for got, want in zip(t_tables, j_tables):
        _close(got, want)
    j_uv = j_attn.precompute_uv(jp["attention"], j_enc)
    t_uv = t_attn.precompute_uv(tp["attention"], t_enc)
    jh, (jhs, jcs) = j_dec.decoder_step_hoisted(
        jp, jcfg, jnp.asarray(token),
        (jnp.asarray(state[0]), jnp.asarray(state[1])), j_uv, *j_tables)
    th, (ths, tcs) = t_dec.decoder_step_hoisted(
        tp, tcfg, torch.from_numpy(token).long(),
        (torch.from_numpy(state[0]), torch.from_numpy(state[1])), t_uv,
        *t_tables)
    _close(th, jh)
    _close(tcs, jcs)
    # the hoisted step equals the plain step on the same inputs
    tl, (th2, _) = t_dec.decoder_step(
        tp, tcfg, torch.from_numpy(token).long(),
        (torch.from_numpy(state[0]), torch.from_numpy(state[1])), t_enc, t_uv)
    _close(th @ tp["out_w"] + tp["out_b"], tl.numpy())


def test_hoisted_tables_need_one_layer():
    _, tcfg, _, tp, enc, _, _ = _setup("GRU", n_layers=2)
    with pytest.raises(ValueError, match="1-layer"):
        t_dec.hoisted_decode_tables(tp, tcfg, torch.from_numpy(enc))


def test_decoder_module_forward_and_zero_state():
    jcfg, tcfg, jp, tp, enc, token, _ = _setup("LSTM", seed=3)
    dec = t_dec.Decoder(tcfg, tp)
    assert not any(p.requires_grad for p in dec.parameters())
    state = t_dec.zero_state(tcfg, B)
    j_state = j_dec.zero_state(jcfg, B)
    _close(state[0], j_state[0])
    t_enc = torch.from_numpy(enc)
    t_uv = t_attn.precompute_uv(dec.params()["attention"], t_enc)
    tl, _ = dec(torch.from_numpy(token).long(), state, t_enc, t_uv)
    j_uv = j_attn.precompute_uv(jp["attention"], jnp.asarray(enc))
    jl, _ = j_dec.decoder_step(jp, jcfg, jnp.asarray(token), j_state,
                               jnp.asarray(enc), j_uv)
    _close(tl, jl)


def test_params_from_jax_round_trip_is_bit_equal():
    _, _, jp, tp, _, _, _ = _setup("LSTM", n_layers=2, seed=4)
    back = params_to_numpy(tp)
    want = jax.tree_util.tree_map(np.asarray, jp)
    flat_back = jax.tree_util.tree_leaves(back)
    flat_want = jax.tree_util.tree_leaves(want)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(want))
    for got, exp in zip(flat_back, flat_want):
        assert got.dtype == exp.dtype and got.shape == exp.shape
        np.testing.assert_array_equal(got, exp)


def test_cast_params_matches_jax_bf16_cast():
    _, _, jp, tp, _, _, _ = _setup("GRU", seed=5)
    bf = cast_params(tp, "bfloat16")
    j_bf = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    np.testing.assert_array_equal(
        bf["out_w"].float().numpy(),
        np.asarray(j_bf["out_w"].astype(jnp.float32)))
    assert bf["rnn"][0]["w_ih"].dtype == torch.bfloat16
    assert params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           dtype="bfloat16")["embedding"].dtype \
        == torch.bfloat16
    with pytest.raises(ValueError, match="unsupported dtype"):
        cast_params(tp, "float16")


def test_config_from_train_matches_jax():
    from recnet_tpu.config import TrainConfig
    tc = TrainConfig(decoder_model="LSTM", embedding_scale=0.5)
    assert tuple(t_dec.config_from_train(tc, 77)) == tuple(
        j_dec.config_from_train(tc, 77))


def test_random_params_have_the_jax_shapes():
    tcfg = t_dec.DecoderConfig(cell_type="LSTM", n_layers=2, vocab_size=V,
                               embedding_size=E, encoder_size=F,
                               hidden_size=H, attn_size=A)
    jcfg = j_dec.DecoderConfig(*tcfg)
    want = j_dec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    got = random_params(tcfg, seed=0)
    assert (jax.tree_util.tree_map(np.shape, got)
            == jax.tree_util.tree_map(np.shape, want))
    np.testing.assert_array_equal(got["attention"]["b"], 1.0)
