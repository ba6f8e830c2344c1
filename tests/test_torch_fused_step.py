"""The fused attention + GRU step (K4) of the port against the JAX module:
its plain twin against the Pallas kernel in interpret mode and against the
plain restatement, and ``greedy_decode_pallas`` against JAX's.

Mirrors tests/test_pallas_fused.py:36-111. f32: rtol 2e-5, atol 2e-6, the
JAX test's own tolerance (the same casts, summed in another order); the
frame chunking changes only the order of the ctx sum: rtol 1e-6, atol 1e-7.
bf16: the twin rounds ctx and h' to bf16 where Pallas does, but a sum in
another order can put a stored value one bf16 ulp (2^-8 relative) apart;
rtol 2^-7, atol 1e-2 (2 ulps)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recnet_tpu import decoding as j_decoding
from recnet_tpu.models import decoder as j_dec
from recnet_tpu.ops import attention as j_attn
from recnet_tpu.ops.pallas import fused_step as j_fs
from recnet_tpu_torch import decoding as t_decoding
from recnet_tpu_torch.models import decoder as t_dec
from recnet_tpu_torch.ops.cuda import fused_step as fs
from recnet_tpu_torch.weights import params_from_jax

B, L, F, E, H, A, V = 16, 7, 24, 12, 16, 8, 40
MAX_LEN = 9
F32_TOL = dict(rtol=2e-5, atol=2e-6)


def _inputs(seed=0, b=B):
    """The JAX test's operands as numpy f32: emb, h, enc, uv, attn_w,
    attn_v, attn_b, w_ih, w_hh, b_ih, b_hh."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    emb, h, enc = mk(b, E), mk(b, H), mk(b, L, F)
    attn_w, attn_v = mk(H, A), mk(A, 1)
    attn_b = np.ones((1, A), np.float32)
    w_ih, w_hh, b_ih, b_hh = mk(E + F, 3 * H), mk(H, 3 * H), mk(3 * H), \
        mk(3 * H)
    uv = mk(b, L, A)
    return emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh, b_ih, b_hh


def _step_operands(arrays, jdtype=jnp.float32, tdtype=torch.float32):
    """(JAX operands, torch operands) of the fused step, bias packed."""
    *ops, b_ih, b_hh = arrays
    j_ops = [jnp.asarray(x, jdtype) for x in ops]
    j_ops.append(j_fs.pack_gru_bias(jnp.asarray(b_ih, jdtype),
                                    jnp.asarray(b_hh, jdtype)))
    t_ops = [torch.from_numpy(x).to(tdtype) for x in ops]
    t_ops.append(fs.pack_gru_bias(torch.from_numpy(b_ih).to(tdtype),
                                  torch.from_numpy(b_hh).to(tdtype)))
    return j_ops, t_ops


@pytest.mark.parametrize("frame_chunk", [1, 7])
def test_twin_matches_pallas_interpret(frame_chunk):
    j_ops, t_ops = _step_operands(_inputs())
    want = j_fs.fused_gru_attn_step(*j_ops, emb_size=E, block_b=8,
                                    frame_chunk=frame_chunk, interpret=True)
    got = fs.fused_gru_attn_step_reference(*t_ops, emb_size=E,
                                           frame_chunk=frame_chunk)
    assert got.shape == (B, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_twin_matches_plain_restatement():
    arrays = _inputs(seed=1)
    want = j_fs.gru_attn_step_reference(*map(jnp.asarray, arrays), E)
    tt = [torch.from_numpy(x) for x in arrays]
    plain = fs.gru_attn_step_reference(*tt, E)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **F32_TOL)
    _, t_ops = _step_operands(arrays)
    got = fs.fused_gru_attn_step_reference(*t_ops, emb_size=E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_frame_chunking_changes_only_the_sum_order():
    _, t_ops = _step_operands(_inputs(seed=4))
    base = fs.fused_gru_attn_step_reference(*t_ops, emb_size=E,
                                            frame_chunk=1)
    chunked = fs.fused_gru_attn_step_reference(*t_ops, emb_size=E,
                                               frame_chunk=7)
    np.testing.assert_allclose(chunked.numpy(), base.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_twin_bf16_at_rounding_level():
    j_ops, t_ops = _step_operands(_inputs(seed=2), jnp.bfloat16,
                                  torch.bfloat16)
    want = j_fs.fused_gru_attn_step(*j_ops, emb_size=E, block_b=8,
                                    interpret=True)
    got = fs.fused_gru_attn_step_reference(*t_ops, emb_size=E)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-2)


def test_twin_matches_jax_decoder_step():
    """Same math as JAX ``decoder_step`` (eval mode, GRU)."""
    cfg = j_dec.DecoderConfig(cell_type="GRU", vocab_size=V,
                              embedding_size=E, encoder_size=F,
                              hidden_size=H, attn_size=A)
    params = j_dec.init_decoder_params(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(1)
    enc = jnp.asarray(rng.standard_normal((B, L, F)).astype(np.float32))
    token = jnp.asarray(rng.integers(0, V, B).astype(np.int32))
    uv = j_attn.precompute_uv(params["attention"], enc)
    _, (h_new, _) = j_dec.decoder_step(params, cfg, token,
                                       j_dec.zero_state(cfg, B), enc, uv)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    a, r = tp["attention"], tp["rnn"][0]
    t_enc = torch.from_numpy(np.array(enc))
    t_uv = torch.from_numpy(np.array(uv))
    emb = tp["embedding"][torch.from_numpy(np.array(token)).long()]
    got = fs.fused_gru_attn_step(
        emb, torch.zeros((B, H)), t_enc, t_uv, a["W"], a["w"],
        a["b"][None, :], r["w_ih"], r["w_hh"],
        fs.pack_gru_bias(r["b_ih"], r["b_hh"]), emb_size=E)
    np.testing.assert_allclose(got.numpy(), np.asarray(h_new[0]), **F32_TOL)


def _decode_setup(seed, scale=1.0, cell="GRU", n_layers=1):
    kw = dict(cell_type=cell, n_layers=n_layers, vocab_size=V,
              embedding_size=E, embedding_scale=scale, encoder_size=F,
              hidden_size=H, attn_size=A)
    jcfg, tcfg = j_dec.DecoderConfig(**kw), t_dec.DecoderConfig(**kw)
    params = j_dec.init_decoder_params(jax.random.PRNGKey(seed), jcfg)
    params = dict(params, out_w=params["out_w"] * 8.0)  # EOS/PAD emission
    enc = np.random.default_rng(seed).standard_normal(
        (B, L, F)).astype(np.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jcfg, tcfg, params, tp, enc


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_greedy_decode_pallas_matches_jax(scale):
    jcfg, tcfg, params, tp, enc = _decode_setup(5, scale)
    j_enc = jnp.asarray(enc)
    pallas = j_decoding.greedy_decode_pallas(params, jcfg, j_enc, MAX_LEN,
                                             block_b=8, interpret=True)
    plain = j_decoding.greedy_decode(params, jcfg, j_enc, MAX_LEN)
    n = fs.fused_gru_attn_step.n_launches
    got = t_decoding.greedy_decode_pallas(tp, tcfg, torch.from_numpy(enc),
                                          MAX_LEN)
    assert fs.fused_gru_attn_step.n_launches == n   # the twin, on the CPU
    assert got.tokens.shape == (MAX_LEN + 1, B)
    assert got.tokens.dtype == torch.int32
    for want in (pallas, plain):
        assert got.n_steps == int(want.n_steps)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))


def test_greedy_decode_pallas_freezes_on_all_pad():
    """A model that emits <PAD> at once: n_steps 1 and a <PAD> tail, as
    JAX's."""
    jcfg, tcfg, params, tp, enc = _decode_setup(6)
    params = dict(params, out_b=params["out_b"].at[0].set(50.0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    want = j_decoding.greedy_decode_pallas(params, jcfg, jnp.asarray(enc),
                                           MAX_LEN, block_b=8,
                                           interpret=True)
    got = t_decoding.greedy_decode_pallas(tp, tcfg, torch.from_numpy(enc),
                                          MAX_LEN)
    assert got.n_steps == int(want.n_steps) == 1
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


@pytest.mark.parametrize("cell,n_layers", [("LSTM", 1), ("GRU", 2)])
def test_greedy_decode_pallas_takes_only_the_one_layer_gru(cell, n_layers):
    _, tcfg, _, tp, enc = _decode_setup(7, cell=cell, n_layers=n_layers)
    with pytest.raises(ValueError, match="1-layer GRU"):
        t_decoding.greedy_decode_pallas(tp, tcfg, torch.from_numpy(enc),
                                        MAX_LEN)


def test_wrapper_takes_the_twin_on_cpu():
    _, t_ops = _step_operands(_inputs(seed=8))
    n = fs.fused_gru_attn_step.n_launches
    got = fs.fused_gru_attn_step(*t_ops, emb_size=E, frame_chunk=7)
    want = fs.fused_gru_attn_step_reference(*t_ops, emb_size=E,
                                            frame_chunk=7)
    assert torch.equal(got, want)
    assert fs.fused_gru_attn_step.n_launches == n


def test_wrapper_raises_where_jax_asserts():
    _, t_ops = _step_operands(_inputs(seed=9))
    with pytest.raises(ValueError, match="frame_chunk"):
        fs.fused_gru_attn_step(*t_ops, emb_size=E, frame_chunk=2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fs.fused_gru_attn_step(*[t.half() for t in t_ops], emb_size=E)
    with pytest.raises(ValueError, match="w_ih is torch.bfloat16"):
        fs.fused_gru_attn_step(*t_ops[:7], t_ops[7].bfloat16(), *t_ops[8:],
                               emb_size=E)
    with pytest.raises(ValueError, match="bias3 has shape"):
        fs.fused_gru_attn_step(*t_ops[:9], t_ops[9][:, :-1], emb_size=E)
    with pytest.raises(ValueError, match="emb has shape"):
        fs.fused_gru_attn_step(*t_ops, emb_size=E + 1)
    with pytest.raises(ValueError, match="no fused-step route"):
        fs.fused_gru_attn_step(*[t.to("meta") for t in t_ops], emb_size=E)
