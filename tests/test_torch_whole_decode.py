"""The plain twins of the whole-decode kernels K1/K2 against the Pallas
kernels run in interpret mode, and the wrappers' routing on the CPU.

f32: tokens equal, h and c within rtol 1e-5 (atol 1e-6): the same casts,
summed in another order. bf16: the twin rounds h, c and ctx to bf16 where
Pallas does, but XLA and PyTorch may order the f32 sums differently, so a
stored bf16 value can land one bf16 ulp (2^-8 relative) apart and shift a
near-tied argmax later on; the bf16 case holds the first steps' tokens equal
and h within 2 bf16 ulps (rtol 2^-7, atol 1e-2)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recnet_tpu.models import decoder as j_dec
from recnet_tpu.ops import attention as j_attn
from recnet_tpu.ops.pallas.whole_decode import (whole_greedy_decode,
                                                whole_greedy_decode_segment)
from recnet_tpu_torch.ops.cuda import whole_decode as wd
from recnet_tpu_torch.weights import params_from_jax

B, L, F, E, H, A, V = 16, 7, 24, 12, 16, 8, 40
MAX_LEN = 9


def _setup(cell, seed=9, dtype=jnp.float32, peaky=True):
    cfg = j_dec.DecoderConfig(cell_type=cell, vocab_size=V, embedding_size=E,
                              encoder_size=F, hidden_size=H, attn_size=A)
    params = j_dec.init_decoder_params(jax.random.PRNGKey(seed), cfg)
    if peaky:                                  # force EOS/PAD emission
        params = dict(params, out_w=params["out_w"] * 8.0)
    params = jax.tree_util.tree_map(lambda x: x.astype(dtype), params)
    rng = np.random.default_rng(seed)
    enc = jnp.asarray(rng.standard_normal((B, L, F)), dtype)
    return cfg, params, enc


def _operands(params, enc):
    """The Pallas operands, and the same arrays as CPU tensors."""
    uv = j_attn.precompute_uv(params["attention"], enc)
    r = params["rnn"][0]
    bias2 = jnp.stack([r["b_ih"], r["b_hh"]])
    to_t = lambda x: torch.from_numpy(
        np.array(x.astype(jnp.float32))).to(_torch_dtype(x))
    tp = params_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32)), params),
        dtype=_torch_dtype(enc))
    return (params, enc, uv, bias2), (tp, to_t(enc), to_t(uv), to_t(bias2))


def _torch_dtype(x):
    return torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_k1_twin_matches_pallas(cell):
    cfg, params, enc = _setup(cell)
    j_ops, t_ops = _operands(params, enc)
    want = whole_greedy_decode(*j_ops, emb_size=E, max_len=MAX_LEN,
                               block_b=8, cell_type=cell, interpret=True)
    got = wd.whole_greedy_decode_reference(*t_ops, emb_size=E,
                                           max_len=MAX_LEN, cell_type=cell)
    assert got.dtype == torch.int32 and got.shape == (B, MAX_LEN + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
@pytest.mark.parametrize("seg_len", [1, 4, 8])
def test_k2_twin_matches_pallas(cell, seg_len):
    """Two chained segments from SOS: tokens equal, carried h, c, token
    within rtol 1e-5."""
    cfg, params, enc = _setup(cell, seed=3)
    j_ops, t_ops = _operands(params, enc)
    jh = jnp.zeros((B, H), jnp.float32)
    jtok = jnp.full((B, 1), cfg.sos_token, jnp.int32)
    th = torch.zeros((B, H))
    ttok = torch.full((B, 1), cfg.sos_token, dtype=torch.int32)
    j_state, t_state = (jh, jh, jtok), (th, th, ttok)
    for _ in range(2):
        j_out = whole_greedy_decode_segment(
            *j_ops, *j_state, emb_size=E, seg_len=seg_len, block_b=8,
            cell_type=cell, interpret=True)
        t_out = wd.whole_greedy_decode_segment_reference(
            *t_ops, *t_state, emb_size=E, seg_len=seg_len, cell_type=cell)
        np.testing.assert_array_equal(t_out[0].numpy(), np.asarray(j_out[0]))
        for got, want in zip(t_out[1:3], j_out[1:3]):
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(t_out[3].numpy(), np.asarray(j_out[3]))
        j_state, t_state = j_out[1:], t_out[1:]


def test_k2_segments_chain_to_k1():
    """K2 run in segments from SOS gives K1's tokens (the segment tail
    runs past T and is cut)."""
    cfg, params, enc = _setup("LSTM", seed=5)
    _, t_ops = _operands(params, enc)
    full = wd.whole_greedy_decode_reference(*t_ops, emb_size=E,
                                            max_len=MAX_LEN, cell_type="LSTM")
    state = (torch.zeros((B, H)), torch.zeros((B, H)),
             torch.full((B, 1), cfg.sos_token, dtype=torch.int32))
    segs = []
    for _ in range(3):                         # 3 x 4 = 12 >= T = 10
        out = wd.whole_greedy_decode_segment_reference(
            *t_ops, *state, emb_size=E, seg_len=4, cell_type="LSTM")
        segs.append(out[0])
        state = out[1:]
    np.testing.assert_array_equal(
        torch.cat(segs, 1)[:, :MAX_LEN + 1].numpy(), full.numpy())


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_k1_twin_bf16_at_rounding_level(cell):
    cfg, params, enc = _setup(cell, seed=4, dtype=jnp.bfloat16, peaky=False)
    j_ops, t_ops = _operands(params, enc)
    want = np.asarray(whole_greedy_decode(
        *j_ops, emb_size=E, max_len=MAX_LEN, block_b=8, cell_type=cell,
        interpret=True))
    got = wd.whole_greedy_decode_reference(
        *t_ops, emb_size=E, max_len=MAX_LEN, cell_type=cell).numpy()
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    assert (got == want).mean() >= 0.9
    # the carried state after a 3-step segment, at rounding level
    jz = jnp.zeros((B, H), jnp.bfloat16)
    jtok = jnp.full((B, 1), cfg.sos_token, jnp.int32)
    j_out = whole_greedy_decode_segment(
        *j_ops, jz, jz, jtok, emb_size=E, seg_len=3, block_b=8,
        cell_type=cell, interpret=True)
    tz = torch.zeros((B, H), dtype=torch.bfloat16)
    t_out = wd.whole_greedy_decode_segment_reference(
        *t_ops, tz, tz, torch.from_numpy(np.array(jtok)), emb_size=E,
        seg_len=3, cell_type=cell)
    np.testing.assert_allclose(_np(t_out[1]),
                               np.asarray(j_out[1].astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-2)


def test_k1_twin_ties_pick_first_index():
    """Zero projection weights and a duplicated maximum in out_b: every
    token is the first index of the max, as in the Pallas kernel."""
    cfg, params, enc = _setup("GRU", seed=0, peaky=False)
    out_b = np.full((V,), -1.0, np.float32)
    out_b[[5, 17]] = 2.5
    params = dict(params, out_w=jnp.zeros_like(params["out_w"]),
                  out_b=jnp.asarray(out_b))
    j_ops, t_ops = _operands(params, jnp.zeros_like(enc))
    want = whole_greedy_decode(*j_ops, emb_size=E, max_len=3, block_b=8,
                               cell_type="GRU", interpret=True)
    got = wd.whole_greedy_decode_reference(*t_ops, emb_size=E, max_len=3)
    assert (np.asarray(want) == 5).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_intkey_argmax_orders_negative_zero_below_positive_zero():
    """The int key orders -0.0 < +0.0 (torch.argmax treats them equal)."""
    logits = torch.tensor([[-0.0, 0.0, -1.0], [0.0, -0.0, 0.0],
                           [-3.0, 7.0, 7.0]])
    np.testing.assert_array_equal(wd._intkey_argmax(logits).numpy(),
                                  [[1], [0], [1]])


def test_embedding_scale_multiplies_the_gathered_row():
    """emb_scale=1.0 is the Pallas step exactly; another scale equals
    decoding with a pre-scaled embedding table."""
    cfg, params, enc = _setup("GRU", seed=6)
    _, t_ops = _operands(params, enc)
    tp = dict(t_ops[0])
    scaled = dict(tp, embedding=tp["embedding"] * 0.5)
    got = wd.whole_greedy_decode_reference(tp, *t_ops[1:], emb_size=E,
                                           max_len=MAX_LEN, emb_scale=0.5)
    want = wd.whole_greedy_decode_reference(scaled, *t_ops[1:], emb_size=E,
                                            max_len=MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_wrappers_take_the_twin_on_cpu_and_count_no_launch():
    cfg, params, enc = _setup("GRU", seed=7)
    _, t_ops = _operands(params, enc)
    k1, k2 = wd.whole_greedy_decode, wd.whole_greedy_decode_segment
    n1, n2 = k1.n_launches, k2.n_launches
    got = k1(*t_ops, emb_size=E, max_len=MAX_LEN)
    want = wd.whole_greedy_decode_reference(*t_ops, emb_size=E,
                                            max_len=MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    z = torch.zeros((B, H))
    tok = torch.full((B, 1), cfg.sos_token, dtype=torch.int32)
    seg = k2(*t_ops, z, z, tok, emb_size=E, seg_len=4)
    np.testing.assert_array_equal(seg[0].numpy(), want[:, :4].numpy())
    assert (k1.n_launches, k2.n_launches) == (n1, n2)


def test_wrapper_refuses_a_device_without_a_route():
    _, params, enc = _setup("GRU", seed=8)
    _, t_ops = _operands(params, enc)
    meta = [t.to("meta") for t in t_ops[1:]]
    with pytest.raises(ValueError, match="no whole-decode route"):
        wd.whole_greedy_decode(t_ops[0], *meta, emb_size=E, max_len=MAX_LEN)
