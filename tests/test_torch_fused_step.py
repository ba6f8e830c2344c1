"""The fused attention + GRU step (K4) of the port against the JAX module:
its plain twin against the Pallas kernel in interpret mode and against the
plain restatement, the plain stages of its tensor-core route (the gate
operand X, then the gate product over the gate tiles with the GRU cell)
and of its TF32 route (the same in f32, X in k8 steps, the products in
three TF32 terms) against both, the rule that picks the body, and
``greedy_decode_pallas`` against JAX's, with plain products and with the
TF32 route's.

Mirrors tests/test_pallas_fused.py:36-111. f32: rtol 2e-5, atol 2e-6, the
JAX test's own tolerance (the same casts, summed in another order); the
frame chunking changes only the order of the ctx sum: rtol 1e-6, atol 1e-7.
bf16: the twin rounds ctx and h' to bf16 where Pallas does, but a sum in
another order can put a stored value one bf16 ulp (2^-8 relative) apart;
rtol 2^-7, atol 1e-2 (2 ulps). The TF32 route's stages: rtol 1e-4, atol
1e-5 (TF32_TOL), the bound chip_smoke.py holds the card's h to: three
TF32 terms err about 2^-21 of a product, and the sums run in another
order."""

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
from recnet_tpu_torch.ops.cuda import layout
from recnet_tpu_torch.ops.cuda import whole_decode as wd
from recnet_tpu_torch.weights import params_from_jax

B, L, F, E, H, A, V = 16, 7, 24, 12, 16, 8, 40
MAX_LEN = 9
F32_TOL = dict(rtol=2e-5, atol=2e-6)
TF32_TOL = dict(rtol=1e-4, atol=1e-5)
TOP2_MARGIN = 1e-3


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


def test_wrapper_options_keep_the_twin_on_cpu():
    """``tiles`` and ``cuda_cores`` choose a body on the card only."""
    _, t_ops = _step_operands(_inputs(seed=10))
    n, bodies = (fs.fused_gru_attn_step.n_launches,
                 dict(fs.fused_gru_attn_step.body_launches))
    want = fs.fused_gru_attn_step_reference(*t_ops, emb_size=E)
    tiles = layout.gate_tiles(t_ops[7], t_ops[8], 3)
    for kw in (dict(tiles=tiles), dict(cuda_cores=True)):
        assert torch.equal(fs.fused_gru_attn_step(*t_ops, emb_size=E, **kw),
                           want)
    assert fs.fused_gru_attn_step.n_launches == n
    assert dict(fs.fused_gru_attn_step.body_launches) == bodies


@pytest.mark.parametrize("dtype,hidden,cuda_cores,body", [
    (torch.bfloat16, 512, False, "tensor_cores"),
    (torch.bfloat16, 16, False, "tensor_cores"),
    (torch.bfloat16, 24, False, "cuda_cores"),
    (torch.bfloat16, 512, True, "cuda_cores"),
    (torch.float32, 512, False, "tf32"),
    (torch.float32, 16, True, "cuda_cores"),
    (torch.float32, 16, False, "tf32"),
    (torch.float32, 24, False, "cuda_cores"),
    (torch.float32, 512, True, "cuda_cores"),
])
def test_step_body_rule(dtype, hidden, cuda_cores, body):
    """bf16 in 16-unit tiles takes the tensor-core route and f32 in 16-unit
    tiles the TF32 route, as K1's bodies do; other shapes and
    ``cuda_cores`` take the CUDA-core body."""
    assert fs.step_body(dtype, hidden, cuda_cores) == body
    assert (fs.step_body(dtype, hidden, cuda_cores) == "tensor_cores") == (
        wd._tensor_cores(dtype, hidden) and not cuda_cores)
    assert (fs.step_body(dtype, hidden, cuda_cores) == "tf32") == (
        wd._tf32(dtype, hidden) and not cuda_cores)


# the tensor-core route's two stages: L = 28 frames (every frame_chunk of
# the Pallas tests), E + F = 36 (a ragged k16 step), B = 13 (ragged)
S_B, S_L = 13, 28


def _stage_operands(seed, dtype=torch.float32, jdtype=jnp.float32):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    arrays = (mk(S_B, E), mk(S_B, H), mk(S_B, S_L, F), mk(S_B, S_L, A),
              mk(H, A), mk(A, 1), np.ones((1, A), np.float32),
              mk(E + F, 3 * H), mk(H, 3 * H), mk(3 * H), mk(3 * H))
    return _step_operands(arrays, jdtype, dtype)


def _stages(t_ops, frame_chunk):
    """h' through the plain restatements of the route's two kernels."""
    emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh, bias3 = t_ops
    x = fs.attention_pass_reference(emb, h, enc, uv, attn_w, attn_v, attn_b,
                                    frame_chunk=frame_chunk)
    return fs.gate_cell_reference(x, layout.gate_tiles(w_ih, w_hh, 3), bias3)


@pytest.mark.parametrize("frame_chunk", [1, 4, 7, 28])
def test_stages_match_twin(frame_chunk):
    """The same products as the twin, summed in another order (k16 steps
    of the gate tiles): F32_TOL."""
    _, t_ops = _stage_operands(20 + frame_chunk)
    want = fs.fused_gru_attn_step_reference(*t_ops, emb_size=E,
                                            frame_chunk=frame_chunk)
    got = _stages(t_ops, frame_chunk)
    assert got.shape == (S_B, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


@pytest.mark.parametrize("frame_chunk", [1, 4, 7, 28])
def test_stages_match_pallas_interpret(frame_chunk):
    """Against JAX's kernel in interpret mode, B = 13 in one tile."""
    j_ops, t_ops = _stage_operands(30 + frame_chunk)
    want = j_fs.fused_gru_attn_step(*j_ops, emb_size=E, block_b=S_B,
                                    frame_chunk=frame_chunk, interpret=True)
    got = _stages(t_ops, frame_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("frame_chunk", [1, 7])
def test_stages_bf16_at_rounding_level(frame_chunk):
    j_ops, t_ops = _stage_operands(40 + frame_chunk, torch.bfloat16,
                                   jnp.bfloat16)
    want = j_fs.fused_gru_attn_step(*j_ops, emb_size=E, block_b=S_B,
                                    frame_chunk=frame_chunk, interpret=True)
    got = _stages(t_ops, frame_chunk)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_operand_layout(dtype):
    """X = [emb, ctx, zero pad to 48 columns, h]: emb and h exact, ctx the
    twin's ctx / L cast to dtype; its columns are the rows of the gate
    tiles (the gate product over the tiles equals [emb, ctx] W_ih and
    h W_hh)."""
    _, t_ops = _stage_operands(50, dtype)
    emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh, bias3 = t_ops
    x = fs.attention_pass_reference(emb, h, enc, uv, attn_w, attn_v, attn_b,
                                    frame_chunk=4)
    assert fs.gate_width(E + F, H) == 48 + H
    assert x.shape == (S_B, 48 + H) and x.dtype == dtype
    assert torch.equal(x[:, :E], emb) and torch.equal(x[:, -H:], h)
    assert not x[:, E + F:48].any()
    ctx = sum(sum((torch.tanh(h.float() @ attn_w.float()
                              + uv[:, f].float() + attn_b[0].float())
                   @ attn_v.float()) * enc[:, f].float()
                  for f in range(j, j + 4)) for j in range(0, S_L, 4))
    torch.testing.assert_close(x[:, E:E + F].float(),
                               (ctx / S_L).to(dtype).float(),
                               rtol=2.0 ** -7 if dtype != torch.float32
                               else 1e-6, atol=1e-6)
    tiles = layout.gate_tiles(w_ih, w_hh, 3).float()
    steps = tiles.shape[1]
    w = tiles.permute(1, 3, 2, 0, 4).reshape(16 * steps, 3 * H)
    np.testing.assert_array_equal(w[:E + F].numpy(), w_ih.float().numpy())
    np.testing.assert_array_equal(w[48:].numpy(), w_hh.float().numpy())
    assert not w[E + F:48].any()


def test_stage_wrappers_take_the_plain_stages_on_cpu():
    _, t_ops = _stage_operands(60, torch.bfloat16, jnp.bfloat16)
    emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh, bias3 = t_ops
    n = fs.fused_gru_attn_step.n_launches
    x = fs._attention_pass(emb, h, enc, uv, attn_w, attn_v, attn_b,
                          frame_chunk=7)
    assert torch.equal(x, fs.attention_pass_reference(
        emb, h, enc, uv, attn_w, attn_v, attn_b, frame_chunk=7))
    tiles = layout.gate_tiles(w_ih, w_hh, 3)
    assert torch.equal(fs._gate_cell(x, tiles, bias3),
                       fs.gate_cell_reference(x, tiles, bias3))
    assert fs.fused_gru_attn_step.n_launches == n


def test_stages_reject_what_the_kernels_do_not_take():
    _, t_ops = _stage_operands(70)
    emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh, bias3 = t_ops
    attn = (h, enc, uv, attn_w, attn_v, attn_b)
    with pytest.raises(ValueError, match="uv has shape"):
        fs._attention_pass(emb, h, enc, uv[:, :, :-1], attn_w, attn_v, attn_b)
    with pytest.raises(ValueError, match="frame_chunk"):
        fs._attention_pass(emb, *attn, frame_chunk=3)
    with pytest.raises(ValueError, match="emb is torch.bfloat16"):
        fs._attention_pass(emb.bfloat16(), *attn)
    x = fs._attention_pass(emb, *attn)
    tiles = layout.gate_tiles(w_ih, w_hh, 3)
    with pytest.raises(ValueError, match="bias3 has shape"):
        fs._gate_cell(x, tiles, bias3[:, :-1])
    with pytest.raises(ValueError, match="tiles is torch.bfloat16"):
        fs._gate_cell(x, tiles.bfloat16(), bias3)
    with pytest.raises(ValueError, match="x has shape"):
        fs._gate_cell(x[:, :-3], tiles, bias3)
    with pytest.raises(ValueError, match="tiles has shape"):
        fs._gate_cell(x, layout.gate_tiles(w_ih[:-16], w_hh, 3), bias3)


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


def test_step_launcher_runs_the_twin_on_cpu():
    """A launcher's steps on CPU tensors are the twin's, each with its own
    emb and h, and count no launch."""
    _, t_ops = _step_operands(_inputs(seed=10))
    emb, h = t_ops[:2]
    n = fs.fused_gru_attn_step.n_launches
    step = fs.step_launcher(*t_ops, emb_size=E, frame_chunk=7)
    for _ in range(3):
        h_new = step(emb, h)
        assert torch.equal(h_new, fs.fused_gru_attn_step_reference(
            emb, h, *t_ops[2:], emb_size=E, frame_chunk=7))
        emb, h = torch.flip(emb, [0]), h_new
    assert fs.fused_gru_attn_step.n_launches == n
    with pytest.raises(ValueError, match="no fused-step route"):
        fs.step_launcher(*[t.to("meta") for t in t_ops], emb_size=E)


# --------------------------------------------------------------------------
# the TF32 route (f32): its plain stages against the twin and the JAX
# package; the rule's shape limit; its X layout
# --------------------------------------------------------------------------

def _tf32_stages(t_ops, frame_chunk):
    """h' through the plain restatements of the TF32 route's kernels."""
    emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh, bias3 = t_ops
    x = fs.attention_pass_tf32_reference(emb, h, enc, uv, attn_w, attn_v,
                                         attn_b, frame_chunk=frame_chunk)
    return fs.gate_cell_tf32_reference(
        x, layout.gate_tiles_f32(w_ih, w_hh, 3), bias3)


@pytest.mark.parametrize("frame_chunk", [1, 7])
def test_tf32_stages_match_twin_and_pallas_interpret(frame_chunk):
    """B = 13 (a ragged 8-row fragment), E + F = 36 (a ragged k8 step):
    against the twin and JAX's kernel in interpret mode, TF32_TOL."""
    j_ops, t_ops = _stage_operands(80 + frame_chunk)
    got = _tf32_stages(t_ops, frame_chunk)
    assert got.shape == (S_B, H) and got.dtype == torch.float32
    twin = fs.fused_gru_attn_step_reference(*t_ops, emb_size=E,
                                            frame_chunk=frame_chunk)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), **TF32_TOL)
    want = j_fs.fused_gru_attn_step(*j_ops, emb_size=E, block_b=S_B,
                                    frame_chunk=frame_chunk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TF32_TOL)
    plain = fs.gru_attn_step_reference(*t_ops[:9], t_ops[9][0], t_ops[9][1],
                                       E)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TF32_TOL)


# the flagship decoder: GRU 512, embedding 468, attention 128, 28 x 1536
FLAG = dict(embedding_size=468, encoder_size=1536, hidden_size=512,
            attn_size=128)


def _flagship_step_operands(b, seed):
    """One step's operands at the flagship width, numpy f32 from a seed."""
    rng = np.random.default_rng(seed)
    e, f, hs, a = (FLAG[k] for k in ("embedding_size", "encoder_size",
                                     "hidden_size", "attn_size"))
    mk = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    return (mk(b, e, scale=0.3), np.tanh(mk(b, hs)), mk(b, S_L, f),
            mk(b, S_L, a, scale=0.3), mk(hs, a, scale=hs ** -0.5),
            mk(a, 1, scale=a ** -0.5), mk(1, a, scale=0.1),
            mk(e + f, 3 * hs, scale=(e + f) ** -0.5),
            mk(hs, 3 * hs, scale=hs ** -0.5), mk(3 * hs, scale=0.1),
            mk(3 * hs, scale=0.1))


@pytest.mark.parametrize("frame_chunk", [1, 7])
def test_tf32_stages_at_the_flagship_width(frame_chunk):
    """One step at the flagship width, 3 rows: the TF32 route's stages
    against JAX's kernel in interpret mode and the plain restatement,
    TF32_TOL."""
    j_ops, t_ops = _step_operands(_flagship_step_operands(3, 90 + frame_chunk))
    e = FLAG["embedding_size"]
    got = _tf32_stages(t_ops, frame_chunk)
    assert got.shape == (3, FLAG["hidden_size"])
    want = j_fs.fused_gru_attn_step(*j_ops, emb_size=e, block_b=3,
                                    frame_chunk=frame_chunk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TF32_TOL)
    plain = j_fs.gru_attn_step_reference(*j_ops[:9], j_ops[9][0],
                                         j_ops[9][1], e)
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), **TF32_TOL)


def test_tf32_gate_operand_layout():
    """X = [emb, ctx, zero pad to 40 columns, h] in f32: emb and h exact,
    ctx the twin's ctx / L, the pad exactly zero; its columns are the rows
    of the f32 gate tiles (``layout.gate_rows_f32`` gives back w_ih, the
    zero rows and w_hh), so the route's products are [emb, ctx] W_ih and
    h W_hh."""
    _, t_ops = _stage_operands(85)
    emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh, bias3 = t_ops
    x = fs.attention_pass_tf32_reference(emb, h, enc, uv, attn_w, attn_v,
                                         attn_b, frame_chunk=4)
    assert fs.gate_width(E + F, H, fs.TF32_K) == 40 + H
    assert x.shape == (S_B, 40 + H) and x.dtype == torch.float32
    assert torch.equal(x[:, :E], emb) and torch.equal(x[:, -H:], h)
    assert torch.equal(x[:, E + F:40], torch.zeros((S_B, 40 - E - F)))
    ctx = fs._context(h, enc, uv, attn_w, attn_v, attn_b, 4)
    assert torch.equal(x[:, E:E + F], ctx)
    w = layout.gate_rows_f32(layout.gate_tiles_f32(w_ih, w_hh, 3))
    assert w.shape == (40 + H, 3 * H)
    assert torch.equal(w[:E + F], w_ih) and torch.equal(w[40:], w_hh)
    assert not w[E + F:40].any()
    np.testing.assert_allclose((x @ w).numpy(), (
        torch.cat([emb, ctx], 1) @ w_ih + h @ w_hh).numpy(), rtol=1e-5,
        atol=1e-6)


def test_tf32_stage_wrappers_take_the_plain_stages_on_cpu():
    _, t_ops = _stage_operands(86)
    emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh, bias3 = t_ops
    n = fs.fused_gru_attn_step.n_launches
    x = fs._attention_pass_tf32(emb, h, enc, uv, attn_w, attn_v, attn_b,
                                frame_chunk=7)
    assert torch.equal(x, fs.attention_pass_tf32_reference(
        emb, h, enc, uv, attn_w, attn_v, attn_b, frame_chunk=7))
    tiles = layout.gate_tiles_f32(w_ih, w_hh, 3)
    assert torch.equal(fs._gate_cell_tf32(x, tiles, bias3),
                       fs.gate_cell_tf32_reference(x, tiles, bias3))
    assert fs.fused_gru_attn_step.n_launches == n


def test_tf32_stages_reject_what_the_kernels_do_not_take():
    _, t_ops = _stage_operands(87)
    emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh, bias3 = t_ops
    attn = (h, enc, uv, attn_w, attn_v, attn_b)
    with pytest.raises(ValueError, match="takes float32"):
        fs.attention_pass_tf32_reference(emb.bfloat16(),
                                         *(t.bfloat16() for t in attn))
    x = fs._attention_pass_tf32(emb, *attn)
    tiles = layout.gate_tiles_f32(w_ih, w_hh, 3)
    with pytest.raises(ValueError, match="tiles has shape"):
        fs._gate_cell_tf32(x, layout.gate_tiles(w_ih, w_hh, 3), bias3)
    with pytest.raises(ValueError, match="tiles is torch.bfloat16"):
        fs._gate_cell_tf32(x, tiles.bfloat16(), bias3)
    with pytest.raises(ValueError, match="x has shape"):
        fs._gate_cell_tf32(x[:, :-3], tiles, bias3)
    with pytest.raises(ValueError, match="bias3 has shape"):
        fs._gate_cell_tf32(x, tiles, bias3[:, :-1])


def test_f32_widths_past_the_w_h_tile_take_the_first_design():
    """The TF32 route's W h launch holds a tile's 32 columns of W and 16
    rows of h in shared memory (131,328 bytes at the flagship's H = 512;
    the other launches hold no operand whole): up to H = 907, past which
    f32 takes the CUDA-core body."""
    assert fs.attn_tf32_smem_bytes(512) == 131328
    assert fs.attn_tf32_fits(512) and fs.attn_tf32_fits(H)
    assert fs.attn_tf32_fits(896) and not fs.attn_tf32_fits(912)
    assert fs.step_body(torch.float32, 896) == "tf32"
    assert fs.step_body(torch.float32, 912) == "cuda_cores"
    assert fs.step_body(torch.bfloat16, 912) == "tensor_cores"


@pytest.mark.parametrize("b,rows,blocks", [
    (100, 32, 128), (1024, 128, 1024), (45, 32, 64), (1, 32, 32),
    (128, 128, 128), (192, 32, 192), (240, 128, 256), (1000, 128, 1024)])
def test_gate_gemm_fills_the_card_at_the_eval_batch(b, rows, blocks):
    """The TF32 route's gate GEMM at the flagship's H = 512: 128 rows a
    block, or 32 where 128-row tiles would pad B by more than an eighth
    (``gate_rows``); unit groups of 256 / rows 16-unit tiles x row tiles x
    8 parts of the k range (a cluster's blocks): 128 blocks for the 132
    SMs at the eval batch B = 100."""
    assert fs.gate_rows(b) == rows
    assert fs.gate_blocks(b, 512) == blocks


def test_greedy_decode_pallas_on_tf32_products_matches_jax(monkeypatch):
    """The K4 loop at the flagship width, f32, with K4 run through the TF32
    route's plain stages (its products as three TF32 terms): the tokens
    and n_steps of JAX's ``greedy_decode_pallas`` (interpret mode) and of
    the loop with plain products. The fixture has a clear top-2 margin
    (out_w scaled by 8: at least TOP2_MARGIN between the two largest
    logits of every row and step; 0.0115 at this seed), far above what
    the split's 2^-21 of a product moves a logit."""
    max_len, b = 5, 4
    kw = dict(cell_type="GRU", n_layers=1, vocab_size=V, embedding_scale=1.0,
              **FLAG)
    jcfg, tcfg = j_dec.DecoderConfig(**kw), t_dec.DecoderConfig(**kw)
    params = j_dec.init_decoder_params(jax.random.PRNGKey(17), jcfg)
    params = dict(params, out_w=params["out_w"] * 8.0)
    enc = np.random.default_rng(17).standard_normal(
        (b, S_L, FLAG["encoder_size"])).astype(np.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    plain = t_decoding.greedy_decode_pallas(tp, tcfg, torch.from_numpy(enc),
                                            max_len)
    seen = []

    def tf32_launcher(emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh,
                      bias3, *, emb_size, frame_chunk=1, tiles=None):
        assert tiles is None or tiles.shape == (32, 315, 3, 32, 4)
        tiles = layout.gate_tiles_f32(w_ih, w_hh, 3)

        def launch(emb, h):
            x = fs.attention_pass_tf32_reference(
                emb, h, enc, uv, attn_w, attn_v, attn_b,
                frame_chunk=frame_chunk)
            h_new = fs.gate_cell_tf32_reference(x, tiles, bias3)
            logits = h_new @ tp["out_w"] + tp["out_b"]
            top2 = logits.topk(2, dim=-1).values
            seen.append(float((top2[:, 0] - top2[:, 1]).min()))
            return h_new
        return launch

    monkeypatch.setattr(fs, "step_launcher", tf32_launcher)
    got = t_decoding.greedy_decode_pallas(tp, tcfg, torch.from_numpy(enc),
                                          max_len)
    assert len(seen) == max_len + 1 and min(seen) > TOP2_MARGIN
    want = j_decoding.greedy_decode_pallas(params, jcfg, jnp.asarray(enc),
                                           max_len, block_b=b,
                                           interpret=True)
    assert got.n_steps == int(want.n_steps) == plain.n_steps
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert torch.equal(got.tokens, plain.tokens)
