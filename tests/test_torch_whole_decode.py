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
from recnet_tpu_torch.ops.cuda import layout
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


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
@pytest.mark.parametrize("bad", [-1, V])
def test_k2_twin_out_of_range_token_reads_zero_embedding(cell, bad):
    """A carried token outside [0, V) gathers a zero embedding row, as the
    Pallas one-hot product does: tokens equal, h and c within rtol 2e-5."""
    cfg, params, enc = _setup(cell, seed=10)
    j_ops, t_ops = _operands(params, enc)
    jz = jnp.zeros((B, H), jnp.float32)
    jtok = jnp.full((B, 1), bad, jnp.int32)
    want = whole_greedy_decode_segment(*j_ops, jz, jz, jtok, emb_size=E,
                                       seg_len=3, block_b=8, cell_type=cell,
                                       interpret=True)
    tz = torch.zeros((B, H))
    got = wd.whole_greedy_decode_segment_reference(
        *t_ops, tz, tz, torch.full((B, 1), bad, dtype=torch.int32),
        emb_size=E, seg_len=3, cell_type=cell)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5,
                                   atol=2e-6)


def _pad_biased(params, lift):
    return dict(params, out_b=params["out_b"].at[0].add(lift))


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_k1_early_exit_twin_matches_pallas(cell):
    """early_exit on two tiles of 8 rows (JAX block_b=8): exact, the
    columns after a tile's stop reading 0; one tile stops before T."""
    cfg, params, enc = _setup(cell, seed=11)
    j_ops, t_ops = _operands(_pad_biased(params, 3.0), enc)
    kw = dict(emb_size=E, max_len=MAX_LEN, cell_type=cell)
    want = np.asarray(whole_greedy_decode(*j_ops, block_b=8, early_exit=True,
                                          interpret=True, **kw))
    got = wd.whole_greedy_decode_reference(*t_ops, early_exit=True, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    full = wd.whole_greedy_decode_reference(*t_ops, **kw).numpy()
    assert not (got.numpy() == full).all()     # a tile stopped early


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_k1_dual_twin_matches_pallas(cell):
    """dual=True gives the production tokens (test_pallas_fused.py:224)."""
    cfg, params, enc = _setup(cell, seed=4, peaky=False)
    j_ops, t_ops = _operands(params, enc)
    kw = dict(emb_size=E, max_len=MAX_LEN, cell_type=cell)
    want = whole_greedy_decode(*j_ops, block_b=B, dual=True, interpret=True,
                               **kw)
    got = wd.whole_greedy_decode(*t_ops, dual=True, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), wd.whole_greedy_decode_reference(*t_ops, **kw).numpy())


ABLATE_PARTS = ["emb", "attn", "score1", "fma", "proj", "nativeargmax",
                "argmax"]


@pytest.mark.parametrize("part", ABLATE_PARTS)
def test_k1_ablate_twin_matches_pallas(part):
    """Each profiling stub against JAX ``ablate=`` on the same weights;
    "argmax" feeds int(max logit), often outside [0, V), back in."""
    cfg, params, enc = _setup("GRU", seed=12)
    j_ops, t_ops = _operands(params, enc)
    kw = dict(emb_size=E, max_len=MAX_LEN, cell_type="GRU")
    want = whole_greedy_decode(*j_ops, block_b=8, ablate=part,
                               interpret=True, **kw)
    got = wd.whole_greedy_decode(*t_ops, ablate=part, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k1_ablate_lstm_combined_parts_match_pallas():
    """The twin takes comma-joined parts, tested in _make_step's order."""
    cfg, params, enc = _setup("LSTM", seed=13)
    j_ops, t_ops = _operands(params, enc)
    kw = dict(emb_size=E, max_len=MAX_LEN, cell_type="LSTM")
    for ablate in ("emb,fma", "score1,argmax", "attn,proj"):
        want = whole_greedy_decode(*j_ops, block_b=8, ablate=ablate,
                                   interpret=True, **kw)
        got = wd.whole_greedy_decode_reference(*t_ops, ablate=ablate, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [3, 7])
def test_k1_nativeargmax_equals_production(seed):
    """The int-key argmax and the plain first-max argmax pick the same
    tokens (test_pallas_fused.py:173-195)."""
    cfg, params, enc = _setup("GRU", seed=seed, peaky=False)
    _, t_ops = _operands(params, enc)
    kw = dict(emb_size=E, max_len=MAX_LEN)
    np.testing.assert_array_equal(
        wd.whole_greedy_decode(*t_ops, ablate="nativeargmax", **kw).numpy(),
        wd.whole_greedy_decode(*t_ops, **kw).numpy())


@pytest.mark.parametrize("other", [dict(early_exit=True),
                                   dict(ablate="emb")])
def test_dual_refuses_early_exit_and_ablate(other):
    _, params, enc = _setup("GRU", seed=14)
    _, t_ops = _operands(params, enc)
    for fn in (wd.whole_greedy_decode, wd.whole_greedy_decode_reference):
        with pytest.raises(ValueError, match="dual=True does not support"):
            fn(*t_ops, emb_size=E, max_len=MAX_LEN, dual=True, **other)


def test_variant_bits_follow_the_substring_order():
    """The kernel variant a wrapper asks for: "nativeargmax" before
    "argmax", "attn" before "score1" and "fma"; combinations are not
    built for the card."""
    assert wd._variant(False, False, "") == 0
    assert wd._variant(True, False, "") == wd._EARLY_EXIT
    assert wd._variant(False, True, "") == wd._DUAL
    assert wd._ablated("nativeargmax") == (False, 0, 2)
    assert wd._ablated("argmax") == (False, 0, 3)
    assert wd._ablated("attn,score1") == (False, 1, 0)
    assert wd._ablated("emb,proj") == (True, 0, 1)
    built = {wd._variant(False, False, p) for p in ABLATE_PARTS}
    assert built <= wd._BUILT_VARIANTS and len(built) == len(ABLATE_PARTS)
    assert wd._variant(False, False, "emb,proj") not in wd._BUILT_VARIANTS
    assert wd._variant_name(False, False, "fma") == "ablate=fma"
    assert wd._variant_name(False, False, "") == ""


@pytest.mark.parametrize("lift", [45.0, -45.0])
def test_k1_ablate_argmax_out_of_range_matches_pallas(lift):
    """Logits lifted past V (or below 0): every "argmax" token after the
    first step lies outside [0, V) and reads a zero embedding row."""
    cfg, params, enc = _setup("LSTM", seed=15)
    params = dict(params, out_b=params["out_b"] + lift)
    j_ops, t_ops = _operands(params, enc)
    kw = dict(emb_size=E, max_len=MAX_LEN, cell_type="LSTM")
    want = np.asarray(whole_greedy_decode(*j_ops, block_b=8, ablate="argmax",
                                          interpret=True, **kw))
    got = wd.whole_greedy_decode_reference(*t_ops, ablate="argmax", **kw)
    assert ((want < 0) | (want >= V)).all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_cores_is_the_production_step_on_the_cpu():
    """``cuda_cores`` picks the CUDA-core body on the card for any variant;
    on the CPU the wrapper runs the twin of the variant asked for."""
    _, params, enc = _setup("LSTM", seed=15)
    _, t_ops = _operands(params, enc)
    kw = dict(emb_size=E, max_len=MAX_LEN, cell_type="LSTM")
    np.testing.assert_array_equal(
        wd.whole_greedy_decode(*t_ops, cuda_cores=True, **kw).numpy(),
        wd.whole_greedy_decode(*t_ops, **kw).numpy())
    assert wd._variant_name(False, False, "", True) == "cuda_cores"
    for other in (dict(early_exit=True), dict(dual=True),
                  dict(ablate="emb")):
        np.testing.assert_array_equal(
            wd.whole_greedy_decode(*t_ops, cuda_cores=True, **other,
                                   **kw).numpy(),
            wd.whole_greedy_decode_reference(*t_ops, **other, **kw).numpy())


TC, CC = wd.TENSOR_CORES, wd.CUDA_CORES


@pytest.mark.parametrize("dtype,H_,options,want", [
    # bf16 in 16-unit tiles: every variant on the tensor-core body, the
    # probes from their own library
    (torch.bfloat16, 512, {}, (TC, 256, "whole_decode")),
    (torch.bfloat16, 512, dict(early_exit=True), (TC, 257, "whole_decode")),
    (torch.bfloat16, 512, dict(dual=True), (TC, 258, "whole_decode_probes")),
    (torch.bfloat16, 512, dict(ablate="emb"),
     (TC, 260, "whole_decode_probes")),
    (torch.bfloat16, 16, dict(ablate="fma"),
     (TC, 256 | 3 << 3, "whole_decode_probes")),
    (torch.bfloat16, 512, dict(ablate="nativeargmax"),
     (TC, 256 | 2 << 5, "whole_decode_probes")),
    # cuda_cores: the CUDA-core body for any variant
    (torch.bfloat16, 512, dict(cuda_cores=True), (CC, 0, "whole_decode")),
    (torch.bfloat16, 512, dict(dual=True, cuda_cores=True),
     (CC, 2, "whole_decode")),
    (torch.bfloat16, 512, dict(ablate="proj", cuda_cores=True),
     (CC, 1 << 5, "whole_decode")),
    (torch.bfloat16, 512, dict(early_exit=True, cuda_cores=True),
     (CC, 1, "whole_decode")),
    # f32 in 16-unit tiles: the TF32 body, its probes from their own
    # library; under cuda_cores, and bf16 without 16-unit tiles: the
    # CUDA-core body
    (torch.float32, 512, {}, (wd.TF32, 0, "whole_decode_tf32")),
    (torch.float32, 512, dict(dual=True),
     (wd.TF32, 2, "whole_decode_tf32_probes")),
    (torch.float32, 512, dict(ablate="argmax"),
     (wd.TF32, 3 << 5, "whole_decode_tf32_probes")),
    (torch.float32, 512, dict(dual=True, cuda_cores=True),
     (CC, 2, "whole_decode")),
    (torch.float32, 512, dict(ablate="argmax", cuda_cores=True),
     (CC, 3 << 5, "whole_decode")),
    (torch.bfloat16, 24, dict(dual=True), (CC, 2, "whole_decode")),
    (torch.bfloat16, 24, dict(ablate="score1"),
     (CC, 2 << 3, "whole_decode")),
])
def test_kernel_route_picks_the_body_and_bits(dtype, H_, options, want):
    assert tuple(wd.kernel_route(dtype, H_, **options)) == want


@pytest.mark.parametrize("options,match", [
    (dict(dual=True, early_exit=True), "dual=True does not support"),
    (dict(dual=True, ablate="emb", cuda_cores=True),
     "dual=True does not support"),
    (dict(ablate="emb,proj"), "one ablated part"),
])
def test_kernel_route_refuses_what_is_not_built(options, match):
    with pytest.raises(ValueError, match=match):
        wd.kernel_route(torch.bfloat16, 512, **options)


@pytest.mark.parametrize("early_exit,dual,ablate,body,want", [
    (False, True, "", TC, "dual"),
    (False, True, "", CC, "dual[cuda_cores]"),
    (False, False, "attn", TC, "ablate=attn"),
    (False, False, "attn", CC, "ablate=attn[cuda_cores]"),
    (True, False, "", CC, "early_exit[cuda_cores]"),
    (True, False, "", TC, "early_exit"),
    (False, True, "", wd.TF32, "dual[tf32]"),
    (False, False, "score1", wd.TF32, "ablate=score1[tf32]"),
])
def test_variant_launches_name_the_body(early_exit, dual, ablate, body, want):
    assert wd._variant_name(early_exit, dual, ablate, body == CC,
                            body) == want


# the flagship decoder: L 28, attention 128, E + F = 468 + 1536, H 512
FLAGSHIP_SMEM = dict(L=28, A=128, K=2004, H=512)


@pytest.mark.parametrize("n_gates,dual,want", [
    (3, False, 163_104),     # 8 rows, 4 ring slots
    (4, False, 195_872),
    (3, True, 226_880),      # 16 rows (128,576 B of row buffers), 4 slots
    (4, True, 226_880),      # 16 rows, 3 slots: 4 would need 259,648 B
])
def test_tensor_core_layout_fits_a_hopper_block(n_gates, dual, want):
    variant = wd.kernel_route(torch.bfloat16, 512, dual=dual).variant
    got = wd.check_tc_fits(n_gates, variant, **FLAGSHIP_SMEM)
    assert got == wd.tc_smem_bytes(n_gates, variant, **FLAGSHIP_SMEM) == want
    assert got <= wd.SMEM_LIMIT == 232_448


def test_tensor_core_layout_refuses_what_a_block_cannot_hold():
    """An LSTM under dual at 4 ring slots would not fit (the 3 slots the
    body takes do), and longer features (L = 200) do not fit either."""
    rows16 = 226_880 - 16 * 3 * 4 * 512
    assert rows16 + 16 * 4 * 4 * 512 == 259_648 > wd.SMEM_LIMIT
    variant = wd.kernel_route(torch.bfloat16, 512, dual=True).variant
    with pytest.raises(ValueError, match="232448"):
        wd.check_tc_fits(3, variant, **dict(FLAGSHIP_SMEM, L=200))
    production = wd.kernel_route(torch.bfloat16, 512).variant
    assert wd.check_tc_fits(3, production, **dict(FLAGSHIP_SMEM, L=200))


@pytest.mark.parametrize("H_,dtype,want", [
    (512, torch.bfloat16, True),
    (16, torch.bfloat16, True),
    (24, torch.bfloat16, False),     # not 16-unit tiles
    (512, torch.float32, False),     # f32 stays on CUDA cores
])
def test_the_tensor_core_body_takes_bf16_in_16_unit_tiles(H_, dtype, want):
    assert wd._tensor_cores(dtype, H_) == want


@pytest.mark.parametrize("cell,n_gates", [("GRU", 3), ("LSTM", 4)])
def test_gate_tiles_hold_every_weight_once_in_tile_order(cell, n_gates):
    """Tile (u, s, g) row r unit c is w_ih[16 s + r, g H + 16 u + c] for
    the w_ih steps (zero past K), then w_hh's rows; a copy, made again
    after a weight changes in place."""
    K, H_ = 37, 32
    rng = np.random.default_rng(0)
    w_ih = torch.from_numpy(rng.standard_normal((K, n_gates * H_)))
    w_hh = torch.from_numpy(rng.standard_normal((H_, n_gates * H_)))
    t = layout.gate_tiles(w_ih, w_hh, n_gates)
    nkx = -(-K // 16)
    assert t.shape == (H_ // 16, nkx + H_ // 16, n_gates, 16, 16)
    for u, s_, g, r, c in [(0, 0, 0, 0, 0), (1, 2, n_gates - 1, 4, 15),
                           (1, 1, 1, 3, 7)]:
        assert t[u, s_, g, r, c] == w_ih[16 * s_ + r, g * H_ + 16 * u + c]
    assert not t[:, nkx - 1, :, K - 16 * (nkx - 1):].any()   # zero rows
    assert t[1, nkx + 1, 2, 5, 9] == w_hh[16 + 5, 2 * H_ + 16 + 9]
    w_hh.mul_(2.0)
    assert t[1, nkx + 1, 2, 5, 9] != w_hh[16 + 5, 2 * H_ + 16 + 9]
    t = layout.gate_tiles(w_ih, w_hh, n_gates)
    assert t[1, nkx + 1, 2, 5, 9] == w_hh[16 + 5, 2 * H_ + 16 + 9]


def test_column_tiles_pad_and_group_out_w():
    H_, V_, group = 32, 100, 48
    out_w = torch.arange(H_ * V_, dtype=torch.float32).view(H_, V_)
    t = layout.column_tiles(out_w, group)
    assert t.shape == (3, 2, 3, 16, 16)
    # group 1, k step 1, tile 2, row 3, unit 4: column 48 + 32 + 4 = 84
    assert t[1, 1, 2, 3, 4] == out_w[16 + 3, 84]
    assert not t[2, :, :, :, 100 - 96:].any()        # columns past V
