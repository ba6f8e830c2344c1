"""The f32 decode route's plain models and rules on the CPU: K1/K2's TF32
body and K3's f32 split route (three-term TF32 products on the tensor
cores), whose kernels run on the card only (tests/test_torch_cuda.py).

The split (``whole_decode.tf32_round``, ``matmul_3xtf32_reference``) is
held against float64 products; the whole-decode twin with its products
replaced by the split against the f32 twin and the JAX package's Pallas
kernel; the f32 weight tiles against the weights; the body and route rules,
the shared-memory mirror and the cluster size against their stated
values."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recnet_tpu.models import decoder as j_dec
from recnet_tpu.ops import attention as j_attn
from recnet_tpu.ops.pallas.whole_decode import whole_greedy_decode
from recnet_tpu_torch.models.decoder import DecoderConfig
from recnet_tpu_torch.ops.attention import precompute_uv
from recnet_tpu_torch.ops.cuda import layout
from recnet_tpu_torch.ops.cuda import topk_proj
from recnet_tpu_torch.ops.cuda import whole_decode as wd
from recnet_tpu_torch.weights import params_from_jax, random_params

# the flagship decoder: GRU 512, vocab 4188, embedding 468, attention 128,
# 28 x 1536 features, T = 31
FLAGSHIP = dict(vocab_size=4188, embedding_size=468, encoder_size=1536,
                hidden_size=512, attn_size=128)
L_FLAG, T_FLAG = 28, 31
# the split's error a product is about 2^-21 of |a b|; over K terms the f32
# sums add their own, of the same order: the split's max error may be at
# most SPLIT_OVER_F32 times plain f32's, and one-term TF32's (about 2^-11
# a product) at least ONE_TERM_OVER times the split's
SPLIT_OVER_F32 = 3.0
ONE_TERM_OVER = 300.0
F32_ROWS = 0.99        # rows of tokens equal to the f32 twin's


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),       # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                    # under half: down
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),   # over half: up
    (2.0 - 2.0 ** -23, 2.0),                    # the carry into the exponent
])
def test_tf32_round_is_cvt_rna(x, want):
    got = wd.tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want
    assert (got.view(torch.int32) & 0x1FFF).item() == 0


@pytest.mark.parametrize("K", [2004, 512])   # the gate and h products
def test_three_term_split_is_f32_accurate(K):
    """Against float64 products at the flagship's depths: the split's max
    error within SPLIT_OVER_F32 of plain f32's, one TF32 term's at least
    ONE_TERM_OVER times the split's (measured: about 500x)."""
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.standard_normal((32, K)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((K, 512))
                          / np.sqrt(K)).astype(np.float32))
    exact = a.double() @ b.double()
    err = lambda got: float((got.double() - exact).abs().max())
    split = err(wd.matmul_3xtf32_reference(a, b))
    plain = err(a @ b)
    one = err(wd.tf32_round(a) @ wd.tf32_round(b))
    assert split <= SPLIT_OVER_F32 * plain
    assert one >= ONE_TERM_OVER * split


def _flagship_operands(cell, B, seed):
    cfg = DecoderConfig(cell_type=cell, **FLAGSHIP)
    params = params_from_jax(random_params(cfg, seed), "cpu", torch.float32)
    rng = np.random.default_rng(seed + 100)
    enc = torch.from_numpy(rng.standard_normal(
        (B, L_FLAG, cfg.encoder_size)).astype(np.float32))
    r = params["rnn"][0]
    return cfg, (params, enc, precompute_uv(params["attention"], enc),
                 torch.stack([r["b_ih"], r["b_hh"]]))


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_tf32_products_keep_the_f32_tokens_at_the_flagship_width(cell):
    """The whole-decode twin with its products (W h, gates, logits) as the
    TF32 body computes them gives the f32 twin's tokens on F32_ROWS of
    rows, T = 31 steps from <SOS>, and K2's carried h within 1e-4."""
    cfg, ops = _flagship_operands(cell, B=24, seed=7)
    kw = dict(emb_size=cfg.embedding_size, cell_type=cell, emb_scale=1.0)
    B, H = ops[1].shape[0], cfg.hidden_size
    z = torch.zeros((B, H))
    sos = torch.full((B, 1), cfg.sos_token, dtype=torch.int32)
    want = wd._decode_reference(*ops, z, z, sos, n_steps=T_FLAG, **kw)
    got = wd._decode_reference(*ops, z, z, sos, n_steps=T_FLAG,
                               matmul=wd.matmul_3xtf32_reference, **kw)
    rows = (got[0] == want[0]).all(dim=1)
    assert rows.float().mean().item() >= F32_ROWS
    np.testing.assert_allclose(got[1][rows].numpy(), want[1][rows].numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_tf32_model_matches_pallas_tokens(cell):
    """At a small width, the twin on the TF32 body's products against the
    JAX package's Pallas kernel (interpret mode) in f32: equal tokens."""
    B, L, F, E, H, A, V = 16, 7, 24, 12, 16, 8, 40
    cfg = j_dec.DecoderConfig(cell_type=cell, vocab_size=V, embedding_size=E,
                              encoder_size=F, hidden_size=H, attn_size=A)
    params = j_dec.init_decoder_params(jax.random.PRNGKey(11), cfg)
    params = dict(params, out_w=params["out_w"] * 8.0)
    enc = jnp.asarray(np.random.default_rng(11).standard_normal((B, L, F)),
                      jnp.float32)
    uv = j_attn.precompute_uv(params["attention"], enc)
    r = params["rnn"][0]
    bias2 = jnp.stack([r["b_ih"], r["b_hh"]])
    want = whole_greedy_decode(params, enc, uv, bias2, emb_size=E, max_len=9,
                               block_b=8, cell_type=cell, interpret=True)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    t_enc = torch.from_numpy(np.array(enc))
    t_ops = (tp, t_enc, torch.from_numpy(np.array(uv)),
             torch.from_numpy(np.array(bias2)))
    z = torch.zeros((B, H))
    sos = torch.full((B, 1), 1, dtype=torch.int32)
    got = wd._decode_reference(*t_ops, z, z, sos, emb_size=E, n_steps=10,
                               cell_type=cell, emb_scale=1.0,
                               matmul=wd.matmul_3xtf32_reference)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


ABLATE_PARTS = ("emb", "attn", "score1", "fma", "proj", "nativeargmax",
                "argmax")


def _small_pallas_case(cell, seed):
    """A small f32 decoder whose logits keep a clear top-2 margin (out_w
    x 8), its operands for JAX and for the port."""
    B, L, F, E, H, A, V = 16, 7, 24, 12, 16, 8, 40
    cfg = j_dec.DecoderConfig(cell_type=cell, vocab_size=V, embedding_size=E,
                              encoder_size=F, hidden_size=H, attn_size=A)
    params = j_dec.init_decoder_params(jax.random.PRNGKey(seed), cfg)
    params = dict(params, out_w=params["out_w"] * 8.0)
    enc = jnp.asarray(np.random.default_rng(seed).standard_normal((B, L, F)),
                      jnp.float32)
    uv = j_attn.precompute_uv(params["attention"], enc)
    r = params["rnn"][0]
    bias2 = jnp.stack([r["b_ih"], r["b_hh"]])
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    t_ops = (tp, torch.from_numpy(np.array(enc)),
             torch.from_numpy(np.array(uv)),
             torch.from_numpy(np.array(bias2)))
    return (params, enc, uv, bias2), t_ops, dict(E=E, H=H, B=B)


@pytest.mark.parametrize("variant", [dict(ablate=p) for p in ABLATE_PARTS]
                         + [dict(dual=True)],
                         ids=list(ABLATE_PARTS) + ["dual"])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_tf32_model_of_the_probes_matches_pallas_tokens(cell, variant):
    """The K5 probes on the TF32 body, modelled at a small width: the twin
    with the body's three-term products and each ``ablate`` part against
    the JAX package's Pallas kernel with that part (interpret mode, f32),
    and the production twin against JAX's ``dual`` kernel (two 4-row
    halves of each 8-row tile): equal tokens."""
    j_ops, t_ops, d = _small_pallas_case(cell, 13)
    want = whole_greedy_decode(*j_ops, emb_size=d["E"], max_len=9,
                               block_b=8, cell_type=cell, interpret=True,
                               **variant)
    z = torch.zeros((d["B"], d["H"]))
    sos = torch.full((d["B"], 1), 1, dtype=torch.int32)
    got = wd._decode_reference(*t_ops, z, z, sos, emb_size=d["E"],
                               n_steps=10, cell_type=cell, emb_scale=1.0,
                               ablate=variant.get("ablate", ""),
                               matmul=wd.matmul_3xtf32_reference)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if variant.get("ablate") == "argmax":   # int(max logit): not an index
        assert bool((got != wd._decode_reference(
            *t_ops, z, z, sos, emb_size=d["E"], n_steps=10, cell_type=cell,
            emb_scale=1.0, matmul=wd.matmul_3xtf32_reference)[0]).any())


TF, CC, TC = wd.TF32, wd.CUDA_CORES, wd.TENSOR_CORES


@pytest.mark.parametrize("H_,options,want", [
    (512, {}, (TF, 0, "whole_decode_tf32")),
    (16, {}, (TF, 0, "whole_decode_tf32")),
    (512, dict(early_exit=True), (TF, 1, "whole_decode_tf32")),
    # f32's probes on the TF32 body, from their own library
    (512, dict(dual=True), (TF, 2, "whole_decode_tf32_probes")),
    (512, dict(ablate="emb"), (TF, 4, "whole_decode_tf32_probes")),
    (512, dict(ablate="attn"), (TF, 1 << 3, "whole_decode_tf32_probes")),
    (512, dict(ablate="score1"), (TF, 2 << 3, "whole_decode_tf32_probes")),
    (512, dict(ablate="fma"), (TF, 3 << 3, "whole_decode_tf32_probes")),
    (512, dict(ablate="proj"), (TF, 1 << 5, "whole_decode_tf32_probes")),
    (512, dict(ablate="nativeargmax"),
     (TF, 2 << 5, "whole_decode_tf32_probes")),
    (512, dict(ablate="argmax"), (TF, 3 << 5, "whole_decode_tf32_probes")),
    (16, dict(dual=True), (TF, 2, "whole_decode_tf32_probes")),
    # cuda_cores keeps the first design for any f32 variant
    (512, dict(cuda_cores=True), (CC, 0, "whole_decode")),
    (512, dict(early_exit=True, cuda_cores=True), (CC, 1, "whole_decode")),
    (512, dict(dual=True, cuda_cores=True), (CC, 2, "whole_decode")),
    (512, dict(ablate="emb", cuda_cores=True), (CC, 4, "whole_decode")),
    (512, dict(ablate="fma", cuda_cores=True), (CC, 3 << 3, "whole_decode")),
    (512, dict(ablate="argmax", cuda_cores=True),
     (CC, 3 << 5, "whole_decode")),
    # no 16-unit tiles: the CUDA-core body, by rule
    (24, {}, (CC, 0, "whole_decode")),
    (520, dict(early_exit=True), (CC, 1, "whole_decode")),
    (24, dict(dual=True), (CC, 2, "whole_decode")),
    (520, dict(ablate="proj"), (CC, 1 << 5, "whole_decode")),
])
def test_f32_route_rule(H_, options, want):
    assert wd.F32_ON_TF32
    assert tuple(wd.kernel_route(torch.float32, H_, **options)) == want


def test_bf16_route_is_unchanged_by_the_f32_body():
    for H_ in (16, 512):
        assert wd.kernel_route(torch.bfloat16, H_) == (TC, 256,
                                                       "whole_decode")
    assert wd.kernel_route(torch.bfloat16, 24).body == CC
    assert not wd._tf32(torch.bfloat16, 512) and wd._tf32(torch.float32, 512)


@pytest.mark.parametrize("n,k,want,bf16", [
    (5120, 5, 3, 3),    # the flagship beam at B = 1024: 80 x 3 blocks
    (500, 5, 12, 6),    # the eval batch's beam (B = 100): 8 x 12, not 8
    (1001, 1, 16, 16),
    (1001, 3, 16, 10),  # S k <= 64 (bf16: 32) for the merge warp
    (64, 8, 8, 4),
    (500, 9, 0, 0),     # k > 8: the single pass
    (20000, 5, 1, 1),
])
def test_f32_splits_fill_one_wave(n, k, want, bf16):
    """f32's ranges by bf16's rule, with two merge entries a lane."""
    assert topk_proj.splits(n, 4188, k, torch.float32, n_sms=132) == want
    assert topk_proj.splits(n, 4188, k, torch.bfloat16, 132) == bf16
    assert topk_proj.splits(n, 4188, k, torch.float16, 132) == 0


def test_f32_top_k_route_on_the_cpu_runs_the_twin():
    rng = np.random.default_rng(3)
    out = torch.from_numpy(rng.standard_normal((9, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 40)).astype(np.float32))
    b = torch.zeros(40)
    before = dict(topk_proj.outproj_topk.route_launches)
    got = topk_proj.outproj_topk(out, w, b, k=5, f32_single_pass=True)
    want = topk_proj.outproj_topk_reference(out, w, b, k=5)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert dict(topk_proj.outproj_topk.route_launches) == before


def _fragment(tile, lane, e):
    """The value the m16n8k8 A fragment's element e of ``lane`` reads:
    (unit, input) = (g + 8 (e % 2), t + 4 (e // 2))."""
    g, t = lane // 4, lane % 4
    return tile[g + 8 * (e % 2), t + 4 * (e // 2)]


@pytest.mark.parametrize("cell,n_gates", [("GRU", 3), ("LSTM", 4)])
def test_f32_gate_tiles_hold_every_weight_in_fragment_order(cell, n_gates):
    """Tile (u, s, g): units 16 u.., inputs 8 s.. of [w_ih; zero rows to a
    multiple of 8; w_hh], lane l element e at (g + 8 (e % 2), t + 4 (e //
    2)); every weight once, the padding zero."""
    K, H_ = 37, 32
    rng = np.random.default_rng(1)
    w_ih = torch.from_numpy(rng.standard_normal((K, n_gates * H_))).float()
    w_hh = torch.from_numpy(rng.standard_normal((H_, n_gates * H_))).float()
    t = layout.gate_tiles_f32(w_ih, w_hh, n_gates)
    nkx = -(-K // 8)
    assert t.shape == (H_ // 16, nkx + H_ // 8, n_gates, 32, 4)
    w = torch.cat([w_ih, torch.zeros(8 * nkx - K, n_gates * H_), w_hh])
    for u in range(H_ // 16):
        for s in range(nkx + H_ // 8):
            for gt in range(n_gates):
                tile = w[8 * s:8 * s + 8,
                         gt * H_ + 16 * u:gt * H_ + 16 * u + 16].T
                for lane in (0, 5, 31):
                    for e in range(4):
                        assert t[u, s, gt, lane, e] == _fragment(tile, lane, e)
    assert torch.equal(t.flatten().sort().values, w.flatten().sort().values)


def test_f32_column_tiles_pad_and_group_out_w():
    H_, V_, group = 32, 100, 48
    out_w = torch.arange(H_ * V_, dtype=torch.float32).view(H_, V_)
    t = layout.column_tiles_f32(out_w, group)
    assert t.shape == (3, 4, 3, 32, 4)
    padded = torch.nn.functional.pad(out_w, (0, 144 - V_))
    for grp, s, p in [(0, 0, 0), (1, 3, 2), (2, 1, 1)]:
        cols = (grp * 3 + p) * 16
        tile = padded[8 * s:8 * s + 8, cols:cols + 16].T
        for lane in range(32):
            for e in range(4):
                assert t[grp, s, p, lane, e] == _fragment(tile, lane, e)
    assert t.sum() == out_w.sum()                     # zero past V


def test_kernel_layouts_of_f32_params_are_the_tf32_tiles():
    cfg = DecoderConfig(cell_type="GRU", vocab_size=100, embedding_size=12,
                        encoder_size=20, hidden_size=32, attn_size=16)
    params = params_from_jax(random_params(cfg, 0), "cpu", torch.float32)
    lay = layout.kernel_layouts(params)
    assert set(lay) == {"out_w_padded", "gates", "attn_W", "out_w"}
    assert lay["out_w_padded"] is params["out_w"]     # 100 f32: 16-byte rows
    r = params["rnn"][0]
    assert torch.equal(lay["gates"],
                       layout.gate_tiles_f32(r["w_ih"], r["w_hh"], 3))
    assert torch.equal(lay["attn_W"], layout.column_tiles_f32(
        params["attention"]["W"], 16))
    assert torch.equal(lay["out_w"], layout.column_tiles_f32(
        params["out_w"], layout.PROJ_GROUP))
    assert all(t.dtype == torch.float32 for t in lay.values())
    assert layout.kernel_layouts(
        {"out_w": params["out_w"].half()}) is None


# the flagship decoder: L 28, attention 128, E + F = 468 + 1536, H 512
FLAGSHIP_SMEM = dict(L=28, A=128, K=2004, H=512)


@pytest.mark.parametrize("n_gates", [3, 4])
def test_tf32_layout_fits_a_hopper_block(n_gates):
    """8 rows' f32 buffers (121,632 B at the flagship) and a ring of 4
    slots of 3 tiles (GRU) or 3 slots of 4 (LSTM), 98,304 B."""
    got = wd.check_tf32_fits(n_gates, **FLAGSHIP_SMEM)
    assert got == wd.tf32_smem_bytes(n_gates, **FLAGSHIP_SMEM) == 219_936
    assert got <= wd.SMEM_LIMIT
    # an LSTM at 4 slots would not fit
    assert got + 16 * 4 * 512 > wd.SMEM_LIMIT


@pytest.mark.parametrize("shape", [dict(FLAGSHIP_SMEM, L=600),
                                   dict(FLAGSHIP_SMEM, K=2600)])
def test_tf32_layout_refuses_what_a_block_cannot_hold(shape):
    with pytest.raises(ValueError, match="232448"):
        wd.check_tf32_fits(3, **shape)


@pytest.mark.parametrize("B,want", [(1, 8), (100, 8), (128, 8), (129, 4),
                                    (264, 4), (265, 2), (528, 2), (529, 1),
                                    (1024, 1), (2048, 1)])
def test_cluster_size_fills_the_card(B, want):
    """The largest C with ceil(B / 8) C blocks on 132 SMs: the eval batch
    (B = 100) takes 104 blocks, B = 1024 128."""
    assert wd.cluster_size(B, 512, 132) == want


def test_cluster_size_is_bounded_by_the_unit_tiles():
    assert wd.cluster_size(1, 16, 132) == 1
    assert wd.cluster_size(1, 32, 132) == 2
    assert wd.cluster_size(1, 64, 132) == 4
    assert wd.cluster_size(100, 512, 64) == 4


DUAL = wd.kernel_route(torch.float32, 512, dual=True).variant


@pytest.mark.parametrize("n_gates,want", [(3, 221_504), (4, 213_312)])
def test_tf32_dual_layout_fits_a_hopper_block(n_gates, want):
    """16 rows under dual: x from the embedding's last whole k8 step on
    (16 x 1572 words: 100,608 B), one h (33,024 B), no c, and rings of 3
    slots (GRU) or 2 (LSTM): production's 16-row buffers would need
    228,096 B before any ring."""
    got = wd.check_tf32_fits(n_gates, **FLAGSHIP_SMEM, variant=DUAL, E=468)
    assert got == want == wd.tf32_smem_bytes(n_gates, **FLAGSHIP_SMEM,
                                             variant=DUAL, E=468)
    assert got <= wd.SMEM_LIMIT
    rows16 = 4 * 16 * (2020 + 2 * 516 + 512)
    assert rows16 == 228_096
    # the ablate parts keep production's layout
    for part in ABLATE_PARTS:
        v = wd.kernel_route(torch.float32, 512, ablate=part).variant
        assert wd.tf32_smem_bytes(n_gates, **FLAGSHIP_SMEM, variant=v,
                                  E=468) == 219_936


def test_tf32_dual_layout_needs_the_embedding_width():
    with pytest.raises(ValueError, match="depends on E"):
        wd.tf32_smem_bytes(3, **FLAGSHIP_SMEM, variant=DUAL)


@pytest.mark.parametrize("shape", [dict(FLAGSHIP_SMEM, K=2260),
                                   dict(FLAGSHIP_SMEM, L=300)])
def test_tf32_dual_layout_refuses_what_a_block_cannot_hold(shape):
    """Features of 1792 (K = 2260) or 300 frames: production's 8 rows
    still fit, dual's 16 do not (GRU)."""
    assert wd.check_tf32_fits(3, **shape)
    with pytest.raises(ValueError, match="232448"):
        wd.check_tf32_fits(3, **shape, variant=DUAL, E=468)


def test_tf32_dual_that_cannot_fit_takes_the_cuda_core_body_by_rule():
    """At features of 1792 the GRU's dual layout does not fit a block, so
    dual runs on the CUDA-core body by the rule (operands' shapes), while
    production and the ablate parts stay on the TF32 body."""
    params = {"attention": {"W": torch.zeros(512, 128)}}
    enc = torch.zeros(2, L_FLAG, 1792)
    route = lambda **kw: wd._operand_route(params, enc, 468, "GRU", **kw)
    assert route(dual=True) == (CC, 2, "whole_decode")
    assert route() == (TF, 0, "whole_decode_tf32")
    assert route(ablate="attn").body == TF
    assert wd._operand_route(params, enc, 468, "LSTM", dual=True).body == TF
    assert wd._operand_route(params, torch.zeros(2, L_FLAG, 1536), 468,
                             "GRU", dual=True) == (
        TF, 2, "whole_decode_tf32_probes")


@pytest.mark.parametrize("B,want", [(1, 8), (100, 8), (256, 8), (257, 4),
                                    (528, 4), (529, 2), (1004, 2), (1024, 2),
                                    (1056, 2), (1057, 1), (2048, 1)])
def test_dual_cluster_size_fills_the_card(B, want):
    """dual's tiles of 16 rows: the largest C with ceil(B / 16) C blocks on
    132 SMs: 56 blocks at the eval batch, 128 at B = 1024 (and at the
    ragged 1004: 63 tiles), one wave of 128 tiles of C = 1 at 2048."""
    assert wd.cluster_size(B, 512, 132, rows=16) == want


def test_dual_cluster_size_is_bounded_by_the_unit_tiles():
    assert wd.cluster_size(1, 16, 132, rows=16) == 1
    assert wd.cluster_size(1, 32, 132, rows=16) == 2
    assert wd.cluster_size(100, 512, 40, rows=16) == 4


def test_f32_the_tf32_body_cannot_hold_takes_the_cuda_core_body():
    """A decoder of 1536 units: the TF32 body's f32 rows do not fit a
    block, so f32 runs on the CUDA-core body by the rule (operands' shapes),
    never after a failed launch."""
    assert wd.tf32_smem_bytes(3, **dict(FLAGSHIP_SMEM, H=1536)) > wd.SMEM_LIMIT
    assert wd.kernel_route(torch.float32, 1536, tf32_fits=False) == (
        CC, 0, "whole_decode")
    cfg = DecoderConfig(cell_type="GRU", **dict(FLAGSHIP, hidden_size=1536))
    params = {"attention": {"W": torch.zeros(1536, cfg.attn_size)}}
    enc = torch.zeros(2, L_FLAG, cfg.encoder_size)
    assert wd._operand_route(params, enc, cfg.embedding_size, "GRU").body \
        == CC
    params = {"attention": {"W": torch.zeros(512, cfg.attn_size)}}
    assert wd._operand_route(params, enc, cfg.embedding_size, "LSTM").body \
        == TF


# the reconstructor's rollout on the f32 whole-rollout kernels' products
# (csrc/cell_rollout.cu's tf32 body): the flagship's width H = 1536 at a
# small batch, and an odd width, over the flagship's T = 31. Bound: the
# card tests' f32 bound (tests/test_torch_cuda.py _roll_close), rtol 1e-5
# and an atol of 1e-5 of each output's largest value
ROLL_RTOL = 1e-5


def _roll_inputs(cell, B, H, seed):
    """w_hh (at the init's scale, 1 / sqrt(H)), b_hh, gi_all, h0, c0 (None
    for GRU), dhs: float32 numpy, the card tests' recipe."""
    n = 4 if cell == "LSTM" else 3
    rng = np.random.default_rng(seed)
    arr = lambda *s, scale=0.5: (rng.standard_normal(s) * scale).astype(
        np.float32)
    w, b = arr(H, n * H, scale=H ** -0.5), arr(n * H)
    gi, h0, c0 = arr(T_FLAG, B, n * H, scale=1.5), arr(B, H), arr(B, H)
    return w, b, gi, h0, c0 if cell == "LSTM" else None, arr(T_FLAG, B, H)


def _roll_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=ROLL_RTOL,
                               atol=ROLL_RTOL * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("B,H", [(2, 1536), (3, 13)])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_tf32_rollout_model_matches_jax_rollouts(cell, B, H):
    """The whole-rollout plain versions with the three-term split's
    products (``matmul=matmul_3xtf32_reference``) against the JAX package's
    ``lstm_rollout_pre`` / ``gru_rollout_pre``: the forward's hs, cs and
    acts against its residuals, the backward's d gi_all, dh0 and dc0
    against ``jax.vjp``, within ROLL_RTOL."""
    from recnet_tpu.ops import rnn as j_rnn
    from recnet_tpu_torch.ops.cuda import rollout
    w, b, gi, h0, c0, dhs = _roll_inputs(cell, B, H, 11)
    lstm = cell == "LSTM"
    args = (w, b, gi, h0, c0) if lstm else (w, b, gi, h0)
    if lstm:
        _, (_, j_hs, j_cs, j_acts, _, _) = j_rnn._lstm_rollout_fwd(
            *map(jnp.asarray, args))
    else:
        _, (_, j_hs, j_acts, _) = j_rnn._gru_rollout_fwd(
            *map(jnp.asarray, args))
        j_cs = None
    jfn = j_rnn.lstm_rollout_pre if lstm else j_rnn.gru_rollout_pre
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dhs))
    t = [None if x is None else torch.from_numpy(x)
         for x in (w, b, gi, h0, c0, dhs)]
    tw, tb, tgi, th0, tc0, tdhs = t
    mm = wd.matmul_3xtf32_reference
    hs, cs, acts = rollout.cell_rollout_forward_reference(
        cell, tgi, tw, tb, th0, tc0, matmul=mm)
    for name, g, x in (("hs", hs, j_hs), ("cs", cs, j_cs),
                       ("acts", acts, j_acts)):
        if x is None:
            assert g is None
        else:
            _roll_close(g, x, name)
    dgi, _, dh0, dc0 = rollout.cell_rollout_backward_reference(
        cell, tdhs, acts, tw, th0, hs, tc0, cs, matmul=mm)
    _roll_close(dgi, want[2], "gi_all")
    _roll_close(dh0, want[3], "h0")
    if lstm:
        _roll_close(dc0, want[4], "c0")
    else:
        assert dc0 is None
