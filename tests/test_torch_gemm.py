"""The train step's GEMM wrapper (``ops/cuda/gemm.py``) on the CPU: the
plain twin against float64 in every layout the step takes, the ragged
shapes and the epilogues, the launch plan's strides and swap (emulated
with ``as_strided`` as the kernel indexes), the split-K rule, the rule of
the products the kernel takes, the ``autograd.Function`` and its route,
the plain references' own products, and one f32 train step with the
wrapper in place against torch's own products. The kernel itself is held
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py --gemm``).

Tolerances: the twin is float32 ``torch.mm``; against float64 each element
stays within the standard bound of a float32 sum of K products, K u
(|A| |B|)_ij with u = 2^-24. The train step's two routes run the same
float32 products on the CPU and differ only in the order of the bias
gradient's sum and where a bias is added, so they agree to float32
rounding (rtol 1e-5, atol 1e-7 of values of order 1e-2 to 1).
"""

import pytest
import torch

import torch_gemm_cases as gemm_cases
from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.models import decoder as D
from recnet_tpu_torch.ops import attention as A
from recnet_tpu_torch.ops import rnn as R
from recnet_tpu_torch.ops.cuda import gemm
from recnet_tpu_torch.training import step as S
from recnet_tpu_torch.utils.misc import tree_leaves

U = 2.0 ** -24
# the layouts: "fwd" x W (both row-major), "dx" dy W^T (W^T column-major),
# "dw" X^T dy (X^T column-major), and both column-major
KINDS = ("fwd", "dx", "dw", "tt")
# ragged shapes: K 468 (the embedding), N 4188 (the vocabulary), N 1664
# ([w_hh | W]), and sizes that are not multiples of 4
SHAPES = [(7, 468, 33), (5, 40, 4188), (9, 512, 1664), (13, 31, 29),
          (1, 17, 3), (6, 1, 5)]


def operands(kind, M, K, N, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, dtype=dtype)
    if kind == "fwd":
        return r(M, K), r(K, N)
    if kind == "dx":
        return r(M, K), r(N, K).t()
    if kind == "dw":
        return r(K, M).t(), r(K, N)
    return r(K, M).t(), r(N, K).t()


def componentwise_err(got, a, b, extra=None):
    """max over elements of |got - C64| / (K u (|A| |B|)_ij)."""
    want = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    if extra is not None:
        want = want + extra.double()
        scale = scale + extra.double().abs()
    K = max(a.shape[1], 1)
    return float(((got.double() - want).abs() / (K * U * scale + 1e-300))
                 .max())


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_twin_within_f32_bound_of_f64(kind, M, K, N):
    a, b = operands(kind, M, K, N)
    got = gemm.mm_reference(a, b)
    assert got.shape == (M, N) and got.dtype == torch.float32
    assert componentwise_err(got, a, b) <= 1.0


@pytest.mark.parametrize("kind", KINDS)
def test_bias_and_strided_out_epilogues(kind):
    M, K, N = 11, 468, 37
    a, b = operands(kind, M, K, N, seed=1)
    g = torch.Generator().manual_seed(2)
    bias = torch.randn(N, generator=g)
    buf = torch.randn((M, N + 8), generator=g)
    keep = buf[:, N:].clone()
    start = buf[:, :N].clone()
    # C = A B + bias, into a strided view
    out = buf[:, :N]
    got = gemm.mm(a, b, bias=bias, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert componentwise_err(buf[:, :N], a, b, bias.expand(M, N)) <= 1.0
    assert torch.equal(buf[:, N:], keep)
    # C += A B onto the strided view
    buf[:, :N] = start
    gemm.mm(a, b, out=buf[:, :N], accumulate=True)
    assert componentwise_err(buf[:, :N], a, b, start) <= 1.0
    assert torch.equal(buf[:, N:], keep)


def test_refusals():
    a, b = torch.randn(3, 4), torch.randn(4, 5)
    with pytest.raises(ValueError):
        gemm.mm(a, torch.randn(3, 5))
    with pytest.raises(ValueError):
        gemm.mm(a, b, bias=torch.randn(4))
    with pytest.raises(ValueError):
        gemm.mm(a, b, out=torch.empty(3, 4))
    with pytest.raises(ValueError):
        gemm.mm(a, b, accumulate=True)


def emulate(pl: gemm.Plan, out, bias, accumulate):
    """The kernel's arithmetic on the plan's strides, in float64: A_k and
    B_k read with ``as_strided`` as the kernel indexes them, C_k written
    through ``out``'s storage at (c_rs, c_cs)."""
    a_k = torch.as_strided(pl.a, (pl.M, pl.K),
                           (pl.a_ld, 1) if pl.a_kmajor else (1, pl.a_ld))
    b_k = torch.as_strided(pl.b, (pl.K, pl.N),
                           (1, pl.b_ld) if pl.b_kmajor else (pl.b_ld, 1))
    c_k = torch.as_strided(out, (pl.M, pl.N), (pl.c_rs, pl.c_cs))
    v = a_k.double() @ b_k.double()
    if bias is not None:
        v = v + torch.as_strided(bias, (pl.M, pl.N),
                                 (pl.bias_rs, pl.bias_cs)).double()
    if accumulate:
        v = v + c_k.double()
    c_k.copy_(v.float())


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_plan_strides_give_the_product(kind, with_bias):
    M, K, N = 9, 21, 14
    a, b = operands(kind, M, K, N, seed=3)
    bias = torch.randn(N) if with_bias else None
    buf = torch.zeros((M, N + 3))
    out = buf[:, :N]
    pl = gemm.plan(a, b, out, bias, 132)
    # the kernel's B is K-major wherever a swap can make it so
    assert pl.b_kmajor or (not pl.a_kmajor and not pl.swapped)
    assert pl.swapped == (kind == "fwd")
    emulate(pl, out, bias, False)
    want = a.double() @ b.double()
    if bias is not None:
        want = want + bias.double()
    torch.testing.assert_close(out.double(), want, rtol=1e-6, atol=1e-5)


def test_plan_copies_an_operand_with_no_unit_stride():
    a = torch.randn(6, 10)[:, ::2]               # strides (10, 2)
    b = torch.randn(5, 4)
    out = torch.empty(6, 4)
    pl = gemm.plan(a, b, out, None, 132)
    emulate(pl, out, None, False)
    torch.testing.assert_close(out, a @ b, rtol=1e-5, atol=1e-5)


def test_plan_reads_a_broadcast_operand():
    a = torch.randn(1, 7).expand(5, 7)           # strides (0, 1)
    b = torch.randn(7, 3)
    out = torch.empty(5, 3)
    pl = gemm.plan(a, b, out, None, 132)
    emulate(pl, out, None, False)
    torch.testing.assert_close(out, a @ b, rtol=1e-5, atol=1e-5)


def test_plan_vectorises_only_aligned_operands():
    base = torch.randn(8, 41)
    pl = gemm.plan(base[:, :40].t().contiguous().t(), torch.randn(40, 16),
                   torch.empty(8, 16), None, 132)
    assert pl.vec_a and pl.vec_b
    pl = gemm.plan(base[:, 1:41], torch.randn(40, 16), torch.empty(8, 16),
                   None, 132)
    # row stride 41 and an offset of one float: 4-byte copies for that one
    assert not (pl.vec_a and pl.vec_b)


@pytest.mark.parametrize("M,N,K", [(468, 1536, 31744), (1536, 128, 28672),
                                   (512, 128, 31744), (512, 1536, 31744),
                                   (1536, 6144, 31744), (1024, 6144, 31744),
                                   (6144, 31744, 1024), (1664, 1024, 512)])
def test_split_rule(M, N, K):
    """The count covers K in whole 32-k chunks of at least SPLIT_K_CHUNK;
    none under SPLIT_MIN_K; over it the last wave of blocks fills
    WAVE_FILL of the SMs (the train step's weight gradients: K = 31,744
    rows on 4 to 576 tiles)."""
    n_sms = 132
    splits, kchunk = gemm.split_chunk(K, gemm.splits_for(M, N, K, n_sms))
    assert kchunk % gemm.TILE_K == 0 or splits == 1
    assert (splits - 1) * kchunk < K <= splits * kchunk
    if K < gemm.SPLIT_MIN_K:
        assert splits == 1
    else:
        assert kchunk >= gemm.SPLIT_K_CHUNK - gemm.TILE_K
    tiles = -(-M // gemm.TILE_M) * -(-N // gemm.TILE_N)
    blocks = tiles * splits
    fill = blocks / (-(-blocks // n_sms) * n_sms)
    if K >= gemm.SPLIT_MIN_K:
        assert fill >= gemm.WAVE_FILL


# the train shapes whose blocks fill under half of the H100's 132 SMs: the
# decoder's dh product a step (32 tiles) and the local reconstructor's
# attention query (8 tiles), where cuBLAS's float32 kernels are the faster
SMALL_PRODUCTS = ("h_w_cat.dx", "local_query_W")


@pytest.mark.parametrize("case", gemm_cases.CASES,
                         ids=[c[0] for c in gemm_cases.CASES])
def test_kernel_pays_at_the_train_shapes(case):
    name, _, M, K, N, _ = case
    assert gemm.kernel_pays(M, N, K, 132) == (name not in SMALL_PRODUCTS)
    # the rule reads tiles and splits alone: A and B swapped give the same
    assert gemm.kernel_pays(N, M, K, 132) == gemm.kernel_pays(M, N, K, 132)


def test_kernel_pays_at_half_a_wave():
    # 66 tiles of 128 x 128 are half of 132 SMs; K under SPLIT_MIN_K
    assert gemm.kernel_pays(128 * 66, 128, 512, 132)
    assert not gemm.kernel_pays(128 * 65, 128, 512, 132)
    # split-K counts: one tile splits at most 31 ways over 31,744 k (1024 k
    # a split), four tiles 30 ways (120 blocks)
    assert not gemm.kernel_pays(128, 128, 31744, 132)
    assert gemm.kernel_pays(512, 128, 31744, 132)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_plain_references_keep_torch_products(cell, monkeypatch):
    """The plain loops the rollouts are held against (and timed against on
    the card) take torch's products, not the route under test."""
    def refuse(*a, **k):
        raise AssertionError("a reference reached ops.cuda.gemm")

    monkeypatch.setattr(gemm, "matmul", refuse)
    monkeypatch.setattr(gemm, "mm", refuse)
    g = torch.Generator().manual_seed(8)
    T, B, E, H, Fr, Ah = 4, 3, 5, 6, 7, 4
    nG = 4 if cell == "LSTM" else 3
    r = lambda *s: torch.randn(s, generator=g).requires_grad_()
    p = {"w_hh": r(H, nG * H), "b_hh": r(nG * H)}
    gi = r(T, B, nG * H)
    z = torch.zeros(B, H)
    R.rnn_rollout_pre_reference(cell, p, gi, z, z).sum().backward()
    att = {"W": r(H, Ah), "U": r(E, Ah), "b": r(Ah), "w": r(Ah, 1)}
    enc = r(B, Fr, E)
    uv = (enc @ att["U"]).detach()
    D.tf_attn_rollout_reference(cell, att, r(E, nG * H), p["w_hh"],
                                p["b_hh"], enc, uv, gi).sum().backward()
    A.attention_scores(att, r(B, H), uv).sum().backward()


def test_product_function_gradients_against_f64_gradcheck():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(6, 5, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(5, 3, generator=g, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(3, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(gemm._Product.apply, (x, w, b))
    assert torch.autograd.gradcheck(
        lambda x, w: gemm._Product.apply(x, w, None), (x, w))


@pytest.mark.parametrize("with_bias", [False, True])
def test_matmul_gradients_equal_autograd_of_torch_products(with_bias):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 7, 468, generator=g)
    w = torch.randn(468, 29, generator=g)
    b = torch.randn(29, generator=g) if with_bias else None
    dy = torch.randn(3, 7, 29, generator=g)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, w)]
        leaves += [b.clone().requires_grad_()] if with_bias else []
        y = fn(leaves[0], leaves[1], leaves[2] if with_bias else None)
        y.backward(dy)
        return [y.detach()] + [t.grad for t in leaves]

    got = grads(gemm.matmul)
    want = grads(lambda x, w, b: x @ w if b is None else x @ w + b)
    for gg, ww in zip(got, want):
        torch.testing.assert_close(gg, ww, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_route():
    gemm.launch.n_launches = 0
    x = torch.randn(4, 6, requires_grad=True)
    w = torch.randn(6, 5, requires_grad=True)
    y = gemm.matmul(x, w, torch.zeros(5))
    assert y.grad_fn is not None and "_Product" in type(y.grad_fn).__name__
    y.sum().backward()
    gemm.mm(torch.randn(3, 4), torch.randn(4, 2))
    assert gemm.launch.n_launches == 0


def test_route_rule():
    x, w = torch.randn(4, 6), torch.randn(6, 5)
    assert gemm.product_route(x, w)
    with torch.no_grad():
        assert not gemm.product_route(x, w)
        y = gemm.matmul(x, w)
    assert y.grad_fn is None
    torch.testing.assert_close(y, x @ w)
    assert not gemm.product_route(x.double(), w.double())
    assert not gemm.product_route(x.bfloat16(), w.bfloat16())
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert not gemm.product_route(x, w)
        assert gemm.matmul(x, w).dtype == torch.bfloat16


TINY = dict(
    caption_max_len=8, batch_size=4, embedding_size=12,
    encoder_output_size=20, encoder_output_len=6,
    decoder_hidden_size=16, decoder_attn_size=8,
    reconstructor_hidden_size=20, reconstructor_attn_size=8,
    decoder_learning_rate=1e-2, reconstructor_learning_rate=1e-3,
)
VOCAB = 25


def _batch(tc, seed):
    g = torch.Generator().manual_seed(seed)
    T = tc.caption_max_len + 1
    videos = torch.randn((tc.batch_size, tc.encoder_output_len,
                          tc.encoder_output_size), generator=g)
    captions = torch.zeros((T, tc.batch_size), dtype=torch.int32)
    for i in range(tc.batch_size):
        n = int(torch.randint(2, T, (), generator=g))
        captions[: n - 1, i] = torch.randint(3, VOCAB, (n - 1,), generator=g)
        captions[n - 1, i] = 2
    return videos, captions


@pytest.mark.parametrize("recon", [None, "global", "local"])
def test_train_step_with_the_wrapper_matches_torch_products(recon,
                                                            monkeypatch):
    tc = TrainConfig(**TINY, use_recon=recon is not None,
                     reconstructor_type=recon or "global")
    videos, captions = _batch(tc, 6)

    def step(torch_route):
        if torch_route:
            monkeypatch.setattr(gemm, "product_route",
                                lambda *a, **k: False)
        state, dcfg, rcfg = S.init_train_state(7, tc, VOCAB, "cpu")
        m = S.build_train_step(tc, dcfg, rcfg)(state, videos, captions)
        monkeypatch.undo()
        leaves = tree_leaves(state.dec_params) + (
            tree_leaves(state.rec_params) if recon else [])
        return m, [p.grad for p in leaves]

    gemm.launch.n_launches = 0
    got, got_grads = step(False)
    want, want_grads = step(True)
    assert gemm.launch.n_launches == 0
    for key in ("loss", "dec_loss", "rec_loss", "grad_norm"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-5,
                                   atol=1e-7)
    assert len(got_grads) == len(want_grads)
    for gg, ww in zip(got_grads, want_grads):
        torch.testing.assert_close(gg, ww, rtol=1e-5, atol=1e-7)
