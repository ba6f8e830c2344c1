"""The CUDA kernels on the card, against their plain twins: the whole
decode (K1/K2) with its K5 variants (early exit, dual, ablate) on its
bodies (tensor cores in bf16, the TF32 body in f32 at every cluster size,
and CUDA cores under ``cuda_cores``), the fused
projection + top-k (K3), the fused attention + GRU step (K4: its
tensor-core route (bf16) and TF32 route (f32), each route's two kernels
against its plain stage, and its CUDA-core body), and the training
rollouts' kernels (the
per-step cell and attention kernels, the cell kernels also against their
first design, the whole-rollout cell kernels), the embedding gather's
backward (against its twin bit for bit, float64 ``index_put_``, its
route and a train step's gradients) and the train step's three-term TF32
GEMM (against float64 within twice cuBLAS f32's error at every product of
the train cells, repeatable, counted, its route and a train step).

Needs a CUDA card with sm_90a and nvcc; every test skips without a card.
This file imports neither JAX nor the test conftest, so on the card run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Shapes are small, and B = 13 leaves a ragged tail of 5 rows in the second
block. f32 tolerance rtol 1e-5, atol 1e-6: the kernel and its twin sum in
another order.
"""

import numpy as np
import pytest
import torch

from recnet_tpu_torch.models.decoder import DecoderConfig
from recnet_tpu_torch.ops.attention import precompute_uv
from recnet_tpu_torch.ops.cuda import fused_step as fs
from recnet_tpu_torch.ops.cuda import layout
from recnet_tpu_torch.ops.cuda import topk_proj
from recnet_tpu_torch.ops.cuda import whole_decode as wd
from recnet_tpu_torch.weights import params_from_jax, random_params
import torch_gemm_cases as gemm_cases
from torch_embedding_cases import caption_inputs, tokens

pytestmark = pytest.mark.cuda

B, L, F, E, H, A, V = 13, 7, 24, 12, 16, 8, 40
MAX_LEN = 9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(cell, device, dtype=torch.float32, seed=0):
    cfg = DecoderConfig(cell_type=cell, vocab_size=V, embedding_size=E,
                        encoder_size=F, hidden_size=H, attn_size=A)
    p = random_params(cfg, seed)
    p["out_w"] = p["out_w"] * 8.0              # EOS/PAD get emitted
    params = params_from_jax(p, device, dtype)
    enc = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, L, F)).astype(np.float32)).to(device, dtype)
    r = params["rnn"][0]
    return (params, enc, precompute_uv(params["attention"], enc),
            torch.stack([r["b_ih"], r["b_hh"]]))


def _start(device, dtype):
    z = torch.zeros((B, H), dtype=dtype, device=device)
    return z, z, torch.ones((B, 1), dtype=torch.int32, device=device)


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_k1_matches_twin(cuda, cell):
    ops = _operands(cell, cuda)
    got = wd.whole_greedy_decode(*ops, emb_size=E, max_len=MAX_LEN,
                                 cell_type=cell)
    want = wd.whole_greedy_decode_reference(*ops, emb_size=E,
                                            max_len=MAX_LEN, cell_type=cell)
    torch.cuda.synchronize()
    assert got.shape == (B, MAX_LEN + 1) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
@pytest.mark.parametrize("seg_len", [1, 3, 8])
def test_k2_matches_twin(cuda, cell, seg_len):
    ops = _operands(cell, cuda, seed=1)
    k_state = t_state = _start(cuda, torch.float32)
    for _ in range(2):
        k_out = wd.whole_greedy_decode_segment(*ops, *k_state, emb_size=E,
                                               seg_len=seg_len,
                                               cell_type=cell)
        t_out = wd.whole_greedy_decode_segment_reference(
            *ops, *t_state, emb_size=E, seg_len=seg_len, cell_type=cell)
        torch.cuda.synchronize()
        for got, want in zip(k_out, t_out):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-5, atol=1e-6)
        k_state, t_state = k_out[1:], t_out[1:]


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_bf16_at_rounding_level(cuda, cell):
    """bf16: h within 2 bf16 ulps (rtol 2^-7, atol 1e-2) after 3 steps."""
    ops = _operands(cell, cuda, dtype=torch.bfloat16, seed=2)
    k_out = wd.whole_greedy_decode_segment(
        *ops, *_start(cuda, torch.bfloat16), emb_size=E, seg_len=3,
        cell_type=cell)
    t_out = wd.whole_greedy_decode_segment_reference(
        *ops, *_start(cuda, torch.bfloat16), emb_size=E, seg_len=3,
        cell_type=cell)
    torch.cuda.synchronize()
    np.testing.assert_allclose(k_out[1].float().cpu().numpy(),
                               t_out[1].float().cpu().numpy(),
                               rtol=2.0 ** -7, atol=1e-2)


def test_wrappers_count_their_launches(cuda):
    ops = _operands("GRU", cuda)
    n1 = wd.whole_greedy_decode.n_launches
    n2 = wd.whole_greedy_decode_segment.n_launches
    wd.whole_greedy_decode(*ops, emb_size=E, max_len=MAX_LEN)
    wd.whole_greedy_decode_segment(*ops, *_start(cuda, torch.float32),
                                   emb_size=E, seg_len=2)
    wd.whole_greedy_decode_segment_reference(
        *ops, *_start(cuda, torch.float32), emb_size=E, seg_len=2)
    assert wd.whole_greedy_decode.n_launches == n1 + 1
    assert wd.whole_greedy_decode_segment.n_launches == n2 + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    params, enc, uv, bias2 = _operands("GRU", cuda)
    kw = dict(emb_size=E, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        wd.whole_greedy_decode(params, enc.half(), uv, bias2, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        wd.whole_greedy_decode(params, enc, uv.transpose(0, 1)
                               .contiguous().transpose(0, 1), bias2, **kw)
    with pytest.raises(ValueError, match="bias2 has shape"):
        wd.whole_greedy_decode(params, enc, uv, bias2[:, :-1].contiguous(),
                               **kw)
    with pytest.raises(ValueError, match="LSTM"):
        wd.whole_greedy_decode(params, enc, uv, bias2, cell_type="LSTM",
                               **kw)
    with pytest.raises(ValueError, match="on cpu"):
        wd.whole_greedy_decode(params, enc, uv.cpu(), bias2, **kw)
    z = torch.zeros((B, H), device=cuda, dtype=torch.bfloat16)
    tok = torch.ones((B, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="h is torch.bfloat16"):
        wd.whole_greedy_decode_segment(params, enc, uv, bias2, z, z, tok,
                                       emb_size=E, seg_len=2)


def test_captioner_kernel_path_equals_plain_path(cuda):
    from recnet_tpu_torch.config import TrainConfig
    from recnet_tpu_torch.data.vocab import Vocab
    from recnet_tpu_torch.models.decoder import config_from_train
    from recnet_tpu_torch.serving import Captioner

    tc = TrainConfig(embedding_size=E, encoder_output_size=F,
                     encoder_output_len=L, decoder_hidden_size=H,
                     decoder_attn_size=A, caption_max_len=MAX_LEN)
    vocab = Vocab(tc.init_word2idx_dict).build(
        [" ".join(f"w{i}" for i in range(V - 3))], str.split)
    params = random_params(config_from_train(tc, vocab.n_vocabs), 3)
    params["out_w"] = params["out_w"] * 8.0
    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((n, F)).astype(np.float32)
             for n in (3, 7, 12, 20, 9)]
    caps = {}
    for name, kw in (("plain", {}), ("k1", dict(use_pallas=True)),
                     ("k2", dict(use_pallas=True, greedy_segment=4))):
        cap = Captioner(tc, vocab, params, dtype="float32", device="cuda",
                        batch_size=8, **kw)
        caps[name] = cap.caption(feats)
    assert caps["k1"] == caps["k2"] == caps["plain"]


def _topk_operands(device, n, h, v, dtype, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
    return t(n, h), t(h, v), t(v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,v,k", [(13, 24, 300, 5), (64, 32, 128, 1),
                                     (130, 40, 517, 3), (7, 16, 1000, 128),
                                     (9, 99, 301, 4)])
def test_k3_matches_twin(cuda, dtype, n, h, v, k):
    """Ragged N (blocks of 64 rows), V (tiles of 128 columns) and H (bf16
    slices of 64, odd sizes read one element at a time); indices equal,
    values within rtol/atol 1e-5 (f32 sums in another order)."""
    ops = _topk_operands(cuda, n, h, v, dtype)
    got = topk_proj.outproj_topk(*ops, k=k)
    want = topk_proj.outproj_topk_reference(*ops, k=k)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("v", [256, 1000])
def test_k3_ties_take_the_lowest_column(cuda, v):
    """Repeated weight columns: logits equal out[:, j % 8] exactly, so a
    row's top k is one residue class in ascending columns, across tiles."""
    h, k = 8, 6
    out = torch.randn((70, h), device=cuda)
    w = torch.from_numpy(np.tile(np.eye(h, 8, dtype=np.float32),
                                 (1, v // 8))).to(cuda)
    b = torch.zeros(w.shape[1], device=cuda)
    got = topk_proj.outproj_topk(out, w, b, k=k)
    want = topk_proj.outproj_topk_reference(out, w, b, k=k)
    single = topk_proj.outproj_topk(out, w, b, k=k, f32_single_pass=True)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(single[1], want[1])
    # the single pass's x 1 is exact; the TF32 split route's three terms
    # carry x as tf32(x) + tf32(x - tf32(x)), within 2^-22 of it, the same
    # for every tied column
    assert torch.equal(single[0], want[0])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    best = out.argmax(dim=1, keepdim=True).int()
    assert torch.equal(got[1], best + 8 * torch.arange(
        k, device=cuda, dtype=torch.int32))


def test_k3_rejects_and_counts(cuda):
    out, w, b = _topk_operands(cuda, 8, 16, 200, torch.float32)
    with pytest.raises(ValueError, match="outside"):
        topk_proj.outproj_topk(out, w, b, k=129)
    with pytest.raises(ValueError, match="on cpu"):
        topk_proj.outproj_topk(out, w.cpu(), b, k=3)
    with pytest.raises(ValueError, match="contiguous"):
        topk_proj.outproj_topk(out, w.t().contiguous().t(), b, k=3)
    n = topk_proj.outproj_topk.n_launches
    topk_proj.outproj_topk(out, w, b, k=3)
    topk_proj.outproj_topk_reference(out, w, b, k=3)
    assert topk_proj.outproj_topk.n_launches == n + 1


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_beam_kernel_route_equals_plain_route(cuda, cell):
    """A small f32 beam search on the card: K3 against the plain top-K."""
    from recnet_tpu_torch.decoding import beam_decode

    cfg = DecoderConfig(cell_type=cell, vocab_size=V, embedding_size=E,
                        encoder_size=F, hidden_size=H, attn_size=A)
    p = random_params(cfg, 5)
    p["out_w"] = p["out_w"] * 8.0
    params = params_from_jax(p, cuda)
    enc = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, L, F)).astype(np.float32)).to(cuda)
    n = topk_proj.outproj_topk.n_launches
    got = beam_decode(params, cfg, enc, 5, MAX_LEN, use_pallas_topk=True)
    want = beam_decode(params, cfg, enc, 5, MAX_LEN)
    assert topk_proj.outproj_topk.n_launches == n + MAX_LEN + 1
    assert got.n_steps == want.n_steps
    assert torch.equal(got.tokens, want.tokens)
    torch.testing.assert_close(got.scores, want.scores, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_k5_dual_is_bit_equal_to_k1(cuda, cell, dtype):
    """dual against K1's production step on the same (CUDA-core) body,
    asked for by ``cuda_cores`` (bf16 runs on the tensor cores otherwise,
    f32's production step on the TF32 body)."""
    ops = _operands(cell, cuda, dtype=dtype, seed=6)
    kw = dict(emb_size=E, max_len=MAX_LEN, cell_type=cell)
    got = wd.whole_greedy_decode(*ops, dual=True, cuda_cores=True, **kw)
    want = wd.whole_greedy_decode(*ops, cuda_cores=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_k5_early_exit_matches_twin_with_a_zero_tail(cuda, cell):
    """PAD-biased weights: the first block (8 rows) or the ragged second
    (5 rows) stops; the kernel equals the twin, zero tail included."""
    params, enc, uv, bias2 = _operands(cell, cuda, seed=7)
    params = dict(params, out_b=params["out_b"].clone())
    params["out_b"][0] += 2.0
    kw = dict(emb_size=E, max_len=MAX_LEN, cell_type=cell, early_exit=True)
    ops = (params, enc, uv, bias2)
    n = wd.whole_greedy_decode.variant_launches["early_exit[tf32]"]
    got = wd.whole_greedy_decode(*ops, **kw)
    want = wd.whole_greedy_decode_reference(*ops, **kw)
    torch.cuda.synchronize()
    assert (wd.whole_greedy_decode.variant_launches["early_exit[tf32]"]
            == n + 1)    # f32 runs on the TF32 body
    assert torch.equal(got, want)
    assert (got[:, -1] == 0).all()


def test_k5_early_exit_stops_blocks_at_different_steps(cuda):
    """A timer for <PAD>: GRU unit 0 keeps only its gate biases, so it
    rises by the same ramp 0.9 (1 - 0.9^(t+1)) on every row, and only the
    <PAD> logit reads it. Rows take <PAD> at steps of their own, so the six
    blocks of 45 rows (the last one ragged) stop at different steps, none
    at step 0; the kernel equals the twin."""
    cfg = DecoderConfig(cell_type="GRU", vocab_size=V, embedding_size=E,
                        encoder_size=F, hidden_size=H, attn_size=A)
    p = random_params(cfg, 12)
    p["out_w"] = p["out_w"] * 8.0
    r, gates = p["rnn"][0], [0, H, 2 * H]
    r["w_ih"][:, gates] = r["w_hh"][:, gates] = r["b_hh"][gates] = 0.0
    r["b_ih"][gates] = [0.0, np.log(0.9 / 0.1), np.arctanh(0.9)]
    p["out_w"][0, :] = p["out_w"][:, 0] = 0.0
    # the ramp at the smallest max logit of steps 0-1 at step 1 and at the
    # largest of steps 0-9 at step 15 (these weights and features)
    p["out_w"][0, 0], p["out_b"][0] = 5.698, 0.707
    params = params_from_jax(p, cuda)
    enc = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (45, L, F)).astype(np.float32)).to(cuda)
    ops = (params, enc, precompute_uv(params["attention"], enc),
           torch.stack([params["rnn"][0]["b_ih"], params["rnn"][0]["b_hh"]]))
    kw = dict(emb_size=E, max_len=MAX_LEN)
    got = wd.whole_greedy_decode(*ops, early_exit=True, **kw)
    want = wd.whole_greedy_decode_reference(*ops, early_exit=True, **kw)
    full = wd.whole_greedy_decode_reference(*ops, **kw)
    torch.cuda.synchronize()
    zero = torch.ones((48, MAX_LEN + 1), dtype=torch.bool, device=cuda)
    zero[:45] = want == 0
    zero = zero.view(6, 8, -1).all(dim=1)
    stops = torch.where(zero.any(dim=1), zero.int().argmax(dim=1),
                        MAX_LEN + 1)
    assert len(set(stops.tolist())) > 2 and bool((stops > 0).all())
    assert bool((stops < MAX_LEN).any())
    # a row takes a word after its block's stop: a late stop would show
    assert not torch.equal(want, full)
    assert torch.equal(got, want)


@pytest.mark.parametrize("part", ["emb", "attn", "score1", "fma", "proj",
                                  "nativeargmax", "argmax"])
@pytest.mark.parametrize("cell,dtype", [("GRU", torch.float32),
                                        ("GRU", torch.bfloat16),
                                        ("LSTM", torch.float32)])
def test_k5_ablate_matches_twin(cuda, part, cell, dtype):
    """The CUDA-core body's probes (bf16 by ``cuda_cores``). f32: tokens
    equal the twin's. bf16: h within 2 bf16 ulps of the twin's can flip a
    near tie and the row's later tokens with it, so at least 90% of the
    tokens must be equal. ``nativeargmax`` equals the production step of
    its body exactly."""
    ops = _operands(cell, cuda, dtype=dtype, seed=8)
    kw = dict(emb_size=E, max_len=MAX_LEN, cell_type=cell)
    got = wd.whole_greedy_decode(*ops, ablate=part, cuda_cores=True, **kw)
    want = wd.whole_greedy_decode_reference(*ops, ablate=part, **kw)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        assert (got == want).float().mean().item() >= 0.9
    if part == "nativeargmax":
        assert torch.equal(got, wd.whole_greedy_decode(*ops, cuda_cores=True,
                                                       **kw))


def test_k5_rejects_combined_ablations_and_dual_options(cuda):
    ops = _operands("GRU", cuda)
    with pytest.raises(ValueError, match="one ablated part"):
        wd.whole_greedy_decode(*ops, emb_size=E, max_len=MAX_LEN,
                               ablate="emb,proj")
    with pytest.raises(ValueError, match="dual=True does not support"):
        wd.whole_greedy_decode(*ops, emb_size=E, max_len=MAX_LEN, dual=True,
                               early_exit=True)


@pytest.mark.parametrize("bad", [-1, V, 1 << 30])
def test_out_of_range_token_reads_a_zero_embedding(cuda, bad):
    ops = _operands("LSTM", cuda, seed=9)
    z, c, _ = _start(cuda, torch.float32)
    tok = torch.full((B, 1), bad, dtype=torch.int32, device=cuda)
    got = wd.whole_greedy_decode_segment(*ops, z, c, tok, emb_size=E,
                                         seg_len=3, cell_type="LSTM")
    want = wd.whole_greedy_decode_segment_reference(
        *ops, z, c, tok, emb_size=E, seg_len=3, cell_type="LSTM")
    zero_emb = dict(ops[0], embedding=torch.zeros_like(ops[0]["embedding"]))
    first = wd.whole_greedy_decode_segment_reference(
        zero_emb, *ops[1:], z, c, tok, emb_size=E, seg_len=1,
        cell_type="LSTM")
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[0][:, :1], first[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)


K4_L = 28


def _k4_operands(device, dtype, seed=0, b=B):
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(
        (rng.standard_normal(shape) * 0.3).astype(np.float32)).to(device,
                                                                  dtype)
    return (t(b, E), t(b, H), t(b, K4_L, F), t(b, K4_L, A), t(H, A),
            t(A, 1), torch.ones((1, A), device=device, dtype=dtype),
            t(E + F, 3 * H), t(H, 3 * H), t(2, 3 * H))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frame_chunk", [1, 4, 7, 28])
def test_k4_matches_twin(cuda, dtype, frame_chunk):
    """B = 13 (a ragged block of 5 rows); f32 rtol 1e-5, atol 1e-6 (sums
    in another order); bf16 within 2 bf16 ulps (rtol 2^-7, atol 1e-2)."""
    ops = _k4_operands(cuda, dtype, seed=frame_chunk)
    got = fs.fused_gru_attn_step(*ops, emb_size=E, frame_chunk=frame_chunk)
    want = fs.fused_gru_attn_step_reference(*ops, emb_size=E,
                                            frame_chunk=frame_chunk)
    torch.cuda.synchronize()
    assert got.shape == (B, H) and got.dtype == dtype
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=2.0 ** -7, atol=1e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_k4_rejects_and_counts(cuda):
    ops = list(_k4_operands(cuda, torch.float32))
    with pytest.raises(ValueError, match="frame_chunk"):
        fs.fused_gru_attn_step(*ops, emb_size=E, frame_chunk=3)
    with pytest.raises(ValueError, match="on cpu"):
        fs.fused_gru_attn_step(*ops[:7], ops[7].cpu(), *ops[8:], emb_size=E)
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_gru_attn_step(*ops[:3], ops[3].transpose(0, 1).contiguous()
                               .transpose(0, 1), *ops[4:], emb_size=E)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fs.fused_gru_attn_step(*[t.half() for t in ops], emb_size=E)
    n = fs.fused_gru_attn_step.n_launches
    fs.fused_gru_attn_step(*ops, emb_size=E)
    fs.fused_gru_attn_step_reference(*ops, emb_size=E)
    assert fs.fused_gru_attn_step.n_launches == n + 1


BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-2)   # 2 bf16 ulps


def _k4_flagship(device, b, seed, dtype=torch.bfloat16):
    """K4's operands at the flagship width (E = 468, F = 1536, H = 512,
    A = 128, L = 28) in ``dtype``, from random_params, with the parameter
    set's gate tiles: (operands, tiles)."""
    cfg = DecoderConfig(cell_type="GRU", vocab_size=V, embedding_size=468,
                        encoder_size=1536, hidden_size=512, attn_size=128)
    params = params_from_jax(random_params(cfg, seed), device, dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    enc = torch.randn((b, K4_L, 1536), generator=g, device=device).to(dtype)
    h = torch.tanh(torch.randn((b, 512), generator=g, device=device))
    tok = torch.randint(0, V, (b,), generator=g, device=device)
    a, r = params["attention"], params["rnn"][0]
    ops = (params["embedding"][tok], h.to(dtype), enc,
           precompute_uv(a, enc), a["W"], a["w"], a["b"][None, :], r["w_ih"],
           r["w_hh"], fs.pack_gru_bias(r["b_ih"], r["b_hh"]))
    return ops, params["layouts"]["gates"]


@pytest.mark.parametrize("frame_chunk", [1, 4, 7, 28])
@pytest.mark.parametrize("b", [13, 1001])
def test_k4_tensor_cores_flagship_width(cuda, b, frame_chunk):
    """bf16 at the flagship width runs the tensor-core route (one launch,
    counted under "tensor_cores"): h within 2 bf16 ulps of the twin's."""
    ops, tiles = _k4_flagship(cuda, b, 30 + frame_chunk)
    n = fs.fused_gru_attn_step.body_launches["tensor_cores"]
    got = fs.fused_gru_attn_step(*ops, emb_size=468, frame_chunk=frame_chunk,
                                 tiles=tiles)
    want = fs.fused_gru_attn_step_reference(*ops, emb_size=468,
                                            frame_chunk=frame_chunk)
    torch.cuda.synchronize()
    assert fs.fused_gru_attn_step.body_launches["tensor_cores"] == n + 1
    assert got.shape == (b, 512) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("frame_chunk", [1, 7])
def test_k4_tensor_cores_odd_widths(cuda, frame_chunk):
    """E = 13, F = 21, A = 6 on the tensor-core route: its scalar paths
    (enc rows not a multiple of 8 features, W and uv rows not of 4 units,
    odd emb rows, a pad of 14 columns) within 2 bf16 ulps of the twin."""
    rng = np.random.default_rng(60 + frame_chunk)
    t = lambda *shape: torch.from_numpy(
        (rng.standard_normal(shape) * 0.3).astype(np.float32)).to(
            cuda, torch.bfloat16)
    e, f, a = 13, 21, 6
    ops = (t(B, e), t(B, H), t(B, K4_L, f), t(B, K4_L, a), t(H, a), t(a, 1),
           t(1, a), t(e + f, 3 * H), t(H, 3 * H), t(2, 3 * H))
    n = fs.fused_gru_attn_step.body_launches["tensor_cores"]
    got = fs.fused_gru_attn_step(*ops, emb_size=e, frame_chunk=frame_chunk)
    want = fs.fused_gru_attn_step_reference(*ops, emb_size=e,
                                            frame_chunk=frame_chunk)
    torch.cuda.synchronize()
    assert fs.fused_gru_attn_step.body_launches["tensor_cores"] == n + 1
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("flagship", [False, True])
def test_k4_kernels_match_their_stages(cuda, flagship):
    """Kernel A against ``attention_pass_reference`` (emb, the zero pad and
    h exact, ctx within 2 bf16 ulps), kernel B against
    ``gate_cell_reference`` on the same X (within 2 bf16 ulps); tiles made
    for the call give what the parameter set's give."""
    if flagship:
        ops, tiles = _k4_flagship(cuda, 1001, 40)
    else:
        ops = _k4_operands(cuda, torch.bfloat16, seed=40)
        tiles = layout.gate_tiles(ops[7], ops[8], 3)
    emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh, bias3 = ops
    E_, F_, H_ = emb.shape[1], enc.shape[2], h.shape[1]
    n = fs.fused_gru_attn_step.n_launches
    x = fs._attention_pass(emb, h, enc, uv, attn_w, attn_v, attn_b,
                          frame_chunk=7)
    x_want = fs.attention_pass_reference(emb, h, enc, uv, attn_w, attn_v,
                                         attn_b, frame_chunk=7)
    h_new = fs._gate_cell(x, tiles, bias3)
    h_want = fs.gate_cell_reference(x, tiles, bias3)
    full = fs.fused_gru_attn_step(*ops, emb_size=E_, frame_chunk=7)
    torch.cuda.synchronize()
    assert fs.fused_gru_attn_step.n_launches == n + 1
    assert x.shape == x_want.shape == (h.shape[0], fs.gate_width(E_ + F_, H_))
    assert torch.equal(x[:, :E_], emb) and torch.equal(x[:, -H_:], h)
    assert not x[:, E_ + F_:-H_].any()
    torch.testing.assert_close(x[:, E_:E_ + F_].float(),
                               x_want[:, E_:E_ + F_].float(), **BF16_TOL)
    torch.testing.assert_close(h_new.float(), h_want.float(), **BF16_TOL)
    assert torch.equal(full, fs.fused_gru_attn_step(
        *ops, emb_size=E_, frame_chunk=7, tiles=tiles))


# the TF32 route (f32): h against the twin within the bound chip_smoke.py
# holds it to (three TF32 terms err about 2^-21 of a product, and the sums
# run in another order); each kernel against its plain stage
TF32_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("frame_chunk", [1, 7])
@pytest.mark.parametrize("b", [1, 45, 100, 1024])
def test_k4_tf32_flagship_width(cuda, b, frame_chunk):
    """f32 at the flagship width runs the TF32 route (one launch, counted
    under "tf32"): h within TF32_TOL of the twin's, on the parameter set's
    f32 gate tiles and on tiles made for the call alike (bit-equal)."""
    ops, tiles = _k4_flagship(cuda, b, 60 + frame_chunk, torch.float32)
    assert tiles.dtype == torch.float32 and tiles.shape == (32, 315, 3, 32, 4)
    n = fs.fused_gru_attn_step.body_launches["tf32"]
    got = fs.fused_gru_attn_step(*ops, emb_size=468, frame_chunk=frame_chunk,
                                 tiles=tiles)
    made = fs.fused_gru_attn_step(*ops, emb_size=468,
                                  frame_chunk=frame_chunk)
    want = fs.fused_gru_attn_step_reference(*ops, emb_size=468,
                                            frame_chunk=frame_chunk)
    torch.cuda.synchronize()
    assert fs.fused_gru_attn_step.body_launches["tf32"] == n + 2
    assert got.shape == (b, 512) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **TF32_TOL)
    assert torch.equal(got, made)


@pytest.mark.parametrize("frame_chunk", [1, 7])
@pytest.mark.parametrize("b", [45, 1024])
def test_k4_tf32_kernels_match_their_stages(cuda, b, frame_chunk):
    """Kernel A against ``attention_pass_tf32_reference`` (emb, the zero
    pad and h exact, ctx within TF32_TOL), kernel B against
    ``gate_cell_tf32_reference`` on the same X (TF32_TOL), each row's h'
    bit-equal to its h' in a batch on the other side of ``gate_rows``'
    crossover (another rows a block), and the two hooks in turn bit-equal
    to a launch of the route."""
    ops, tiles = _k4_flagship(cuda, b, 70 + frame_chunk, torch.float32)
    emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh, bias3 = ops
    E_, F_, H_ = 468, 1536, 512
    n = fs.fused_gru_attn_step.n_launches
    x = fs._attention_pass_tf32(emb, h, enc, uv, attn_w, attn_v, attn_b,
                                frame_chunk=frame_chunk)
    x_want = fs.attention_pass_tf32_reference(
        emb, h, enc, uv, attn_w, attn_v, attn_b, frame_chunk=frame_chunk)
    h_new = fs._gate_cell_tf32(x, tiles, bias3)
    big = fs.GATE_ROWS_CHOICES[0]
    other = (x[:100] if fs.gate_rows(b) == big
             else x.repeat(big // b + 1, 1)[:big]).contiguous()
    assert fs.gate_rows(other.shape[0]) != fs.gate_rows(b)
    h_other = fs._gate_cell_tf32(other, tiles, bias3)
    h_want = fs.gate_cell_tf32_reference(x, tiles, bias3)
    full = fs.fused_gru_attn_step(*ops, emb_size=E_, frame_chunk=frame_chunk,
                                  tiles=tiles)
    torch.cuda.synchronize()
    assert fs.fused_gru_attn_step.n_launches == n + 1
    assert x.shape == (b, fs.gate_width(E_ + F_, H_, fs.TF32_K)) == (b, 2520)
    assert torch.equal(x[:, :E_], emb) and torch.equal(x[:, -H_:], h)
    assert not x[:, E_ + F_:-H_].any()
    torch.testing.assert_close(x[:, E_:E_ + F_], x_want[:, E_:E_ + F_],
                               **TF32_TOL)
    torch.testing.assert_close(h_new, h_want, **TF32_TOL)
    rows = min(b, other.shape[0])
    assert torch.equal(h_other[:rows], h_new[:rows])
    assert torch.equal(full, h_new)


def test_k4_tf32_rejects_tiles_it_cannot_read(cuda):
    """Tiles of the wrong layout (the bf16 route's), shape or dtype raise
    before a launch, in the wrapper and in the stage hook; so do rows a
    block the gate kernel is not built for."""
    ops, tiles = _k4_flagship(cuda, 8, 80, torch.float32)
    n = fs.fused_gru_attn_step.n_launches
    bad = (layout.gate_tiles(ops[7], ops[8], 3), tiles[:, :-1].contiguous(),
           tiles.double(), tiles.bfloat16())
    for t in bad:
        with pytest.raises(ValueError, match="tiles"):
            fs.fused_gru_attn_step(*ops, emb_size=468, tiles=t)
    x = fs._attention_pass_tf32(*ops[:7])
    for t in bad:
        with pytest.raises(ValueError, match="tiles"):
            fs._gate_cell_tf32(x, t, ops[9])
    with pytest.raises(ValueError, match="rows_per_block"):
        fs._launch_tf32(fs._GATE_CELL, x, torch.empty_like(ops[1]),
                        tiles=tiles, bias3=ops[9], rows_per_block=16)
    assert fs.fused_gru_attn_step.n_launches == n


def test_k4_tf32_attention_mirror_equals_the_kernel(cuda):
    lib = fs._library()
    for hidden in (16, 32, 512, 896, 912):
        assert (lib.recnet_fused_step_tf32_attn_smem(hidden)
                == fs.attn_tf32_smem_bytes(hidden))


@pytest.mark.parametrize("frame_chunk", [1, 7])
def test_k4_tf32_odd_widths(cuda, frame_chunk):
    """E = 13, F = 21, A = 6, H = 32 on the TF32 route: its scalar paths
    (enc rows not a multiple of 4 features, uv rows not of 4 units, a pad
    of 2 columns) within TF32_TOL of the twin, at B = 45."""
    rng = np.random.default_rng(90 + frame_chunk)
    t = lambda *shape: torch.from_numpy(
        (rng.standard_normal(shape) * 0.3).astype(np.float32)).to(cuda)
    e, f, a, hs, b = 13, 21, 6, 32, 45
    ops = (t(b, e), t(b, hs), t(b, K4_L, f), t(b, K4_L, a), t(hs, a),
           t(a, 1), t(1, a), t(e + f, 3 * hs), t(hs, 3 * hs), t(2, 3 * hs))
    n = fs.fused_gru_attn_step.body_launches["tf32"]
    got = fs.fused_gru_attn_step(*ops, emb_size=e, frame_chunk=frame_chunk)
    want = fs.fused_gru_attn_step_reference(*ops, emb_size=e,
                                            frame_chunk=frame_chunk)
    torch.cuda.synchronize()
    assert fs.fused_gru_attn_step.body_launches["tf32"] == n + 1
    torch.testing.assert_close(got, want, **TF32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_cuda_cores_option(cuda, dtype):
    """``cuda_cores=True`` runs the CUDA-core body: f32 within rtol 1e-5 /
    atol 1e-6 of the twin, bf16 within 2 ulps; counted under
    "cuda_cores"."""
    ops = _k4_operands(cuda, dtype, seed=50)
    n = fs.fused_gru_attn_step.body_launches["cuda_cores"]
    got = fs.fused_gru_attn_step(*ops, emb_size=E, frame_chunk=4,
                                 cuda_cores=True)
    want = fs.fused_gru_attn_step_reference(*ops, emb_size=E, frame_chunk=4)
    torch.cuda.synchronize()
    assert fs.fused_gru_attn_step.body_launches["cuda_cores"] == n + 1
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else BF16_TOL)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_k4_counts_launches_per_body(cuda):
    """One call, one launch, under the body that ``step_body`` names: bf16
    with H = 16 on the tensor cores, f32 with H = 16 on the TF32 route,
    H = 24 on the CUDA cores."""
    counts = fs.fused_gru_attn_step.body_launches
    cases = [(_k4_operands(cuda, torch.bfloat16, seed=51), "tensor_cores"),
             (_k4_operands(cuda, torch.float32, seed=52), "tf32")]
    rng = np.random.default_rng(53)
    t = lambda *shape: torch.from_numpy(
        (rng.standard_normal(shape) * 0.3).astype(np.float32)).to(
            cuda, torch.bfloat16)
    cases.append(((t(B, E), t(B, 24), t(B, K4_L, F), t(B, K4_L, A), t(24, A),
                   t(A, 1), t(1, A), t(E + F, 72), t(24, 72), t(2, 72)),
                  "cuda_cores"))
    for ops, body in cases:
        before, n = dict(counts), fs.fused_gru_attn_step.n_launches
        fs.fused_gru_attn_step(*ops, emb_size=E)
        assert fs.step_body(ops[1].dtype, ops[1].shape[1]) == body
        assert fs.fused_gru_attn_step.n_launches == n + 1
        assert counts[body] == before.get(body, 0) + 1
        assert sum(counts.values()) == sum(before.values()) + 1
    with pytest.raises(ValueError, match="tiles has shape"):
        ops = cases[0][0]
        fs.fused_gru_attn_step(*ops, emb_size=E, tiles=ops[7])
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_step_launcher_checks_once_and_each_step(cuda, dtype):
    """A launcher's steps equal the wrapper's calls on the same emb and h
    (the tensor-core route reusing its X scratch from step to step), count
    one launch each under the body ``step_body`` names, and reject an emb
    or h unlike the first step's."""
    ops = _k4_operands(cuda, dtype, seed=54)
    body = fs.step_body(dtype, H)
    step = fs.step_launcher(*ops, emb_size=E, frame_chunk=7)
    emb, h = ops[:2]
    before, n = dict(fs.fused_gru_attn_step.body_launches), \
        fs.fused_gru_attn_step.n_launches
    for _ in range(3):
        got = step(emb, h)
        want = fs.fused_gru_attn_step(emb, h, *ops[2:], emb_size=E,
                                      frame_chunk=7)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        emb, h = torch.flip(emb, [0]), got
    counts = fs.fused_gru_attn_step.body_launches
    assert fs.fused_gru_attn_step.n_launches == n + 6
    assert counts[body] == before.get(body, 0) + 6
    with pytest.raises(ValueError, match="h must be a contiguous"):
        step(emb, h[:-1])
    with pytest.raises(ValueError, match="emb must be a contiguous"):
        step(emb.t().contiguous().t(), h)
    with pytest.raises(ValueError, match="h must be a contiguous"):
        step(emb, h.half())
    with pytest.raises(ValueError, match="emb must be a contiguous"):
        step(emb.cpu(), h)
    assert fs.fused_gru_attn_step.n_launches == n + 6


def test_greedy_decode_pallas_bf16_reads_the_layouts(cuda):
    """bf16 on the tensor-core route: T launches, each counted under
    "tensor_cores", the same tokens with the parameter set's gate tiles
    as with tiles made per call, and tokens equal to a loop through K4's
    twin on 98% of the tokens."""
    from recnet_tpu_torch.decoding import greedy_decode_pallas

    cfg = DecoderConfig(cell_type="GRU", vocab_size=V, embedding_size=E,
                        encoder_size=F, hidden_size=H, attn_size=A)
    p = random_params(cfg, 11)
    p["out_w"] = p["out_w"] * 8.0
    params = params_from_jax(p, cuda, torch.bfloat16)
    assert "gates" in params["layouts"]
    enc = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (45, K4_L, F)).astype(np.float32)).to(cuda, torch.bfloat16)
    n = fs.fused_gru_attn_step.body_launches["tensor_cores"]
    got = greedy_decode_pallas(params, cfg, enc, MAX_LEN)
    assert (fs.fused_gru_attn_step.body_launches["tensor_cores"]
            == n + MAX_LEN + 1)
    bare = {k: v for k, v in params.items() if k != "layouts"}
    again = greedy_decode_pallas(bare, cfg, enc, MAX_LEN)
    assert torch.equal(got.tokens, again.tokens)
    assert got.n_steps == again.n_steps
    # the same loop with K4's twin
    a, r = params["attention"], params["rnn"][0]
    uv = precompute_uv(a, enc)
    bias3 = fs.pack_gru_bias(r["b_ih"], r["b_hh"])
    h = torch.zeros((45, H), dtype=torch.bfloat16, device=cuda)
    tok = torch.full((45,), cfg.sos_token, dtype=torch.long, device=cuda)
    toks = []
    for _ in range(MAX_LEN + 1):
        h = fs.fused_gru_attn_step_reference(
            params["embedding"][tok], h, enc, uv, a["W"], a["w"],
            a["b"][None, :], r["w_ih"], r["w_hh"], bias3, emb_size=E)
        tok = torch.argmax(h @ params["out_w"] + params["out_b"], dim=-1)
        toks.append(tok)
    want = torch.stack(toks).int()
    steps = got.n_steps
    share = (got.tokens[:steps] == want[:steps]).float().mean().item()
    assert share >= 0.98


def test_greedy_decode_pallas_equals_plain_greedy(cuda):
    """K4's greedy loop on the card, f32: the tokens and n_steps of the
    plain greedy_decode, with T launches of K4."""
    from recnet_tpu_torch.decoding import greedy_decode, greedy_decode_pallas

    cfg = DecoderConfig(cell_type="GRU", vocab_size=V, embedding_size=E,
                        encoder_size=F, hidden_size=H, attn_size=A)
    p = random_params(cfg, 10)
    p["out_w"] = p["out_w"] * 8.0
    params = params_from_jax(p, cuda)
    enc = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (B, L, F)).astype(np.float32)).to(cuda)
    n = fs.fused_gru_attn_step.n_launches
    got = greedy_decode_pallas(params, cfg, enc, MAX_LEN)
    want = greedy_decode(params, cfg, enc, MAX_LEN)
    assert fs.fused_gru_attn_step.n_launches == n + MAX_LEN + 1
    assert got.n_steps == want.n_steps
    assert torch.equal(got.tokens, want.tokens)


# the tensor-core body of K1/K2 (bf16) at the flagship embedding width, a
# ragged k (E + F = 516) and ragged vocabularies; B = 45 leaves a block of 5
TC_B, TC_E, TC_F, TC_H, TC_A = 45, 468, 48, 32, 16
TC_SHARE = 0.98   # bf16 tokens equal to the twin's (2 ulps of h flip ties)


def _tc_operands(cell, device, v, seed, b=TC_B):
    cfg = DecoderConfig(cell_type=cell, vocab_size=v, embedding_size=TC_E,
                        encoder_size=TC_F, hidden_size=TC_H, attn_size=TC_A)
    p = random_params(cfg, seed)
    p["out_w"] = p["out_w"] * 8.0
    params = params_from_jax(p, device, torch.bfloat16)
    enc = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, L, TC_F)).astype(np.float32)).to(device, torch.bfloat16)
    r = params["rnn"][0]
    return (params, enc, precompute_uv(params["attention"], enc),
            torch.stack([r["b_ih"], r["b_hh"]]))


@pytest.mark.parametrize("v", [4188, 1001])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_k1_tensor_cores_match_twin(cuda, cell, v):
    """bf16 K1 on the tensor-core body: tokens equal the twin's and the
    CUDA-core body's on TC_SHARE of the tokens."""
    ops = _tc_operands(cell, cuda, v, 20)
    kw = dict(emb_size=TC_E, max_len=MAX_LEN, cell_type=cell)
    n = wd.whole_greedy_decode.variant_launches["cuda_cores"]
    got = wd.whole_greedy_decode(*ops, **kw)
    cores = wd.whole_greedy_decode(*ops, cuda_cores=True, **kw)
    want = wd.whole_greedy_decode_reference(*ops, **kw)
    torch.cuda.synchronize()
    assert wd.whole_greedy_decode.variant_launches["cuda_cores"] == n + 1
    assert bool(((got >= 0) & (got < v)).all())
    assert (got == want).float().mean().item() >= TC_SHARE
    assert (got == cores).float().mean().item() >= TC_SHARE


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_k2_tensor_cores_carry_the_state(cuda, cell):
    """Two chained bf16 segments of 3 steps: h (and c) within 2 bf16 ulps
    of the twin's, tokens equal on TC_SHARE."""
    ops = _tc_operands(cell, cuda, 4188, 21)
    z = torch.zeros((TC_B, TC_H), dtype=torch.bfloat16, device=cuda)
    sos = torch.ones((TC_B, 1), dtype=torch.int32, device=cuda)
    k_state = t_state = (z, z, sos)
    kw = dict(emb_size=TC_E, seg_len=3, cell_type=cell)
    for _ in range(2):
        k_out = wd.whole_greedy_decode_segment(*ops, *k_state, **kw)
        t_out = wd.whole_greedy_decode_segment_reference(*ops, *t_state, **kw)
        torch.cuda.synchronize()
        assert (k_out[0] == t_out[0]).float().mean().item() >= TC_SHARE
        for got, want in zip(k_out[1:3], t_out[1:3]):
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2.0 ** -7, atol=1e-2)
        k_state, t_state = k_out[1:], t_out[1:]


def test_k1_tensor_cores_early_exit(cuda):
    """bf16 early exit on the tensor-core body with <PAD> lifted: each
    block's tokens equal the full decode's up to its stop, 0 after."""
    params, enc, uv, bias2 = _tc_operands("GRU", cuda, 1001, 22)
    params = dict(params, out_b=params["out_b"].clone())
    params["out_b"][0] += 3.0
    ops = (params, enc, uv, bias2)
    kw = dict(emb_size=TC_E, max_len=MAX_LEN)
    got = wd.whole_greedy_decode(*ops, early_exit=True, **kw)
    full = wd.whole_greedy_decode(*ops, **kw)
    torch.cuda.synchronize()
    T = MAX_LEN + 1
    padded = torch.ones((48, T), dtype=torch.bool, device=cuda)
    padded[:TC_B] = full == 0
    zero = padded.view(6, 8, T).all(dim=1)
    stop = torch.where(zero.any(dim=1), zero.int().argmax(dim=1), T)
    after = (torch.arange(T, device=cuda)[None, :]
             > stop.repeat_interleave(8)[:TC_B, None])
    assert torch.equal(got, torch.where(after, 0, full))


@pytest.mark.parametrize("b", [8, 24, 256])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_k5_dual_tensor_cores_bit_equal_to_k1(cuda, cell, b):
    """dual on the tensor-core body (16 rows a block, two 8-row halves
    sharing each weight tile) gives production K1's tensor-core tokens on
    every row: B = 8 leaves half 1 empty, B = 24 the second block's half 1
    empty; the LSTM takes the 3-slot ring. Counted as "dual"."""
    ops = _tc_operands(cell, cuda, 4188, 24, b=b)
    kw = dict(emb_size=TC_E, max_len=MAX_LEN, cell_type=cell)
    counts = wd.whole_greedy_decode.variant_launches
    n, n_cores = counts["dual"], counts["dual[cuda_cores]"]
    got = wd.whole_greedy_decode(*ops, dual=True, **kw)
    want = wd.whole_greedy_decode(*ops, **kw)
    torch.cuda.synchronize()
    assert (counts["dual"], counts["dual[cuda_cores]"]) == (n + 1, n_cores)
    assert got.shape == (b, MAX_LEN + 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("part", ["emb", "attn", "score1", "fma", "proj",
                                  "nativeargmax", "argmax"])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_k5_ablate_tensor_cores_matches_twin(cuda, part, cell):
    """Each ablated part on the tensor-core body against its twin on
    TC_SHARE of the tokens (bf16: 2 ulps of h flip near ties), counted as
    "ablate=<part>"; ``nativeargmax`` equals the production step of the
    body exactly (the two orders differ only on -0 against +0)."""
    ops = _tc_operands(cell, cuda, 1001, 25)
    kw = dict(emb_size=TC_E, max_len=MAX_LEN, cell_type=cell)
    counts = wd.whole_greedy_decode.variant_launches
    n = counts[f"ablate={part}"]
    got = wd.whole_greedy_decode(*ops, ablate=part, **kw)
    want = wd.whole_greedy_decode_reference(*ops, ablate=part, **kw)
    torch.cuda.synchronize()
    assert counts[f"ablate={part}"] == n + 1
    assert (got == want).float().mean().item() >= TC_SHARE
    if part == "nativeargmax":
        assert torch.equal(got, wd.whole_greedy_decode(*ops, **kw))


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_tensor_core_layout_mirror_equals_the_kernel(cuda, cell):
    """The wrapper's shared-memory mirror equals the kernel's layout for
    the flagship production step and dual, and both fit a block."""
    lib = wd._library()
    n_gates = 3 if cell == "GRU" else 4
    for dual in (False, True):
        variant = wd.kernel_route(torch.bfloat16, 512, dual=dual).variant
        shape = (28, 128, 468 + 1536, 512)
        want = wd.tc_smem_bytes(n_gates, variant, *shape)
        assert lib.recnet_whole_decode_tc_smem(n_gates, variant,
                                               *shape) == want
        assert want <= wd.SMEM_LIMIT


def test_parameter_set_layouts_are_what_the_kernels_read(cuda):
    """bf16 params on the card carry the kernels' weight copies, made once
    in params_from_jax; K1 and K3 give the same results with them as with
    copies made for the call, and K3 rejects a padded_w of another
    layout."""
    ops = _tc_operands("GRU", cuda, 4188, 23)
    params = ops[0]
    layouts = params["layouts"]
    assert set(layouts) == {"out_w_padded", "gates", "attn_W", "out_w"}
    bare = {k: v for k, v in params.items() if k != "layouts"}
    kw = dict(emb_size=TC_E, max_len=MAX_LEN)
    assert torch.equal(wd.whole_greedy_decode(*ops, **kw),
                       wd.whole_greedy_decode(bare, *ops[1:], **kw))
    out = torch.tanh(torch.randn((1001, TC_H), device=cuda)).bfloat16()
    w, b = params["out_w"], params["out_b"]
    got = topk_proj.outproj_topk(out, w, b, k=5,
                                 padded_w=layouts["out_w_padded"])
    want = topk_proj.outproj_topk(out, w, b, k=5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        topk_proj.outproj_topk(out, w, b, k=5, padded_w=w)   # 8376-byte rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k", [(1001, 1), (1001, 3), (1001, 5), (70, 5)])
def test_k3_flagship_width_matches_twin(cuda, dtype, n, k):
    """H = 512, V = 4188 (rows of 8376 bytes, 8-byte copies): columns equal
    the twin's on 99% of rows, values within 1e-5 on them."""
    out, w, b = _topk_operands(cuda, n, 512, 4188, dtype, seed=k)
    out = torch.tanh(out.float()).to(dtype)
    got = topk_proj.outproj_topk(out, w, b, k=k)
    want = topk_proj.outproj_topk_reference(out, w, b, k=k)
    torch.cuda.synchronize()
    rows = (got[1] == want[1]).all(dim=1)
    assert rows.float().mean().item() >= 0.99
    torch.testing.assert_close(got[0][rows], want[0][rows], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_k3_split_boundaries_inside_equal_logits(cuda, dtype, k):
    """Every column of out_w is e_0: each row's logits are out[:, 0],
    exactly, across the whole vocabulary, so the split ranges' boundaries
    fall inside a run of equal logits; the top k are columns 0..k-1, as
    lax.top_k gives."""
    n, h, v = 1001, 64, 4188
    out = torch.randn((n, h), device=cuda).to(dtype)
    w = torch.zeros((h, v), device=cuda, dtype=dtype)
    w[0] = 1.0
    b = torch.zeros(v, device=cuda, dtype=dtype)
    assert topk_proj.splits(n, v, k, torch.bfloat16, 132) > 1
    assert topk_proj.splits(n, v, k, dtype, 132) > 1
    got = topk_proj.outproj_topk(out, w, b, k=k)
    want = topk_proj.outproj_topk_reference(out, w, b, k=k)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[1], torch.arange(k, device=cuda, dtype=torch.int32)
                       .expand(n, k))
    if dtype == torch.bfloat16:
        assert torch.equal(got[0], want[0])
    else:   # three TF32 terms: x 1 within 2^-22 of x, equal across columns
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
        assert bool((got[0] == got[0][:, :1]).all())


# --------------------------------------------------------------------------
# training on the card (the rollouts' kernels below; autograd and Adam)
# --------------------------------------------------------------------------

def _train_config(recon, **kw):
    from recnet_tpu_torch.config import TrainConfig
    return TrainConfig(caption_max_len=8, batch_size=B, embedding_size=E,
                       encoder_output_size=F, encoder_output_len=L,
                       decoder_hidden_size=H, decoder_attn_size=A,
                       use_recon=recon is not None,
                       reconstructor_type=recon or "global",
                       reconstructor_hidden_size=F,
                       reconstructor_attn_size=A, embedding_dropout=0.0,
                       decoder_out_dropout=0.0,
                       reconstructor_decoder_dropout=0.0,
                       decoder_learning_rate=1e-2, **kw)


@pytest.mark.parametrize("recon", [None, "global", "local"])
@pytest.mark.parametrize("prec", ["float32", "bfloat16"])
def test_train_steps_on_the_card_match_the_cpu(cuda, recon, prec):
    """Three steps from one state, dropout off: f32 losses and params as
    the CPU's; bf16 autocast within 5% of the CPU's f32 losses."""
    from recnet_tpu_torch.checkpoint import state_leaves
    from recnet_tpu_torch.training import step as S
    rng = np.random.default_rng(3)
    videos = rng.standard_normal((B, L, F)).astype(np.float32)
    captions = rng.integers(3, V, (9, B)).astype(np.int32)
    captions[6:] = 0
    runs = {}
    for dev, p in (("cpu", "float32"), ("cuda", prec)):
        tc = _train_config(recon, train_precision=p)
        state, dcfg, rcfg = S.init_train_state(0, tc, V, dev)
        fn = S.build_train_step(tc, dcfg, rcfg)
        losses = [float(fn(state, torch.from_numpy(videos).to(dev),
                           torch.from_numpy(captions).to(dev))["loss"])
                  for _ in range(3)]
        runs[dev] = losses, state_leaves(state)
    if prec == "float32":
        np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0],
                                   rtol=1e-5)
        for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    else:
        np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0],
                                   rtol=0.05)


@pytest.mark.parametrize("width,route", [(1536, "rule"), (1536, "steps"),
                                         (2048, "rule")])
def test_f32_train_step_takes_the_reconstructor_route_of_the_rule(
        cuda, monkeypatch, width, route):
    """Three f32 steps with the global reconstructor on the card against
    the CPU's, at the flagship's reconstructor width (1536: one
    whole-rollout launch a direction a step) and at the ResNet features'
    (2048: past what a launch holds, so ops.rnn.whole_rollout sends it to
    the per-step cells); "steps" forces the per-step route at 1536, the
    control. The first step's gradients elementwise within rtol 1e-4 and
    atol 1e-5 of the leaf's largest |g|; losses within 1e-5; after three
    steps each leaf's sum (params and Adam moments) within 1e-4 of its sum
    of |values| (chip_smoke.py [train] (a)'s TRAIN_RTOL: Adam's normalised
    steps carry a gradient's sum-order noise whole to single elements near
    0). Prints the leaves' elementwise reading after three steps (elements
    past rtol 1e-4 / atol 1e-6, the largest relative difference) for the
    record."""
    from recnet_tpu_torch.checkpoint import state_leaves
    from recnet_tpu_torch.ops import rnn
    from recnet_tpu_torch.ops.cuda import rollout
    from recnet_tpu_torch.training import step as S
    rng = np.random.default_rng(4)
    videos = rng.standard_normal((B, L, width)).astype(np.float32)
    captions = rng.integers(3, V, (9, B)).astype(np.int32)
    captions[6:] = 0
    whole = route == "rule" and width == 1536
    assert rnn.whole_rollout("LSTM", torch.float32, B, width,
                             torch.device("cuda")) == (width == 1536)
    runs = {}
    for dev in ("cpu", "cuda"):
        if dev == "cuda" and route == "steps":
            monkeypatch.setattr(rnn, "whole_rollout", lambda *a: False)
        tc = _train_config("global", train_precision="float32").replace(
            encoder_output_size=width, reconstructor_hidden_size=width)
        state, dcfg, rcfg = S.init_train_state(0, tc, V, dev)
        fn = S.build_train_step(tc, dcfg, rcfg)
        rollout.reset_counts()
        losses, grads = [], None
        for _ in range(3):
            losses.append(float(fn(state, torch.from_numpy(videos).to(dev),
                                   torch.from_numpy(captions).to(dev))
                                ["loss"]))
            grads = grads or [np.zeros(0) if p.grad is None
                              else p.grad.detach().cpu().numpy().copy()
                              for opt in (state.dec_opt, state.rec_opt)
                              for p in opt.param_groups[0]["params"]]
        runs[dev] = losses, grads, state_leaves(state)
    launches = (rollout.cell_rollout_forward.cell_launches["LSTM"],
                rollout.cell_rollout_backward.cell_launches["LSTM"],
                rollout.cell_forward.cell_launches["LSTM"])
    over, worst = 0, 0.0
    for a, b in zip(runs["cuda"][2], runs["cpu"][2]):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        over += int((np.abs(a - b) > 1e-6 + 1e-4 * np.abs(b)).sum())
        worst = max(worst, float((np.abs(a - b) / np.maximum(
            np.abs(b), 1e-30)).max(initial=0.0)))
    print(f"H={width}, route {route} (whole: {whole}): leaves after three "
          f"steps, {over} of {sum(np.size(x) for x in runs['cpu'][2])} "
          f"elements past rtol 1e-4 / atol 1e-6, largest relative "
          f"difference {worst:.3g}")
    assert launches[:2] == ((3, 3) if whole else (0, 0))
    assert (launches[2] > 0) != whole
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-5)
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()))
    for a, b in zip(runs["cuda"][2], runs["cpu"][2]):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert abs(a.sum() - b.sum()) <= 1e-4 * np.abs(b).sum()


def test_prefetch_pins_and_copies_to_the_card(cuda):
    from recnet_tpu_torch.data import prefetch_to_device
    src = [(["v"], np.full((4, 3), i, np.float32),
            np.full((2, 4), i, np.int32)) for i in range(6)]
    pf = prefetch_to_device(iter(src), size=2, device="cuda")
    got = list(pf)
    assert len(got) == 6
    for i, (vids, x, y) in enumerate(got):
        assert vids == ["v"] and x.is_cuda and y.is_cuda
        assert y.dtype == torch.int32
        assert float(x.sum()) == 12.0 * i
    pf.close()
    assert not pf.thread.is_alive()


def test_evaluate_uploads_the_score_split_to_the_card_once(cuda):
    """With the device feature cache, evaluate takes the score batches to
    the params' device (the card) once, in float32, and writes what the
    CPU run writes (f32 greedy, K2's segments on the card)."""
    from recnet_tpu_torch.data import Corpus
    from recnet_tpu_torch.data.vocab import Vocab
    from recnet_tpu_torch.evaluation import decode_batch, evaluate
    from recnet_tpu_torch.models.decoder import config_from_train
    tc = _train_config(None, device_feature_cache=True, use_pallas=True,
                       greedy_segment=4)
    words = [f"w{i}" for i in range(V - 3)]
    vocab = Vocab(tc.init_word2idx_dict, 1)
    vocab.build([" ".join(words)], lambda s: s.split())
    rng = np.random.default_rng(4)
    split = lambda n: (
        {f"v{i}": rng.standard_normal((9, F)).astype(np.float32)
         for i in range(n)},
        {f"v{i}": [" ".join(rng.choice(words, 5))] for i in range(n)})
    splits = {"train": split(4), "val": split(4), "test": split(6)}
    dcfg = config_from_train(tc, vocab.n_vocabs)
    p = random_params(dcfg, 0)
    p["out_w"] = p["out_w"] * 8.0
    preds = {}
    for dev in ("cpu", "cuda"):
        corpus = Corpus(tc, vocab=vocab, splits=splits)
        params = params_from_jax(p, dev, torch.float32)
        for _ in range(2):
            evaluate(tc, corpus, params, dcfg, "greedy",
                     predictions_fpath=None, score_on_host=False)
        batches = corpus.score_batches_device(dev)
        assert all(x.device.type == dev and x.dtype == torch.float32
                   for _, x in batches)
        assert corpus.score_uploads == 1
        preds[dev] = [decode_batch(params, dcfg, x, "greedy",
                                   tc.caption_max_len, use_pallas=True,
                                   greedy_segment=4) for _, x in batches]
    for a, b in zip(preds["cpu"], preds["cuda"]):
        np.testing.assert_array_equal(a, b)


def test_one_rank_nccl_step_equals_the_step_without_a_mesh(cuda):
    """A process group of one rank over NCCL and a data=1 mesh: the step
    goes through the all-reduce of its gradients and loss terms, and its
    losses and leaves equal the mesh-less step's bit for bit (a sum over
    one rank changes nothing)."""
    import socket
    from recnet_tpu_torch.checkpoint import state_leaves
    from recnet_tpu_torch.parallel import distributed as dist
    from recnet_tpu_torch.parallel import mesh as mesh_lib
    from recnet_tpu_torch.training import step as S
    rng = np.random.default_rng(5)
    videos = torch.from_numpy(rng.standard_normal((B, L, F)).astype(
        np.float32)).to(cuda)
    captions = rng.integers(3, V, (9, B)).astype(np.int32)
    captions[5:] = 0
    captions = torch.from_numpy(captions).to(cuda)
    tc = _train_config("global").replace(mesh_shape=(("data", 1),))
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    # initialize() takes a count of 1 for a single-process run: make the
    # one-rank group directly
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        assert dist.device() == torch.device("cuda",
                                             torch.cuda.current_device())
        runs = {}
        for name in ("plain", "mesh"):
            mesh = (mesh_lib.make_mesh(tc.mesh_shape) if name == "mesh"
                    else None)
            state, dcfg, rcfg = S.init_train_state(0, tc, V, cuda)
            fn = S.build_train_step(tc, dcfg, rcfg, mesh)
            losses = [float(fn(state, videos, captions)["loss"])
                      for _ in range(3)]
            runs[name] = losses, state_leaves(state)
        assert mesh_lib.step_shard(mesh, B, V).data_group is not None
    finally:
        dist.shutdown()
    assert runs["mesh"][0] == runs["plain"][0]
    for a, b in zip(runs["mesh"][1], runs["plain"][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_captioner_on_two_entries_of_the_card(cuda, dtype):
    """A 'data' mesh listing the card twice: each chunk in two shards, one
    parameter set (with its kernels' layouts) per entry, K2 for greedy and
    K3 for beam 5 launched by both shards; the tokens equal the plain
    Captioner's."""
    from recnet_tpu_torch.data.vocab import Vocab
    from recnet_tpu_torch.models.decoder import config_from_train
    from recnet_tpu_torch.parallel.mesh import make_mesh
    from recnet_tpu_torch.serving import Captioner
    tc = _train_config(None)
    vocab = Vocab(tc.init_word2idx_dict, 1)
    vocab.build([" ".join(f"w{i}" for i in range(V - 3))], str.split)
    p = random_params(config_from_train(tc, vocab.n_vocabs), 0)
    p["out_w"] = p["out_w"] * 8.0
    rng = np.random.default_rng(6)
    feats = [rng.standard_normal((int(rng.integers(5, 12)), F)).astype(
        np.float32) for _ in range(21)]
    kw = dict(dtype=dtype, batch_size=16, use_pallas=True, greedy_segment=4,
              device="cuda")
    plain = Captioner(tc, vocab, p, **kw)
    meshed = Captioner(tc, vocab, p, mesh=make_mesh(
        (("data", 2),), ["cuda:0", "cuda:0"]), **kw)
    for beam in (None, 5):
        k2 = wd.whole_greedy_decode_segment.n_launches
        k3 = topk_proj.outproj_topk.n_launches
        got = meshed.caption(feats, beam_width=beam)
        launched = (wd.whole_greedy_decode_segment.n_launches - k2,
                    topk_proj.outproj_topk.n_launches - k3)
        assert launched[0 if beam is None else 1] > 0
        assert got == plain.caption(feats, beam_width=beam)


# --------------------------------------------------------------------------
# the training rollouts' kernels (csrc/rollout.cu) and Functions
# --------------------------------------------------------------------------

# the flagship's shapes: B = 100 rows; the decoder's GRU 512 with attention
# 128 over 28 x 1536 features, the reconstructor's LSTM 1536
FB, FF, FE, FA = 100, 28, 1536, 128
# f32: the kernels and their plain versions compute the same f32 formulas,
# the attention's sums (over H = 512, A = 128, E = 1536) in another order,
# whose noise scales with the summed terms: rtol 1e-5 and an atol of 1e-5
# of the output's largest value (measured on the H100: 1.2e-5 at most, on
# scores of magnitude 1-5). bf16: both compute in f32 from the same bf16
# operands and round once, so a value may land one bf16 ulp apart (rtol
# 2^-7 = 2 ulps), and a sum over values stored and read again (ctx from
# the scores, dh from dwh) by 2 ulps of the output's largest value
def _roll_close(got, want, dtype, what=""):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    # each output's largest difference, and the share of its bound that it
    # takes (pytest -rP shows them)
    diff = np.abs(got - want)
    bound = tol * np.abs(want) + tol * np.abs(want).max()
    share = np.divide(diff, bound, out=np.zeros_like(diff), where=bound > 0)
    print(f"{what}: max |kernel - plain| {diff.max():.3g}, "
          f"{share.max():.3f} of the bound")
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


# the margins' seeds: the first is the one each test used alone before
ROLL_SEEDS = (0, 1, 2, 3, 4)


def _roll_tensors(device, dtype, seed, *shapes, scale=0.5):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(s, generator=g) * scale).to(device, dtype)
            for s in shapes]


@pytest.mark.parametrize("seed", ROLL_SEEDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell,h", [("GRU", 512), ("LSTM", 1536),
                                    ("LSTM", 512), ("GRU", 1536)])
def test_rollout_cell_kernels_match_their_plain_versions(cuda, dtype, cell,
                                                         h, seed):
    from recnet_tpu_torch.ops.cuda import rollout
    n = 4 if cell == "LSTM" else 3
    lstm = cell == "LSTM"
    gx, gh, bias, hp, cp, dh, dh_out, dc = _roll_tensors(
        cuda, dtype, 1 + seed, (FB, n * h), (FB, n * h), (n * h,), (FB, h),
        (FB, h), (FB, h), (FB, h), (FB, h), scale=1.5)
    gh = None if lstm else gh
    fwd = (cell, gx, gh, bias, hp, cp if lstm else None)
    got = rollout.cell_forward(*fwd)
    want = rollout.cell_forward_reference(*fwd)
    for name, g, w in zip(("h", "c", "acts"), got, want):
        if w is not None:
            _roll_close(g, w, dtype, f"seed {seed} forward {name}")
    acts, c_t = want[2], want[1]
    bwd = (cell, dh, dh_out, dc if lstm else None, acts, hp,
           cp if lstm else None, c_t if lstm else None)
    got = rollout.cell_backward(*bwd)
    want = rollout.cell_backward_reference(*bwd)
    torch.cuda.synchronize()
    for name, g, w in zip(("dgi", "dgh", "dh", "dc"), got, want):
        if w is not None:
            _roll_close(g, w, dtype, f"seed {seed} backward {name}")


# the flagship's widths, then widths that do not divide by the attention
# kernels' 8 blocks a row or by a 16-byte copy (E = 77 and 19: enc's
# slices are read by plain loads), below 8 (A = 5: some blocks hold no
# column of dwh) and above a block's 256 threads (A = 300); wh and dwh
# rows lie beside a product's other columns (row stride h + a), as the
# rollout lays them out
@pytest.mark.parametrize("seed", ROLL_SEEDS)
@pytest.mark.parametrize("dtype,b,h,a,f,e", [
    (torch.float32, FB, 512, FA, FF, FE), (torch.bfloat16, FB, 512, FA, FF,
                                           FE),
    (torch.float32, 3, 5, 40, 5, 77), (torch.float32, 2, 100, 300, 9, 19),
    (torch.bfloat16, 3, 7, 5, 3, 40)])
def test_rollout_attention_kernels_match_their_plain_versions(cuda, dtype, b,
                                                              h, a, f, e,
                                                              seed):
    from recnet_tpu_torch.ops.cuda import rollout
    gw, uv, bb, w, enc, dctx, act = _roll_tensors(
        cuda, dtype, 2 + seed, (b, h + a), (b, f, a), (a,), (a, 1),
        (b, f, e), (b, e), (b, f, a))
    wh = gw[:, h:]
    act = torch.tanh(act * 2)
    got = rollout.attention_forward(wh, uv, bb, w, enc)
    want = rollout.attention_forward_reference(wh, uv, bb, w, enc)
    for name, g, x in zip(("scores", "ctx"), got, want):
        _roll_close(g, x, dtype, f"seed {seed} forward {name}")
    dgw = torch.zeros_like(gw)
    got = rollout.attention_backward(dctx, enc, act, w,
                                     out=(None, dgw[:, h:]))
    want = rollout.attention_backward_reference(dctx, enc, act, w)
    torch.cuda.synchronize()
    for name, g, x in zip(("dscores", "dwh"), got, want):
        _roll_close(g, x, dtype, f"seed {seed} backward {name}")
    assert not dgw[:, :h].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,probe", [("forward", "scores"),
                                        ("forward", "ctx"),
                                        ("backward", "dscores"),
                                        ("backward", "dwh")])
def test_rollout_attention_probes_match_their_plain_parts(cuda, dtype, kind,
                                                          probe):
    """Each split probe at the flagship's widths against its plain part
    (the kernel's plain version with the dropped part's values zero),
    within _roll_close; the probes count no launch."""
    from recnet_tpu_torch.ops.cuda import rollout
    wh, uv, bb, w, enc, dctx, act = _roll_tensors(
        cuda, dtype, 9, (FB, FA), (FB, FF, FA), (FA,), (FA, 1),
        (FB, FF, FE), (FB, FE), (FB, FF, FA))
    operands = ((wh, uv, bb, w, enc) if kind == "forward" else
                (dctx, enc, torch.tanh(act * 2), w))
    rollout.reset_counts()
    got = rollout.attention_probe(kind, probe, *operands)
    want = rollout.attention_probe_reference(kind, probe, *operands)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        _roll_close(g, x, dtype, f"probe {kind} {probe}")
    assert [fn.n_launches for fn in rollout.KERNELS] == [0] * 6


def _rollout_leaves(cell, device, seed):
    """The decoder rollout's and the reconstructor's inputs at the small
    widths (H = 16, A = 8, F = 24 features of 7 frames, B = 13, T = 9),
    float32 leaves on ``device``."""
    n = 4 if cell == "LSTM" else 3
    g = torch.Generator().manual_seed(seed)
    shapes = {"W": (H, A), "U": (F, A), "b": (A,), "w": (A, 1),
              "w_enc": (F, n * H), "w_hh": (H, n * H), "b_hh": (n * H,),
              "enc": (B, L, F), "gi": (9, B, n * H), "h0": (B, H),
              "c0": (B, H), "dhs": (9, B, H)}
    return {k: (torch.randn(s, generator=g) * 0.5).to(device)
            .requires_grad_(k != "dhs") for k, s in shapes.items()}


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_rollout_functions_on_the_card_match_the_cpu(cuda, cell):
    """Forward and backward of the decoder's and the reconstructor's
    Functions on the card (their kernels) against their CPU runs (the
    plain versions), f32: rtol 1e-4 / atol 1e-5 over 9 steps of sums in
    another order. Each wrapper launched once a step."""
    from recnet_tpu_torch.models.decoder import tf_attn_rollout
    from recnet_tpu_torch.ops import rnn
    from recnet_tpu_torch.ops.cuda import rollout
    runs = {}
    for dev in ("cpu", "cuda"):
        x = _rollout_leaves(cell, dev, 7)
        rollout.reset_counts()
        att = {k: x[k] for k in ("W", "U", "b", "w")}
        hs = tf_attn_rollout(cell, att, x["w_enc"], x["w_hh"], x["b_hh"],
                             x["enc"], x["enc"] @ x["U"], x["gi"])
        hs.backward(x["dhs"])
        rec = (rnn.lstm_rollout_pre(x["w_hh"], x["b_hh"], x["gi"], x["h0"],
                                    x["c0"]) if cell == "LSTM" else
               rnn.gru_rollout_pre(x["w_hh"], x["b_hh"], x["gi"], x["h0"]))
        rec.backward(x["dhs"])
        runs[dev] = [hs, rec] + [x[k].grad for k in x
                                 if k != "dhs" and x[k].grad is not None]
        if dev == "cuda":
            torch.cuda.synchronize()
            # f32: the decoder's rollout on the per-step kernels; the
            # reconstructor's in one whole-rollout launch a direction (the
            # route ops.rnn.whole_rollout gives a width this small)
            assert [fn.n_launches for fn in rollout.KERNELS] == [9, 9, 9, 9,
                                                                 1, 1]
    for got, want in zip(runs["cuda"], runs["cpu"]):
        np.testing.assert_allclose(got.detach().cpu().numpy(),
                                   want.detach().numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_rollout_bf16_autocast_on_the_card(cuda):
    """Under bf16 autocast the Functions run their kernels in bf16 and
    return gradients in the leaves' f32; within 5% of the f32 run's (the
    bf16 train step's own bound against f32)."""
    from recnet_tpu_torch.models.decoder import tf_attn_rollout
    from recnet_tpu_torch.ops.cuda import rollout
    runs = []
    for autocast in (False, True):
        x = _rollout_leaves("GRU", "cuda", 8)
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            att = {k: x[k] for k in ("W", "U", "b", "w")}
            hs = tf_attn_rollout("GRU", att, x["w_enc"], x["w_hh"],
                                 x["b_hh"], x["enc"], x["enc"] @ x["U"],
                                 x["gi"])
            assert hs.dtype == (torch.bfloat16 if autocast
                                else torch.float32)
            (hs.float() * x["dhs"]).sum().backward()
        assert all(x[k].grad.dtype == torch.float32 for k in att)
        runs.append([hs.float()] + [x[k].grad for k in ("W", "w_hh", "enc")])
    for got, want in zip(runs[1], runs[0]):
        np.testing.assert_allclose(got.detach().cpu().numpy(),
                                   want.detach().cpu().numpy(), rtol=0.05,
                                   atol=0.05 * float(want.abs().max()))
    assert rollout.attention_backward.n_launches > 0


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_reconstructor_rollout_bf16_takes_the_whole_rollout_kernels(cuda,
                                                                    cell):
    """In f32 and under bf16 autocast the reconstructor's Function runs one
    launch of each whole-rollout kernel and no per-step kernel, and returns
    gradients in the leaves' f32 within 5% of the f32 run's (the bf16
    train step's own bound against f32)."""
    from recnet_tpu_torch.ops import rnn
    from recnet_tpu_torch.ops.cuda import rollout
    runs = []
    for autocast in (False, True):
        x = _rollout_leaves(cell, "cuda", 10)
        rollout.reset_counts()
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            hs = (rnn.lstm_rollout_pre(x["w_hh"], x["b_hh"], x["gi"],
                                       x["h0"], x["c0"]) if cell == "LSTM"
                  else rnn.gru_rollout_pre(x["w_hh"], x["b_hh"], x["gi"],
                                           x["h0"]))
            (hs.float() * x["dhs"]).sum().backward()
        torch.cuda.synchronize()
        assert [fn.n_launches for fn in rollout.KERNELS] == [0, 0, 0, 0, 1,
                                                             1]
        leaves = ["w_hh", "b_hh", "gi", "h0"] + (["c0"] if cell == "LSTM"
                                                 else [])
        assert all(x[k].grad.dtype == torch.float32 for k in leaves)
        runs.append([hs.float()] + [x[k].grad for k in leaves])
    for got, want in zip(runs[1], runs[0]):
        np.testing.assert_allclose(got.detach().cpu().numpy(),
                                   want.detach().cpu().numpy(), rtol=0.05,
                                   atol=0.05 * float(want.abs().max()))


# the cell forward kernel against its first design (the "scalar" probe,
# one thread a (row, unit)): the flagship's widths and 515, which is no
# whole number of the kernel's two-unit runs (each row's last run is cut,
# and the gates' runs lie off their alignment, so the kernel reads and
# writes element by element), at 1, 100 and 1024 rows; f32 bit-equal to it
# (the same arithmetic, expression for expression), bf16 within 2 ulps of
# it, and both within the rollout bound of the plain version
CELL_FWD_WIDTHS = (512, 1536, 515)
CELL_FWD_ROWS = (1, FB, 1024)


def _bf16_ulps(got, want):
    """The largest distance between two bf16 tensors in bf16 ulps (the
    bit patterns on one integer line; +0 and -0 both 0)."""
    def line(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        mag = bits & 0x7FFF
        return torch.where(bits >= 0x8000, -mag, mag)
    return int((line(got) - line(want)).abs().max())


def _held_to_first_design(got, first, want, dtype, what,
                          names=("h", "c", "acts")):
    for name, g, s, w in zip(names, got, first, want):
        if w is None:
            continue
        if dtype == torch.float32:
            assert torch.equal(g, s), f"{what} {name}: not bit-equal"
        else:
            assert _bf16_ulps(g, s) <= 2, f"{what} {name}"
        _roll_close(g, w, dtype, f"{what} {name}")


def _cell_forward_inputs(device, dtype, cell, h, rows, seed, pad=0,
                           shift=0):
    """``cell_forward``'s operands; the gate products' rows ``pad``
    elements wider than they are long and their start ``shift`` elements
    into their buffer."""
    n, lstm = (4 if cell == "LSTM" else 3), cell == "LSTM"
    gxb, ghb, bias, hp, cp = _roll_tensors(
        device, dtype, 30 + seed, (rows, n * h + pad + shift),
        (rows, n * h + pad + shift), (n * h,), (rows, h), (rows, h),
        scale=1.5)
    gx, gh = gxb[:, shift:shift + n * h], ghb[:, shift:shift + n * h]
    return (cell, gx, None if lstm else gh, bias, hp, cp if lstm else None)


@pytest.mark.parametrize("seed", ROLL_SEEDS)
@pytest.mark.parametrize("rows", CELL_FWD_ROWS)
@pytest.mark.parametrize("h", CELL_FWD_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_cell_forward_matches_its_first_design(cuda, cell, dtype, h, rows,
                                               seed):
    from recnet_tpu_torch.ops.cuda import rollout
    fwd = _cell_forward_inputs(cuda, dtype, cell, h, rows, seed)
    got = rollout.cell_forward(*fwd)
    first = rollout.cell_forward_probe("scalar", *fwd)
    want = rollout.cell_forward_reference(*fwd)
    torch.cuda.synchronize()
    _held_to_first_design(got, first, want, dtype,
                          f"{cell} {h} x {rows} seed {seed}")


# gate products whose rows lie beside other columns (128 more: the whole
# runs stay; 3 more: element by element) or start one element into their
# buffer (element by element)
CELL_LAYOUTS = [(128, 0, True), (3, 0, False), (0, 1, False)]


@pytest.mark.parametrize("pad,shift,vector", CELL_LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_cell_forward_on_strided_and_unaligned_gates(cuda, cell, dtype, pad,
                                                     shift, vector):
    from recnet_tpu_torch.ops.cuda import rollout
    fwd = _cell_forward_inputs(cuda, dtype, cell, 512, FB, 0, pad, shift)
    got = rollout.cell_forward(*fwd)
    first = rollout.cell_forward_probe("scalar", *fwd)
    want = rollout.cell_forward_reference(*fwd)
    torch.cuda.synchronize()
    assert _route(lambda: rollout.cell_forward(*fwd), "cell_fwd") \
        == ("runs" if vector else "tail")
    _held_to_first_design(got, first, want, dtype,
                          f"{cell} pad {pad} shift {shift}")


def _route(fn, kernel):
    """Which of ``kernel``'s two kernels (``<kernel>_kernel`` on whole
    runs, ``<kernel>_tail_kernel`` element by element) three calls of
    ``fn`` launched, by the names in a profile: "runs", "tail" or both.
    A few spin kernels open each session, since the profiler may miss a
    session's first events; a session that shows neither kernel (the
    profiler now and then reports none of a session's events) is run
    again, five at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        names = {ev.name for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA}
        seen = {route for route, name in
                (("runs", f"::{kernel}_kernel<"),
                 ("tail", f"::{kernel}_tail_kernel<"))
                if any(name in n for n in names)}
        if seen:
            break
    return "+".join(sorted(seen))


@pytest.mark.parametrize("h", [512, 515])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_cell_kernels_take_whole_runs_where_the_width_allows(cuda, cell,
                                                             dtype, h):
    """Contiguous operands: whole runs at an even width, the element-by-
    element kernel at 515, forward and backward."""
    from recnet_tpu_torch.ops.cuda import rollout
    want = "runs" if h % 2 == 0 else "tail"
    fwd = _cell_forward_inputs(cuda, dtype, cell, h, FB, 0)
    assert _route(lambda: rollout.cell_forward(*fwd), "cell_fwd") == want
    bwd = _cell_backward_inputs(cuda, dtype, cell, h, FB, 0)
    assert _route(lambda: rollout.cell_backward(*bwd), "cell_bwd") == want


@pytest.mark.parametrize("h", [512, 515])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_cell_forward_probes_match_their_plain_versions(cuda, cell, dtype,
                                                        h):
    """"copy" bit-equal to its plain version (one or two sums an output);
    "empty" launches and returns None; no probe counts a launch."""
    from recnet_tpu_torch.ops.cuda import rollout
    fwd = _cell_forward_inputs(cuda, dtype, cell, h, FB, 1)
    rollout.reset_counts()
    got = rollout.cell_forward_probe("copy", *fwd)
    want = rollout.cell_forward_probe_reference("copy", *fwd)
    assert rollout.cell_forward_probe("empty", *fwd) is None
    torch.cuda.synchronize()
    for name, g, w in zip(("h", "c", "acts"), got, want):
        if w is not None:
            assert torch.equal(g, w), name
    assert rollout.cell_forward.n_launches == 0
    with pytest.raises(ValueError, match="no cell forward probe"):
        rollout.cell_forward_probe("gates", *fwd)


# the cell backward kernel against its first design, at the forward's
# widths and rows
def _cell_backward_inputs(device, dtype, cell, h, rows, seed):
    from recnet_tpu_torch.ops.cuda import rollout
    lstm = cell == "LSTM"
    fwd = _cell_forward_inputs(device, dtype, cell, h, rows, seed)
    _, c_t, acts = rollout.cell_forward_reference(*fwd)
    dh, dh_out, dc = _roll_tensors(device, dtype, 40 + seed, (rows, h),
                                   (rows, h), (rows, h))
    return (cell, dh, dh_out, dc if lstm else None, acts, fwd[4],
            fwd[5] if lstm else None, c_t if lstm else None)


CELL_BWD_NAMES = ("dgi", "dgh", "dh_cell", "dc_prev")


@pytest.mark.parametrize("seed", ROLL_SEEDS)
@pytest.mark.parametrize("rows", CELL_FWD_ROWS)
@pytest.mark.parametrize("h", CELL_FWD_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_cell_backward_matches_its_first_design(cuda, cell, dtype, h, rows,
                                                seed):
    from recnet_tpu_torch.ops.cuda import rollout
    bwd = _cell_backward_inputs(cuda, dtype, cell, h, rows, seed)
    got = rollout.cell_backward(*bwd)
    first = rollout.cell_backward_probe("scalar", *bwd)
    want = rollout.cell_backward_reference(*bwd)
    torch.cuda.synchronize()
    _held_to_first_design(got, first, want, dtype,
                          f"{cell} {h} x {rows} seed {seed}", CELL_BWD_NAMES)


# the gate cotangents' rows beside other columns or one element into their
# buffer (as the forward's gates), no output cotangent, and the carries
# updated in place (dh_cell into dh, dc_prev into dc: the rollouts' use)
@pytest.mark.parametrize("pad,shift,vector", CELL_LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_cell_backward_on_strided_gates_and_in_place_carries(
        cuda, cell, dtype, pad, shift, vector):
    from recnet_tpu_torch.ops.cuda import rollout
    lstm, h = cell == "LSTM", 512
    G = (4 if lstm else 3) * h
    _, dh, _, dc, acts, hp, cp, c_t = _cell_backward_inputs(
        cuda, dtype, cell, h, FB, 2)
    bwd = (cell, dh, None, dc, acts, hp, cp, c_t)
    first = rollout.cell_backward_probe("scalar", *bwd)
    want = rollout.cell_backward_reference(*bwd)
    bufs = [torch.zeros((FB, G + pad + shift), dtype=dtype, device=cuda)
            for _ in range(2)]
    dgi, dgh = (b[:, shift:shift + G] for b in bufs)
    out = (dgi, dgh, None if lstm else dh, dc if lstm else None)
    got = rollout.cell_backward(*bwd, out=out)
    torch.cuda.synchronize()
    assert got[0] is dgi and (got[2] is dh if not lstm else got[3] is dc)
    _held_to_first_design(got, first, want, dtype,
                          f"{cell} pad {pad} shift {shift}", CELL_BWD_NAMES)
    # the carries are the cotangents' in place, so route on fresh ones
    fresh = (cell, dh.clone(), None, dc.clone() if lstm else None, acts, hp,
             cp, c_t)
    assert _route(lambda: rollout.cell_backward(
        *fresh, out=(dgi, dgh, None if lstm else fresh[1],
                     fresh[3] if lstm else None)), "cell_bwd") \
        == ("runs" if vector else "tail")


def test_rollout_wrappers_reject_and_count(cuda):
    from recnet_tpu_torch.ops.cuda import rollout
    gx, bias, hp, cp = _roll_tensors(cuda, torch.float32, 3, (B, 4 * H),
                                     (4 * H,), (B, H), (B, H))
    with pytest.raises(ValueError, match="operands on"):
        rollout.cell_forward("LSTM", gx, None, bias.cpu(), hp, cp)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rollout.cell_forward("LSTM", gx, None, bias.double(), hp, cp)
    with pytest.raises(ValueError, match="one dtype"):
        rollout.cell_forward("LSTM", gx.bfloat16(), None, bias, hp, cp)
    with pytest.raises(ValueError, match="contiguous"):
        rollout.cell_forward("LSTM", gx.t().contiguous().t(), None, bias,
                             hp, cp)
    with pytest.raises(ValueError, match="gx"):
        rollout.cell_forward("LSTM", gx[:, :-1], None, bias, hp, cp)
    wh, uv, b, w, enc = _roll_tensors(cuda, torch.float32, 4, (B, A),
                                      (B, L, A), (A,), (A, 1), (B, L, F))
    with pytest.raises(ValueError, match="uv"):
        rollout.attention_forward(wh, uv[:, :-1], b, w, enc)
    with pytest.raises(ValueError, match="contiguous"):
        rollout.attention_backward(enc[:, 0].contiguous(), enc,
                                   uv.transpose(0, 1)
                                   .contiguous().transpose(0, 1), w)
    with pytest.raises(ValueError, match="contiguous rows"):
        rollout.attention_forward(wh.t().contiguous().t(), uv, b, w, enc)
    rollout.reset_counts()
    rollout.cell_forward("LSTM", gx, None, bias, hp, cp)
    rollout.cell_forward_reference("LSTM", gx, None, bias, hp, cp)
    rollout.attention_forward(wh, uv, b, w, enc)
    assert rollout.cell_forward.n_launches == 1
    assert rollout.cell_forward.cell_launches == {"LSTM": 1}
    assert rollout.attention_forward.n_launches == 1


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_rollout_step_launchers_on_the_card_equal_the_wrappers(cuda, cell):
    """``*_steps`` (operands checked once, arguments made once) launch the
    same kernels as the wrappers: bit-equal outputs, one count a step; the
    gate products' and wh's rows lie beside other columns, as the decoder
    rollout lays them out."""
    from recnet_tpu_torch.ops.cuda import rollout
    n, lstm, T = (4 if cell == "LSTM" else 3), cell == "LSTM", 5
    gx, ghw, bias, h0, c0, dhs = _roll_tensors(
        cuda, torch.float32, 6, (T, B, n * H + A), (T, B, n * H + A),
        (n * H,), (B, H), (B, H), (T, B, H))
    gx, gh = gx[..., :n * H], ghw[..., :n * H]
    hs, cs = torch.empty_like(dhs), torch.empty_like(dhs)
    acts = dhs.new_empty((T, B, 4 * H))
    rollout.reset_counts()
    launch = rollout.cell_forward_steps(
        cell, gx, None if lstm else gh, bias, h0, c0 if lstm else None, hs,
        cs if lstm else None, acts)
    for t in range(T):
        launch(t)
    assert rollout.cell_forward.cell_launches == {cell: T}
    h, c = h0, c0
    for t in range(T):
        h, c, a = rollout.cell_forward(cell, gx[t], None if lstm else gh[t],
                                       bias, h, c if lstm else None)
        assert torch.equal(hs[t], h) and torch.equal(acts[t], a)
    h_prev = torch.cat([h0[None], hs[:-1]])
    c_prev = torch.cat([c0[None], cs[:-1]])
    dgi = gx.new_empty(gx.shape)
    dgh = ghw.new_empty(ghw.shape)[..., :n * H]
    dh, dc = torch.zeros_like(h0), torch.zeros_like(c0)
    launch = rollout.cell_backward_steps(cell, dh, dhs, dc, acts, h_prev,
                                         c_prev, cs, dgi, dgh)
    want_dh, want_dc = torch.zeros_like(h0), torch.zeros_like(c0)
    for t in reversed(range(T)):
        launch(t)
        wgi, _, wdh, wdc = rollout.cell_backward(
            cell, want_dh, dhs[t], want_dc if lstm else None, acts[t],
            h_prev[t], c_prev[t] if lstm else None, cs[t] if lstm else None)
        assert torch.equal(dgi[t], wgi)
        assert torch.equal(dc, wdc) if lstm else torch.equal(dh, wdh)
        want_dc = wdc
        dh.copy_(dgi[t][:, :H]) if lstm else dh.add_(dgi[t][:, :H])
        want_dh = dh.clone()
    assert rollout.cell_backward.cell_launches == {cell: 2 * T}
    uv, b, w, enc, dctx, act = _roll_tensors(
        cuda, torch.float32, 7, (B, L, A), (A,), (A, 1), (B, L, F),
        (T, B, F), (T, B, L, A))
    whs = ghw[..., n * H:]
    scores, ctxs = dhs.new_empty((T, B, L)), dhs.new_empty((T, B, F))
    launch = rollout.attention_forward_steps(whs, uv, b, w, enc, scores,
                                             ctxs)
    for t in range(T):
        launch(t)
        s, x = rollout.attention_forward(whs[t], uv, b, w, enc)
        assert torch.equal(scores[t], s) and torch.equal(ctxs[t], x)
    dsc, dgw = dhs.new_empty((T, B, L)), ghw.new_zeros(ghw.shape)
    launch = rollout.attention_backward_steps(dctx, enc, act, w, dsc,
                                              dgw[..., n * H:])
    for t in reversed(range(T)):
        launch(t)
        s, x = rollout.attention_backward(dctx[t], enc, act[t], w)
        assert torch.equal(dsc[t], s) and torch.equal(dgw[t][:, n * H:], x)
    assert not dgw[..., :n * H].any()
    torch.cuda.synchronize()
    assert [fn.n_launches for fn in rollout.KERNELS] == [2 * T] * 4 + [0, 0]
    with pytest.raises(ValueError, match="contiguous"):
        rollout.attention_backward_steps(dctx.transpose(1, 2).contiguous()
                                         .transpose(1, 2), enc, act, w, dsc,
                                         dgw[..., n * H:])


def test_rollout_step_launchers_hold_their_operands(cuda):
    """A launcher made from tensors that nothing else holds still writes
    its own buffers after the allocator has handed out memory again."""
    from recnet_tpu_torch.ops.cuda import rollout
    T, G = 3, 3 * H
    launch = rollout.cell_forward_steps(
        "GRU", *_roll_tensors(cuda, torch.float32, 8, (T, B, G), (T, B, G),
                              (G,), (B, H)), None,
        torch.zeros((T, B, H), device=cuda), None,
        torch.zeros((T, B, 4 * H), device=cuda))
    hs = launch.operands[4]          # gx, gh, bias, h0, hs, acts
    others = [torch.full((T, B, n), 7.0, device=cuda)
              for n in (G, G, H, 4 * H) for _ in range(4)]
    for t in range(T):
        launch(t)
    torch.cuda.synchronize()
    assert torch.isfinite(hs).all() and not bool((hs == 7.0).any())
    assert all(bool((o == 7.0).all()) for o in others)


# the whole-rollout cell kernels (csrc/cell_rollout.cu): the flagship's
# reconstructor (B = 100, H = 1536, T = 31) and odd widths: H not a
# multiple of 16 (37, and 200 = 12.5 x 16), B = 7, and B = 130 (two
# passes of the batch: 112 rows and 18)
CELL_ROLL_WIDTHS = [(FB, 1536, 31), (FB, 37, 9), (7, 37, 9), (7, 200, 9),
                    (130, 64, 9)]


def _cell_roll_operands(cell, b, h, t, dtype, seed):
    n = 4 if cell == "LSTM" else 3
    w, bias, gi, h0, c0, dhs = _roll_tensors(
        "cuda", dtype, 20 + seed, (h, n * h), (n * h,), (t, b, n * h),
        (b, h), (b, h), (t, b, h))
    w = w * (2.0 / h ** 0.5)               # U(-1/sqrt(H), ..)'s scale
    return w.to(dtype), bias, gi * 3, h0, c0 if cell == "LSTM" else None, dhs


def _drift(got, want, dtype, what):
    """Print the largest |got - want| and its share of _roll_close's bound
    (a bf16 run's drift from the plain loop over chained steps)."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    diff = np.abs(got - want)
    bound = tol * np.abs(want) + tol * np.abs(want).max()
    print(f"{what}: chained, max |kernel - plain| {diff.max():.3g}, "
          f"{(diff / np.maximum(bound, 1e-30)).max():.3f} of the bound")


@pytest.mark.parametrize("seed", ROLL_SEEDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t", CELL_ROLL_WIDTHS)
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_cell_rollout_kernels_match_their_plain_versions(cuda, cell, b, h, t,
                                                         dtype, seed):
    """Every output of the forward (hs, cs, acts) and of the backward
    (dgates / dgi and dgh, dh0, dc0, and the carries into each step)
    against the plain versions on the same inputs, within _roll_close; one
    launch a direction. Each step is held against the plain step from the
    kernel's own previous state (forward) or carries (backward); f32 also
    over the whole chain. In bf16 a value one ulp apart at step t feeds
    every later step, so two runs that each round right drift apart over
    31 steps: that drift is printed, not bounded."""
    from recnet_tpu_torch.ops.cuda import rollout
    lstm = cell == "LSTM"
    w, bias, gi, h0, c0, dhs = _cell_roll_operands(cell, b, h, t, dtype,
                                                   seed)
    rollout.reset_counts()
    got = rollout.cell_rollout_forward(cell, gi, w, bias, h0, c0)
    stepwise = rollout.cell_rollout_forward_reference(
        cell, gi, w, bias, h0, c0, states=got[:2])
    chained = rollout.cell_rollout_forward_reference(cell, gi, w, bias, h0,
                                                     c0)
    torch.cuda.synchronize()
    for name, g, x, y in zip(("hs", "cs", "acts"), got, stepwise, chained):
        if x is None:
            assert g is None and y is None
            continue
        _roll_close(g, x, dtype, f"seed {seed} forward {name}, each step")
        if dtype == torch.float32:
            _roll_close(g, y, dtype, f"seed {seed} forward {name}, chained")
        else:
            _drift(g, y, dtype, f"seed {seed} forward {name}")
    hs, cs, acts = chained
    steps = (h0.new_empty((t, b, h)),
             h0.new_empty((t, b, h)) if lstm else None)
    got = rollout.cell_rollout_backward(cell, dhs, acts, w, h0, hs, c0, cs,
                                        steps_out=steps)
    want_steps = (torch.empty_like(steps[0]),
                  torch.empty_like(steps[0]) if lstm else None)
    stepwise = rollout.cell_rollout_backward_reference(
        cell, dhs, acts, w, h0, hs, c0, cs, steps_out=want_steps,
        carries=steps)
    chained = rollout.cell_rollout_backward_reference(cell, dhs, acts, w, h0,
                                                      hs, c0, cs)
    torch.cuda.synchronize()
    names = ("dgi", "dgh", "dh0", "dc0", "dh_steps", "dc_steps")
    for name, g, x, y in zip(names, tuple(got) + steps,
                             tuple(stepwise) + want_steps,
                             tuple(chained) + (None, None)):
        if x is None:
            assert g is None
            continue
        _roll_close(g, x, dtype, f"seed {seed} backward {name}, each step")
        if y is None:
            continue
        if dtype == torch.float32:
            _roll_close(g, y, dtype, f"seed {seed} backward {name}, chained")
        else:
            _drift(g, y, dtype, f"seed {seed} backward {name}")
    assert not steps[0][-1].any()
    if lstm:
        assert got[0] is got[1]
    assert rollout.cell_rollout_forward.cell_launches == {cell: 1}
    assert rollout.cell_rollout_backward.cell_launches == {cell: 1}


def test_cell_rollout_grid_that_cannot_be_co_resident_raises(cuda):
    """A grid of more clusters than the card holds at once is refused
    before any launch; the wrappers' own plans fit."""
    from recnet_tpu_torch.ops.cuda import rollout
    w, bias, gi, h0, c0, dhs = _cell_roll_operands("LSTM", FB, 1536, 3,
                                                   torch.bfloat16, 0)
    for forward in (True, False):
        plan, _ = rollout.rollout_plan("LSTM", forward, torch.bfloat16, FB,
                                       1536, cuda)
        assert 0 < plan["clusters"] <= plan["capacity"]
        assert plan["rows"] in rollout.ROLLOUT_WIDTHS
        assert plan["smem"] <= plan["smem_limit"]
        print(f"forward={forward}: {plan}")
    rollout.reset_counts()
    with pytest.raises(RuntimeError, match="co-resident"):
        rollout.cell_rollout_forward("LSTM", gi, w, bias, h0, c0,
                                     clusters=100_000)
    hs, cs, acts = rollout.cell_rollout_forward_reference(
        "LSTM", gi, w, bias, h0, c0)
    with pytest.raises(RuntimeError, match="co-resident"):
        rollout.cell_rollout_backward("LSTM", dhs, acts, w, h0, hs, c0, cs,
                                      clusters=100_000)
    assert rollout.cell_rollout_forward.n_launches == 0
    assert rollout.cell_rollout_backward.n_launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t", [(FB, 1536, 31), (130, 64, 9)])
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_cell_rollout_reruns_are_bit_equal(cuda, cell, b, h, t, dtype):
    """Two launches on the same inputs give bit-equal outputs, forward and
    backward (the kernels' sums keep a fixed order and add no value
    atomically); the second runs on the readiness words the first left."""
    from recnet_tpu_torch.ops.cuda import rollout
    lstm = cell == "LSTM"
    w, bias, gi, h0, c0, dhs = _cell_roll_operands(cell, b, h, t, dtype, 4)
    runs = []
    for _ in range(2):
        fwd = rollout.cell_rollout_forward(cell, gi, w, bias, h0, c0)
        hs, cs, acts = fwd
        steps = (h0.new_empty((t, b, h)),
                 h0.new_empty((t, b, h)) if lstm else None)
        bwd = rollout.cell_rollout_backward(cell, dhs, acts, w, h0, hs, c0,
                                            cs, steps_out=steps)
        runs.append(tuple(fwd) + tuple(bwd) + steps)
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert (first is None) == (second is None)
        if first is not None:
            assert torch.equal(first, second)


def test_cell_rollout_plan_the_card_cannot_hold_raises(cuda):
    """bf16 plans that a block cannot hold are refused before any launch:
    more product rows than the widest wgmma body (104), and a held slice of
    W_hh beyond the card's shared memory a block; the wrappers raise and
    count nothing."""
    from recnet_tpu_torch.ops.cuda import rollout
    bf16 = torch.bfloat16
    with pytest.raises(ValueError, match="product rows"):
        rollout.rollout_plan("LSTM", True, bf16, FB, 4096, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        rollout.rollout_plan("LSTM", True, bf16, FB, 8192, cuda,
                             clusters=4096)
    w, bias, gi, h0, c0, dhs = _cell_roll_operands("LSTM", 8, 512, 2, bf16,
                                                   0)
    rollout.reset_counts()
    with pytest.raises(ValueError, match="product rows"):
        rollout.cell_rollout_forward("LSTM", gi, w, bias, h0, c0, clusters=1)
    hs, cs, acts = rollout.cell_rollout_forward_reference("LSTM", gi, w,
                                                          bias, h0, c0)
    with pytest.raises(ValueError, match="product rows"):
        rollout.cell_rollout_backward("LSTM", dhs, acts, w, h0, hs, c0, cs,
                                      clusters=1)
    assert rollout.cell_rollout_forward.n_launches == 0
    assert rollout.cell_rollout_backward.n_launches == 0


def test_cell_rollout_wrappers_hold_their_operands(cuda):
    """Wrapper calls on tensors that nothing else holds write what the
    plain versions give, after the allocator has handed out memory again,
    and write nothing else."""
    from recnet_tpu_torch.ops.cuda import rollout

    def operands():
        return _cell_roll_operands("GRU", 13, 48, 5, torch.float32, 1)

    def gi():
        return operands()[2]

    def w():
        return operands()[0]

    def bias():
        return operands()[1]

    def h0():
        return operands()[3]

    def dhs():
        return operands()[5]

    hs, _, acts = rollout.cell_rollout_forward("GRU", gi(), w(), bias(),
                                               h0(), None)
    others = [torch.full((5, 13, n), 7.0, device=cuda)
              for n in (48, 144, 192) for _ in range(4)]
    dgi, dgh, dh0, _ = rollout.cell_rollout_backward(
        "GRU", dhs(), acts, w(), h0(), hs, None, None)
    fillers = [torch.full((5, 13, n), 7.0, device=cuda)
               for n in (48, 144, 192) for _ in range(4)]
    torch.cuda.synchronize()
    want = rollout.cell_rollout_forward_reference("GRU", gi(), w(), bias(),
                                                  h0(), None)
    _roll_close(hs, want[0], torch.float32, "hs")
    want_b = rollout.cell_rollout_backward_reference(
        "GRU", dhs(), want[2], w(), h0(), want[0], None, None)
    for g, x in zip((dgi, dgh, dh0), want_b):
        _roll_close(g, x, torch.float32, "backward")
    assert all(bool((o == 7.0).all()) for o in others + fillers)


def test_cell_rollout_wrappers_reject_and_count(cuda):
    from recnet_tpu_torch.ops.cuda import rollout
    w, bias, gi, h0, c0, dhs = _cell_roll_operands("LSTM", 13, 16, 4,
                                                   torch.float32, 2)
    with pytest.raises(ValueError, match="operands on"):
        rollout.cell_rollout_forward("LSTM", gi, w, bias.cpu(), h0, c0)
    with pytest.raises(ValueError, match="one dtype"):
        rollout.cell_rollout_forward("LSTM", gi, w.bfloat16(), bias, h0, c0)
    with pytest.raises(ValueError, match="contiguous"):
        rollout.cell_rollout_forward("LSTM", gi, w.t().contiguous().t(),
                                     bias, h0, c0)
    rollout.reset_counts()
    hs, cs, acts = rollout.cell_rollout_forward("LSTM", gi, w, bias, h0, c0)
    rollout.cell_rollout_backward("LSTM", dhs, acts, w, h0, hs, c0, cs)
    rollout.cell_rollout_probe("forward", "product", "LSTM", gi, w, bias, h0,
                               c0)
    assert [fn.n_launches for fn in rollout.KERNELS] == [0] * 4 + [1, 1]
    assert rollout.cell_rollout_forward.cell_launches == {"LSTM": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_cell_rollout_probes(cuda, cell, dtype):
    """The product probe (P = 0) equals the plain versions with w_hh = 0,
    within _roll_close; the exchange probe's outputs are finite."""
    from recnet_tpu_torch.ops.cuda import rollout
    w, bias, gi, h0, c0, dhs = _cell_roll_operands(cell, FB, 1536, 4, dtype,
                                                   3)
    zero = torch.zeros_like(w)
    got = rollout.cell_rollout_probe("forward", "product", cell, gi, w, bias,
                                     h0, c0)
    want = rollout.cell_rollout_forward_reference(cell, gi, zero, bias, h0,
                                                  c0)
    for g, x in zip(got, want):
        if x is not None:
            _roll_close(g, x, dtype, "forward product probe")
    hs, cs, acts = want
    got = rollout.cell_rollout_probe("backward", "product", cell, dhs, acts,
                                     w, h0, hs, c0, cs)
    want = rollout.cell_rollout_backward_reference(cell, dhs, acts, zero, h0,
                                                   hs, c0, cs)
    for g, x in zip(got, want):
        if x is not None:
            _roll_close(g, x, dtype, "backward product probe")
    for kind, operands in (("forward", (cell, gi, w, bias, h0, c0)),
                           ("backward", (cell, dhs, acts, w, h0, hs, c0,
                                         cs))):
        for x in rollout.cell_rollout_probe(kind, "exchange", *operands):
            assert x is None or bool(torch.isfinite(x.float()).all())


@pytest.mark.parametrize("b,h", [(FB, 1536), (FB, 37)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_cell_rollout_mma_probe_matches_its_plain_part(cuda, cell, dtype, b,
                                                       h):
    """The mma probe (the staging kept, with f32's weight stream and split:
    H = 37 copies W_hh element by element, 1536 by bulk copies; the MMAs
    dropped, so P = 0) equals the plain versions with w_hh = 0 within
    _roll_close, forward and backward; the product probe likewise at the
    odd width."""
    from recnet_tpu_torch.ops.cuda import rollout
    w, bias, gi, h0, c0, dhs = _cell_roll_operands(cell, b, h, 4, dtype, 3)
    zero = torch.zeros_like(w)
    want = rollout.cell_rollout_forward_reference(cell, gi, zero, bias, h0,
                                                  c0)
    hs, cs, acts = want
    want_b = rollout.cell_rollout_backward_reference(cell, dhs, acts, zero,
                                                     h0, hs, c0, cs)
    for probe in ("mma", "product"):
        got = rollout.cell_rollout_probe("forward", probe, cell, gi, w,
                                         bias, h0, c0)
        for g, x in zip(got, want):
            if x is not None:
                _roll_close(g, x, dtype, f"forward {probe} probe")
        got = rollout.cell_rollout_probe("backward", probe, cell, dhs, acts,
                                         w, h0, hs, c0, cs)
        for g, x in zip(got, want_b):
            if x is not None:
                _roll_close(g, x, dtype, f"backward {probe} probe")


# --------------------------------------------------------------------------
# the f32 route: K1/K2's TF32 body and K3's TF32 split route
# --------------------------------------------------------------------------

F32_ROWS = 0.99                 # rows of f32 tokens equal to the twin's
H_RTOL, H_ATOL = 1e-4, 1e-5     # f32 h and c against the twin
TF32_SEEDS = range(5)
TF32_E, TF32_F = 468, 1536      # the flagship's embedding and features


def _tf32_operands(cell, device, b, h=512, seed=0, v=4188):
    """Flagship-width f32 operands (E 468, F 1536, A 128, L 28) at H = h."""
    cfg = DecoderConfig(cell_type=cell, vocab_size=v, embedding_size=TF32_E,
                        encoder_size=TF32_F, hidden_size=h, attn_size=128)
    params = params_from_jax(random_params(cfg, seed), device, torch.float32)
    enc = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, 28, TF32_F)).astype(np.float32)).to(device)
    r = params["rnn"][0]
    return cfg, (params, enc, precompute_uv(params["attention"], enc),
                 torch.stack([r["b_ih"], r["b_hh"]]))


def _zero_start(device, b, h, sos=1):
    z = torch.zeros((b, h), device=device)
    return z, z, torch.full((b, 1), sos, dtype=torch.int32, device=device)


def _share(rows):
    """The share of True in ``rows``, in float64 (99 of 100 is 0.99)."""
    return rows.double().mean().item()


@pytest.mark.parametrize("seed", TF32_SEEDS)
@pytest.mark.parametrize("b", [1, 100, 1024])
@pytest.mark.parametrize("h", [512, 528])   # 528: 33 unit tiles, uneven
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_tf32_body_matches_the_twin_and_the_cuda_core_body(cuda, cell, h, b,
                                                           seed):
    """K1 and K2 (two chained segments of 4) on the TF32 body against the
    twin and against the first design (``cuda_cores``): tokens on F32_ROWS
    of rows, h and c within H_RTOL / H_ATOL on them. Under 100 rows the
    bound allows no row off, so B = 1 pools 100 launches of one row."""
    launches = max(1, 100 // b)
    cfg, ops = _tf32_operands(cell, cuda, b * launches, h, seed)
    kw = dict(emb_size=TF32_E, cell_type=cell)
    bodies = wd.whole_greedy_decode.body_launches
    n = bodies["tf32"]
    parts = [tuple(x[i * b:(i + 1) * b] for x in ops[1:3])
             for i in range(launches)]
    got, cores, want, k_rows, k_outs, t_outs = [], [], [], [], [], []
    for enc, uv in parts:
        one = (ops[0], enc, uv, ops[3])
        got.append(wd.whole_greedy_decode(*one, max_len=MAX_LEN, **kw))
        cores.append(wd.whole_greedy_decode(*one, max_len=MAX_LEN,
                                            cuda_cores=True, **kw))
        want.append(wd.whole_greedy_decode_reference(*one, max_len=MAX_LEN,
                                                     **kw))
        k_state = t_state = _zero_start(cuda, b, h)
        for _ in range(2):
            k_out = wd.whole_greedy_decode_segment(*one, *k_state, seg_len=4,
                                                   **kw)
            t_out = wd.whole_greedy_decode_segment_reference(
                *one, *t_state, seg_len=4, **kw)
            k_state, t_state = k_out[1:], t_out[1:]
        k_outs.append(k_out)
        t_outs.append(t_out)
    torch.cuda.synchronize()
    assert bodies["tf32"] == n + launches
    got, cores, want = (torch.cat(x) for x in (got, cores, want))
    for other in (want, cores):
        assert _share((got == other).all(dim=1)) >= F32_ROWS
    k_out = [torch.cat(x) for x in zip(*k_outs)]
    t_out = [torch.cat(x) for x in zip(*t_outs)]
    rows = (k_out[0] == t_out[0]).all(dim=1)
    assert _share(rows) >= F32_ROWS
    for i in (1, 2):
        torch.testing.assert_close(k_out[i][rows], t_out[i][rows],
                                   rtol=H_RTOL, atol=H_ATOL)


@pytest.mark.parametrize("b", [1, 100])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_tf32_body_is_bit_equal_at_every_cluster_size(cuda, cell, b):
    """C = 1, 2, 4, 8 blocks a tile of 8 rows: the tokens, h and c of K2
    (T steps from <SOS>) bit-equal to C = 1's, and the twin's tokens on
    F32_ROWS of rows; the wrapper picks C = 8 at B = 1 and 100."""
    cfg, ops = _tf32_operands(cell, cuda, b, seed=3)
    kw = dict(emb_size=TF32_E, cell_type=cell, seg_len=MAX_LEN + 1)
    start = _zero_start(cuda, b, 512)
    assert wd.cluster_size(b, 512, torch.cuda.get_device_properties(
        cuda).multi_processor_count) == 8
    want = wd.whole_greedy_decode_segment_reference(*ops, *start, **kw)
    first = None
    for c in (1, 2, 4, 8, None):
        got = wd.whole_greedy_decode_segment(*ops, *start, cluster=c, **kw)
        torch.cuda.synchronize()
        if first is None:
            first = got
        assert all(torch.equal(x, y) for x, y in zip(got, first))
    assert _share((first[0] == want[0]).all(dim=1)) >= F32_ROWS


def test_tf32_body_refuses_a_cluster_it_cannot_take(cuda):
    cfg, ops = _tf32_operands("GRU", cuda, 8)
    for c in (3, 16):
        with pytest.raises(ValueError, match="cluster"):
            wd.whole_greedy_decode(*ops, emb_size=TF32_E, max_len=2, cluster=c)


def test_tf32_early_exit_matches_twin(cuda):
    """The early exit on the TF32 body, at a cluster of 8 and of 1, with
    <PAD> lifted: each block's tokens equal the twin's, 0 after its stop."""
    cfg, (params, enc, uv, bias2) = _tf32_operands("GRU", cuda, 100, seed=4)
    params = dict(params, out_b=params["out_b"].clone())
    params["out_b"][0] += 3.0
    ops = (params, enc, uv, bias2)
    kw = dict(emb_size=TF32_E, max_len=MAX_LEN, early_exit=True)
    want = wd.whole_greedy_decode_reference(*ops, **kw)
    for c in (8, 1):
        got = wd.whole_greedy_decode(*ops, cluster=c, **kw)
        torch.cuda.synchronize()
        assert _share((got == want).all(dim=1)) >= F32_ROWS
    assert bool((want == 0).any())


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_tf32_wide_decoder_runs_on_the_cuda_core_body(cuda, cell):
    """H = 1536: the TF32 body's rows do not fit a block, so the f32
    launch runs on the CUDA-core body by the rule, counted there."""
    cfg, ops = _tf32_operands(cell, cuda, 16, h=1536, seed=5)
    bodies = wd.whole_greedy_decode.body_launches
    n = bodies["cuda_cores"]
    kw = dict(emb_size=TF32_E, max_len=3, cell_type=cell)
    got = wd.whole_greedy_decode(*ops, **kw)
    want = wd.whole_greedy_decode_reference(*ops, **kw)
    torch.cuda.synchronize()
    assert bodies["cuda_cores"] == n + 1
    assert _share((got == want).all(dim=1)) >= F32_ROWS


def _kernel_names(fn, part):
    """Whether a kernel whose name holds ``part`` runs in ``fn``, by
    torch.profiler: each session opens with spin kernels (the profiler
    misses a session's first device events) and, as chip_smoke.py's
    device_ms does, a session that reports none of ``fn``'s kernels is run
    again, three times at most. Returns the names of the last session."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if "spin_kernel" not in e.name}
        if any(part in n for n in names):
            break
    return names


def test_f32_routes_by_kernel_name(cuda):
    """f32 K1/K2 launch tf32_decode_kernel, ``cuda_cores`` the CUDA-core
    body's whole_decode_kernel; f32 K3 with k <= 8 the float split and
    merge kernels, ``f32_single_pass`` the single pass; bf16 is unchanged
    (tc_decode_kernel, the bf16 split kernel)."""
    cfg, ops = _tf32_operands("GRU", cuda, 100)
    kw = dict(emb_size=TF32_E, max_len=MAX_LEN)
    has = lambda fn, part: any(part in n for n in _kernel_names(fn, part))
    assert has(lambda: wd.whole_greedy_decode(*ops, **kw),
               "tf32_decode_kernel")
    assert has(lambda: wd.whole_greedy_decode(*ops, cuda_cores=True, **kw),
               "whole_decode_kernel")
    assert not has(lambda: wd.whole_greedy_decode(*ops, **kw),
                   "whole_decode_kernel")
    out = torch.tanh(torch.randn((500, 512), device=cuda))
    w, b = ops[0]["out_w"], ops[0]["out_b"]
    assert has(lambda: topk_proj.outproj_topk(out, w, b, k=5),
               "topk_split_kernel<float")
    assert has(lambda: topk_proj.outproj_topk(out, w, b, k=5,
                                              f32_single_pass=True),
               "topk_proj_kernel<float")
    bf = params_from_jax(random_params(cfg, 0), cuda, torch.bfloat16)
    enc = ops[1].bfloat16()
    r = bf["rnn"][0]
    b_ops = (bf, enc, precompute_uv(bf["attention"], enc),
             torch.stack([r["b_ih"], r["b_hh"]]))
    assert has(lambda: wd.whole_greedy_decode(*b_ops, **kw),
               "tc_decode_kernel")
    assert has(lambda: topk_proj.outproj_topk(out.bfloat16(), bf["out_w"],
                                              bf["out_b"], k=5),
               "topk_split_kernel<__nv_bfloat16")


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_tf32_layout_mirror_equals_the_kernel(cuda, cell):
    lib = wd._library("whole_decode_tf32")
    n_gates = 3 if cell == "GRU" else 4
    for shape in ((28, 128, 468 + 1536, 512), (7, 8, 36, 16),
                  (28, 128, 2004, 528)):
        want = wd.tf32_smem_bytes(n_gates, *shape)
        assert lib.recnet_whole_decode_tf32_smem(n_gates, *shape) == want


TF32_VARIANTS = ([{}, dict(early_exit=True), dict(dual=True)]
                 + [dict(ablate=p) for p in ("emb", "attn", "score1", "fma",
                                             "proj", "nativeargmax",
                                             "argmax")])


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_tf32_variant_layout_mirror_equals_the_kernel(cuda, cell):
    """Every variant's shared memory, dual's 16-row layout included: the
    Python mirror against the probes' library's count (the production
    library's, for production's layout, in the test above)."""
    n_gates = 3 if cell == "GRU" else 4
    lib = wd._library("whole_decode_tf32_probes")
    for L, A, E, F, H in ((28, 128, 468, 1536, 512), (7, 8, 12, 24, 16),
                          (28, 128, 468, 1536, 528), (28, 128, 13, 40, 32)):
        for options in TF32_VARIANTS:
            v = wd.kernel_route(torch.float32, H, **options).variant
            want = wd.tf32_smem_bytes(n_gates, L, A, E + F, H, v, E)
            assert lib.recnet_whole_decode_tf32_variant_smem(
                n_gates, v, L, A, E, E + F, H) == want


def _tf32_start(device, b, h, seed):
    """A carried state that is not zero (h in (-0.5, 0.5), c about 0.5),
    and <SOS>."""
    g = torch.Generator(device=device).manual_seed(seed)
    h0 = 0.5 * torch.tanh(torch.randn((b, h), generator=g, device=device))
    c0 = 0.5 * torch.randn((b, h), generator=g, device=device)
    return h0, c0, torch.full((b, 1), 1, dtype=torch.int32, device=device)


@pytest.mark.parametrize("b", [45, 100, 1004, 2048])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_k5_dual_tf32_bit_equal_to_k1(cuda, cell, b):
    """dual on the TF32 body (16-row tiles, two halves sharing each weight
    fragment): tokens, h and c bit-equal to TF32 production K1's from a
    carried state at every cluster size and the wrapper's pick, ragged
    tails included; through K1's wrapper counted as "dual[tf32]" and equal
    to production's tokens."""
    cfg, ops = _tf32_operands(cell, cuda, b, seed=b)
    kw = dict(emb_size=TF32_E, n_steps=MAX_LEN + 1, cell_type=cell,
              emb_scale=1.0)
    start = _tf32_start(cuda, b, 512, b)
    want = wd._launch(*ops, *start, route=wd.kernel_route(torch.float32, 512),
                      **kw)
    dual = wd.kernel_route(torch.float32, 512, dual=True)
    assert dual.library == "whole_decode_tf32_probes"
    for c in (1, 2, 4, 8, None):
        got = wd._launch(*ops, *start, route=dual, cluster=c, **kw)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y), f"cluster {c}"
    counts = wd.whole_greedy_decode.variant_launches
    n = counts["dual[tf32]"]
    k1 = dict(emb_size=TF32_E, max_len=MAX_LEN, cell_type=cell)
    got = wd.whole_greedy_decode(*ops, dual=True, **k1)
    assert counts["dual[tf32]"] == n + 1
    assert torch.equal(got, wd.whole_greedy_decode(*ops, **k1))


@pytest.mark.parametrize("part", ["emb", "attn", "score1", "fma", "proj",
                                  "nativeargmax", "argmax"])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_k5_ablate_tf32_matches_the_three_term_twin(cuda, cell, part):
    """Each ablate part on the TF32 body (out_w x 4: a clear top-2 margin)
    against the twin with the body's three-term products and that part:
    tokens on F32_ROWS of rows; counted as "ablate=<part>[tf32]";
    ``nativeargmax`` equal to production's tokens bit for bit."""
    cfg = DecoderConfig(cell_type=cell, vocab_size=4188,
                        embedding_size=TF32_E, encoder_size=TF32_F,
                        hidden_size=512, attn_size=128)
    p = random_params(cfg, 11)
    p["out_w"] = p["out_w"] * 4.0
    params = params_from_jax(p, cuda, torch.float32)
    enc = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (100, 28, TF32_F)).astype(np.float32)).to(cuda)
    r = params["rnn"][0]
    ops = (params, enc, precompute_uv(params["attention"], enc),
           torch.stack([r["b_ih"], r["b_hh"]]))
    kw = dict(emb_size=TF32_E, cell_type=cell)
    counts = wd.whole_greedy_decode.variant_launches
    n = counts[f"ablate={part}[tf32]"]
    got = wd.whole_greedy_decode(*ops, max_len=MAX_LEN, ablate=part, **kw)
    assert counts[f"ablate={part}[tf32]"] == n + 1
    z, _, sos = _zero_start(cuda, 100, 512)
    want = wd._decode_reference(*ops, z, z, sos, n_steps=MAX_LEN + 1,
                                emb_scale=1.0, ablate=part,
                                matmul=wd.matmul_3xtf32_reference, **kw)[0]
    torch.cuda.synchronize()
    assert _share((got == want).all(dim=1)) >= F32_ROWS
    if part == "nativeargmax":
        assert torch.equal(got, wd.whole_greedy_decode(
            *ops, max_len=MAX_LEN, **kw))


def test_f32_probes_by_kernel_name(cuda):
    """f32 dual and ablate launch tf32_decode_kernel; under cuda_cores
    the CUDA-core body's whole_decode_kernel."""
    cfg, ops = _tf32_operands("GRU", cuda, 100)
    kw = dict(emb_size=TF32_E, max_len=MAX_LEN)
    has = lambda fn, part: any(part in n for n in _kernel_names(fn, part))
    for options in (dict(dual=True), dict(ablate="attn")):
        assert has(lambda: wd.whole_greedy_decode(*ops, **options, **kw),
                   "tf32_decode_kernel")
        assert has(lambda: wd.whole_greedy_decode(
            *ops, cuda_cores=True, **options, **kw), "whole_decode_kernel")


def test_f32_parameter_sets_carry_the_tf32_tiles(cuda):
    """f32 params on the card carry the TF32 body's tiles, made once; K1
    gives the same tokens with them as with tiles made for the call."""
    cfg, ops = _tf32_operands("GRU", cuda, 100)
    params = ops[0]
    assert params["layouts"]["gates"].dtype == torch.float32
    bare = {k: v for k, v in params.items() if k != "layouts"}
    kw = dict(emb_size=TF32_E, max_len=MAX_LEN)
    assert torch.equal(wd.whole_greedy_decode(*ops, **kw),
                       wd.whole_greedy_decode(bare, *ops[1:], **kw))


@pytest.mark.parametrize("seed", TF32_SEEDS)
@pytest.mark.parametrize("n,k", [(500, 5), (5120, 5), (1001, 1), (77, 8)])
def test_k3_tf32_split_matches_twin_and_single_pass(cuda, n, k, seed):
    """K3's f32 split route at the flagship width: columns equal the
    twin's and the single pass's on 99% of rows, values within 1e-5 on
    them; counted as "tf32_split"."""
    out, w, b = _topk_operands(cuda, n, 512, 4188, torch.float32, seed=seed)
    out = torch.tanh(out)
    routes = topk_proj.outproj_topk.route_launches
    m = routes["tf32_split"]
    got = topk_proj.outproj_topk(out, w, b, k=k)
    single = topk_proj.outproj_topk(out, w, b, k=k, f32_single_pass=True)
    want = topk_proj.outproj_topk_reference(out, w, b, k=k)
    torch.cuda.synchronize()
    assert routes["tf32_split"] == m + 1
    for other in (want, single):
        rows = (got[1] == other[1]).all(dim=1)
        assert _share(rows) >= 0.99
        torch.testing.assert_close(got[0][rows], other[0][rows], rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------------------
# the embedding gather's backward (csrc/embedding_backward.cu)
# --------------------------------------------------------------------------

# the train cells' shape: T 31 x B 1024 input tokens, E 468, V 4188
CELL_T, CELL_B, CELL_E, CELL_V = 31, 1024, 468, 4188


def _embedding_case(case, device, seed=0):
    """(tokens (N,), d_rows (N, E), V, R) of a named case."""
    rng = np.random.default_rng(seed)
    if case == "cell":
        tok = caption_inputs(seed, CELL_T, CELL_B, CELL_V).reshape(-1)
        e, v, r = CELL_E, CELL_V, 64
    else:
        pattern, r, e = case.split("/")
        r, e, v = int(r), int(e), 41
        tok = tokens(pattern, 203, v, seed=r + e)
    d_rows = torch.from_numpy(rng.standard_normal(
        (tok.numel(), e)).astype(np.float32))
    return tok.to(device), d_rows.to(device), v, r


EMBEDDING_CASES = (["cell"]
                   + [f"traffic/{r}/{e}" for r in (1, 4, 64) for e in (5, 468)]
                   + [f"same/{r}/5" for r in (1, 4, 64)]
                   + ["ends/4/468", "ends/64/468", "sparse/4/5",
                      "negative/4/5"])


def _assert_summed(got, tok, d_rows, v):
    """``got`` within 1e-5 of float64 ``index_put_`` with accumulate,
    relative to |value| plus the sum of the magnitudes added into it: the
    scale of any float32 summation's rounding (a <PAD> row of 23,000
    normal rows sums to hundreds from terms of 18,000 in magnitude)."""
    idx = (tok.long() % v,)
    zeros = torch.zeros((v, d_rows.shape[1]), dtype=torch.float64,
                        device=d_rows.device)
    want = zeros.clone().index_put_(idx, d_rows.double(), accumulate=True)
    mag = zeros.index_put_(idx, d_rows.double().abs(), accumulate=True)
    err = (got.double() - want).abs()
    assert bool((err <= 1e-5 * (want.abs() + mag)).all()), float(err.max())


@pytest.mark.parametrize("token_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("case", EMBEDDING_CASES)
def test_embedding_backward_matches_f64_index_put(cuda, case, token_dtype):
    """The kernel bit for bit against its twin on the CPU (the same
    order), and against float64 ``index_put_`` with accumulate
    (``_assert_summed``); one launch counted; rows no token reads are
    zeros."""
    from recnet_tpu_torch.ops.cuda import embedding
    tok, d_rows, v, r = _embedding_case(case, cuda)
    tok = tok.to(token_dtype)
    n = embedding.embedding_backward.n_launches
    got = embedding.embedding_backward(tok, d_rows, v, tile_rows=r)
    torch.cuda.synchronize()
    assert embedding.embedding_backward.n_launches == n + 1
    twin = embedding.embedding_backward_reference(tok.cpu(), d_rows.cpu(), v,
                                                  tile_rows=r)
    assert torch.equal(got.cpu(), twin)
    _assert_summed(got, tok, d_rows, v)
    hit = torch.zeros(v, dtype=torch.bool, device=cuda)
    hit[tok.long() % v] = True
    assert not got[~hit].any()


def test_embedding_backward_takes_unaligned_rows(cuda):
    """d_rows 4 bytes past a 16-byte boundary: the one-float route, bit
    for bit as the twin."""
    from recnet_tpu_torch.ops.cuda import embedding
    tok, d_rows, v, r = _embedding_case("cell", cuda, seed=1)
    flat = torch.empty(d_rows.numel() + 1, device=cuda)
    shifted = flat[1:].view_as(d_rows).copy_(d_rows)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    got = embedding.embedding_backward(tok, shifted, v, tile_rows=r)
    assert torch.equal(got, embedding.embedding_backward(tok, d_rows, v))
    assert torch.equal(got.cpu(), embedding.embedding_backward_reference(
        tok.cpu(), d_rows.cpu(), v))


def test_embedding_backward_is_bitwise_repeatable(cuda):
    """Five calls at the cell's shape, the same bits."""
    from recnet_tpu_torch.ops.cuda import embedding
    tok, d_rows, v, r = _embedding_case("cell", cuda, seed=2)
    first = embedding.embedding_backward(tok, d_rows, v, tile_rows=r)
    for _ in range(4):
        again = embedding.embedding_backward(tok, d_rows, v, tile_rows=r)
        assert torch.equal(again, first)


def test_embedding_backward_refuses_on_the_card(cuda):
    from recnet_tpu_torch.ops.cuda import embedding
    tok, d_rows, v, r = _embedding_case("traffic/4/468", cuda)
    for bad_tok, bad_rows in ((tok, d_rows.to(torch.bfloat16)),
                              (tok, d_rows.t().contiguous().t()),
                              (tok.cpu(), d_rows),
                              (tok[::2], d_rows[::2])):
        with pytest.raises(ValueError):
            embedding.embedding_backward(bad_tok, bad_rows, v)


def test_embed_route_issues_no_sync(cuda):
    """A forward and backward of ``vocab.embed`` on the kernel's route
    under ``set_sync_debug_mode("error")``: no host synchronisation, one
    launch, the gradient of ``_assert_summed``."""
    from recnet_tpu_torch.ops.cuda import embedding
    from recnet_tpu_torch.parallel import vocab as vocab_par
    tok = caption_inputs(3, CELL_T, 64, CELL_V).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn(CELL_V, CELL_E, device=cuda, generator=g)
    table.requires_grad_(True)
    d = torch.randn(*tok.shape, CELL_E, device=cuda, generator=g)
    torch.cuda.synchronize()
    n = embedding.embedding_backward.n_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        (vocab_par.embed(table, tok) * d).sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert embedding.embedding_backward.n_launches == n + 1
    _assert_summed(table.grad, tok.reshape(-1), d.reshape(-1, CELL_E),
                   CELL_V)


def test_embed_route_rule_on_the_card(cuda, monkeypatch):
    """The kernel only for a float32 table that requires grad, grad mode
    on, without a 'model' group."""
    from recnet_tpu_torch.ops.cuda import embedding
    from recnet_tpu_torch.parallel import mesh as t_mesh
    from recnet_tpu_torch.parallel import vocab as vocab_par
    tok = caption_inputs(4, 5, 8, 40).to(cuda)
    base = torch.randn(40, 12, device=cuda)

    def launches(table, shard=None, grad=True):
        n = embedding.embedding_backward.n_launches
        with torch.set_grad_enabled(grad):
            rows = vocab_par.embed(table, tok, shard)
            if rows.requires_grad:
                rows.float().sum().backward()
        torch.cuda.synchronize()
        return embedding.embedding_backward.n_launches - n

    assert launches(base.clone().requires_grad_(True)) == 1
    assert launches(base.clone().requires_grad_(True), grad=False) == 0
    assert launches(base.clone()) == 0
    assert launches(base.to(torch.bfloat16).requires_grad_(True)) == 0
    monkeypatch.setattr(vocab_par._SumOverModel, "apply",
                        lambda x, group: x)
    shard = t_mesh.Shard(rows=(0, 8, 8), cols=(0, 40, 40),
                         model_group=object())
    assert launches(base.clone().requires_grad_(True), shard) == 0


@pytest.mark.parametrize("prec", ["float32", "bfloat16"])
def test_train_step_gradients_with_the_embedding_kernel(cuda, monkeypatch,
                                                        prec):
    """One step with the global reconstructor from one state, the kernel's
    route against the plain gather's (``_kernel_gather`` off): every leaf's
    gradient within rtol 1e-5 and 1e-5 of its largest |g|; one launch a
    step on the route, none off it. In bf16 the rollouts run under autocast
    over the float32 masters, so the table and the rows' cotangent are
    float32 and the gather takes the kernel as in f32."""
    from recnet_tpu_torch.ops.cuda import embedding
    from recnet_tpu_torch.parallel import vocab as vocab_par
    from recnet_tpu_torch.training import step as S
    rng = np.random.default_rng(5)
    videos = torch.from_numpy(rng.standard_normal((B, L, F)).astype(
        np.float32)).to(cuda)
    captions = rng.integers(3, V, (9, B)).astype(np.int32)
    captions[5:] = 0
    captions = torch.from_numpy(captions).to(cuda)
    grads = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(vocab_par, "_kernel_gather",
                                lambda *a: False)
        tc = _train_config("global", train_precision=prec)
        state, dcfg, rcfg = S.init_train_state(0, tc, V, "cuda")
        fn = S.build_train_step(tc, dcfg, rcfg)
        n = embedding.embedding_backward.n_launches
        fn(state, videos, captions)
        torch.cuda.synchronize()
        assert embedding.embedding_backward.n_launches - n == (
            1 if route == "kernel" else 0)
        grads[route] = [p.grad.detach().cpu().numpy().copy()
                        for opt in (state.dec_opt, state.rec_opt)
                        for p in opt.param_groups[0]["params"]]
    assert len(grads["kernel"]) == len(grads["plain"])
    for got, want in zip(grads["kernel"], grads["plain"]):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# --------------------------------------------------------------------------
# the train step's GEMM on three TF32 terms (ops/cuda/gemm.py)
# --------------------------------------------------------------------------

GEMM_ERR_RATIO = 2.0    # the kernel's error within this of cuBLAS f32's


@pytest.mark.parametrize("case", gemm_cases.CASES,
                         ids=[c[0] for c in gemm_cases.CASES])
def test_gemm_at_the_train_shapes(cuda, case):
    """Every product of the train cells at its shape and layout: the
    kernel's max |C - C64| / max |C64| at most twice cuBLAS f32's
    (``mm_reference``), which a one-term TF32 product (the operands rounded
    to TF32, summed in float64) exceeds; five calls give the same bits; one
    launch a product; ``mm`` launches it where ``kernel_pays``."""
    from recnet_tpu_torch.ops.cuda import gemm
    name, kind, M, K, N, epi = case
    a, b, bias, buf = gemm_cases.operands(kind, M, K, N, epi, 0, cuda)
    gemm.launch.n_launches = 0
    got = gemm_cases.run(gemm.launch, a, b, bias, buf, epi)
    torch.cuda.synchronize()
    assert gemm.launch.n_launches == 1
    for _ in range(4):
        assert torch.equal(gemm_cases.run(gemm.launch, a, b, bias, buf,
                                          epi), got)
    assert gemm.launch.n_launches == 5
    routed = gemm_cases.run(gemm.mm, a, b, bias, buf, epi)
    pays = gemm.kernel_pays(M, N, K, gemm._n_sms(a.device))
    assert gemm.launch.n_launches == 5 + pays
    if pays:
        assert torch.equal(routed, got)
    want = gemm_cases.exact(a, b, bias, buf, epi)
    limit = GEMM_ERR_RATIO * gemm_cases.rel_err(
        gemm_cases.run(gemm.mm_reference, a, b, bias, buf, epi), want)
    assert gemm_cases.rel_err(got, want) <= limit
    ctl = gemm_cases.exact(a, b, bias, buf, epi, wd.tf32_round,
                           wd.tf32_round)
    assert gemm_cases.rel_err(ctl.float(), want) > limit


@pytest.mark.parametrize("kind", ["fwd", "dx", "dw"])
@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (5, 3, 7), (129, 33, 131),
                                   (300, 468, 4188), (64, 4100, 200),
                                   (1000, 8200, 5)])
def test_gemm_ragged_and_unaligned(cuda, kind, M, K, N):
    """Shapes off the tile and off 4, a split-K case (K over 4096 on few
    tiles) and operands one float past an aligned start (4-byte copies):
    each element within (K + 16) u (|A| |B|)_ij of float64 (u = 2^-24: a
    float32 sum of K products, and the three terms' 2^-21 a product)."""
    from recnet_tpu_torch.ops.cuda import gemm
    for offset in (0, 1):
        a, b, _, _ = gemm_cases.operands(kind, M, K + offset, N, "", 1, cuda)
        a, b = a[:, offset:], b[offset:]
        got = gemm.launch(a, b)
        want = a.double() @ b.double()
        scale = a.double().abs() @ b.double().abs()
        assert bool(((got.double() - want).abs()
                     <= (K + 16) * 2.0 ** -24 * scale).all())


def test_gemm_refuses_on_the_card(cuda):
    from recnet_tpu_torch.ops.cuda import gemm
    a, b = torch.randn(8, 4, device=cuda), torch.randn(4, 6, device=cuda)
    with pytest.raises(ValueError):
        gemm.launch(a, b.bfloat16())
    with pytest.raises(ValueError):
        gemm.launch(a.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError):
        gemm.launch(a, b, accumulate=True)
    with pytest.raises(ValueError):
        gemm.launch(a.cpu(), b.cpu())
    n = gemm.launch.n_launches
    got = gemm.mm(a.bfloat16(), b.bfloat16())    # autocast's products
    assert got.dtype == torch.bfloat16 and gemm.launch.n_launches == n


def test_gemm_route_rule_on_the_card(cuda):
    """Under grad, f32 products that fill half a wave launch the kernel, in
    the forward and both gradients (y: 512 tiles, dx: 128, dw: 16 tiles
    split 8 ways); a product of one tile takes torch's; no_grad and
    autocast launch nothing."""
    from recnet_tpu_torch.ops.cuda import gemm
    x = torch.randn(8, 1024, 256, device=cuda, requires_grad=True)
    w = torch.randn(256, 1024, device=cuda, requires_grad=True)
    n = gemm.launch.n_launches
    gemm.matmul(x, w).sum().backward()
    torch.cuda.synchronize()
    assert gemm.launch.n_launches - n == 3          # y, dx, dw
    xs = torch.randn(3, 5, 8, device=cuda, requires_grad=True)
    ws = torch.randn(8, 6, device=cuda, requires_grad=True)
    gemm.matmul(xs, ws).sum().backward()
    with torch.no_grad():
        gemm.matmul(x, w)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        assert gemm.matmul(x, w).dtype == torch.bfloat16
    assert gemm.launch.n_launches - n == 3


@pytest.mark.parametrize("recon", ["global", "local"])
def test_train_step_with_the_gemm_against_torch_products(cuda, monkeypatch,
                                                         recon):
    """One f32 step from one state, the kernel's products against torch's
    (``gemm.mm`` as ``mm_reference``, ``product_route`` off), the kernel
    taking every product of its route (``kernel_pays`` True: at these
    widths no product fills half a wave of the card): the losses
    within rtol 1e-5 and every leaf's gradient within rtol 1e-4 and 1e-5 of
    its largest |g| (three TF32 terms err about 2^-21 a product, cuBLAS
    f32 about 2^-24 a sum's addition; both far below these); launches on
    the kernel's route only."""
    from recnet_tpu_torch.ops.cuda import gemm
    from recnet_tpu_torch.training import step as S
    rng = np.random.default_rng(6)
    videos = torch.from_numpy(rng.standard_normal((B, L, F)).astype(
        np.float32)).to(cuda)
    captions = rng.integers(3, V, (9, B)).astype(np.int32)
    captions[5:] = 0
    captions = torch.from_numpy(captions).to(cuda)
    out = {}
    for route in ("kernel", "torch"):
        if route == "kernel":
            monkeypatch.setattr(gemm, "kernel_pays", lambda *a: True)
        else:
            monkeypatch.undo()
            monkeypatch.setattr(gemm, "product_route", lambda *a: False)
            monkeypatch.setattr(gemm, "mm", gemm.mm_reference)
        tc = _train_config(recon)
        state, dcfg, rcfg = S.init_train_state(0, tc, V, "cuda")
        n = gemm.launch.n_launches
        m = S.build_train_step(tc, dcfg, rcfg)(state, videos, captions)
        torch.cuda.synchronize()
        launched = gemm.launch.n_launches - n
        assert launched > 0 if route == "kernel" else launched == 0
        out[route] = (m, [p.grad.detach().cpu().numpy().copy()
                          for opt in (state.dec_opt, state.rec_opt)
                          for p in opt.param_groups[0]["params"]])
    (mk, gk), (mt, gt) = out["kernel"], out["torch"]
    for key in ("loss", "dec_loss", "rec_loss"):
        np.testing.assert_allclose(float(mk[key]), float(mt[key]),
                                   rtol=1e-5)
    assert len(gk) == len(gt)
    for got, want in zip(gk, gt):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())
