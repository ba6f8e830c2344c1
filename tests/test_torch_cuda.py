"""The CUDA kernels on the card, against their plain twins: the whole
decode (K1/K2) with its K5 variants (early exit, dual, ablate) on both
bodies (tensor cores, and CUDA cores under ``cuda_cores``), the fused
projection + top-k (K3) and the fused attention + GRU step (K4: its
tensor-core route, each of the route's two kernels against its plain
stage, and its CUDA-core body).

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
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
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
    asked for by ``cuda_cores`` (bf16 runs on the tensor cores otherwise;
    f32 always runs on CUDA cores)."""
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
    n = wd.whole_greedy_decode.variant_launches["early_exit[cuda_cores]"]
    got = wd.whole_greedy_decode(*ops, **kw)
    want = wd.whole_greedy_decode_reference(*ops, **kw)
    torch.cuda.synchronize()
    assert (wd.whole_greedy_decode.variant_launches["early_exit[cuda_cores]"]
            == n + 1)    # f32 runs on the CUDA-core body
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


def _k4_flagship(device, b, seed):
    """K4's operands at the flagship width (E = 468, F = 1536, H = 512,
    A = 128, L = 28) in bf16, from random_params, with the parameter set's
    gate tiles: (operands, tiles)."""
    cfg = DecoderConfig(cell_type="GRU", vocab_size=V, embedding_size=468,
                        encoder_size=1536, hidden_size=512, attn_size=128)
    params = params_from_jax(random_params(cfg, seed), device,
                             torch.bfloat16)
    g = torch.Generator(device=device).manual_seed(seed)
    enc = torch.randn((b, K4_L, 1536), generator=g, device=device).bfloat16()
    h = torch.tanh(torch.randn((b, 512), generator=g, device=device))
    tok = torch.randint(0, V, (b,), generator=g, device=device)
    a, r = params["attention"], params["rnn"][0]
    ops = (params["embedding"][tok], h.bfloat16(), enc,
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
    with H = 16 on the tensor cores, f32 and H = 24 on the CUDA cores."""
    counts = fs.fused_gru_attn_step.body_launches
    cases = [(_k4_operands(cuda, torch.bfloat16, seed=51), "tensor_cores"),
             (_k4_operands(cuda, torch.float32, seed=52), "cuda_cores")]
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
    got = topk_proj.outproj_topk(out, w, b, k=k)
    want = topk_proj.outproj_topk_reference(out, w, b, k=k)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[1], torch.arange(k, device=cuda, dtype=torch.int32)
                       .expand(n, k))
    assert torch.equal(got[0], want[0])


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
    assert [fn.n_launches for fn in rollout.KERNELS] == [0, 0, 0, 0]


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
            assert [fn.n_launches for fn in rollout.KERNELS] == [18, 18, 9,
                                                                 9]
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
    assert [fn.n_launches for fn in rollout.KERNELS] == [2 * T, 2 * T, 2 * T,
                                                         2 * T]
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
