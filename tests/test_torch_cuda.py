"""The whole-decode CUDA kernels on the card, against their plain twins.

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
    from recnet_tpu.config import TrainConfig
    from recnet_tpu.data.vocab import Vocab
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
