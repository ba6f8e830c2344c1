"""The port's ``outproj_topk`` against JAX ``outproj_topk`` (Pallas,
interpret mode) on the CPU, where the wrapper runs its plain twin.

Mirrors tests/test_pallas_topk.py: the same five shapes and the tie case.
Indices must be equal; values within rtol/atol 1e-5, since the f32 sums
run in another order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recnet_tpu.ops.pallas.topk_proj import outproj_topk as j_outproj_topk
from recnet_tpu_torch.ops.cuda import topk_proj


def _both(out, w, b, k):
    """The same arrays through JAX (interpret) and the port."""
    jv, ji = j_outproj_topk(out, w, b, k=k, block_b=8, interpret=True)
    to_t = lambda x: torch.from_numpy(
        np.array(x.astype(jnp.float32))).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
    tv, ti = topk_proj.outproj_topk(to_t(out), to_t(w), to_t(b), k=k)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("n,h,v,k,dtype", [
    (16, 32, 300, 5, jnp.float32),
    (12, 32, 130, 3, jnp.float32),     # non-multiple-of-block N and V
    (128, 64, 517, 5, jnp.bfloat16),
    (7, 32, 129, 2, jnp.float32),      # N < block
    (8, 16, 128, 1, jnp.float32),      # k=1, exact lane multiple
])
def test_outproj_topk_matches_jax(n, h, v, k, dtype):
    rng = np.random.default_rng(0)
    out = jnp.asarray(rng.standard_normal((n, h)), dtype)
    w = jnp.asarray(rng.standard_normal((h, v)), dtype)
    b = jnp.asarray(rng.standard_normal((v,)), dtype)
    (jv, ji), (tv, ti) = _both(out, w, b, k)
    assert tv.dtype == np.float32 and ti.dtype == np.int32
    assert tv.shape == ti.shape == (n, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)


def test_outproj_topk_tie_order_matches_jax():
    """Repeated weight columns tie exactly: first occurrence wins."""
    h, v = 8, 256
    out = jnp.ones((8, h), jnp.float32)
    w = jnp.asarray(np.tile(np.eye(h, 8, dtype=np.float32), (1, v // 8)))
    b = jnp.zeros((v,), jnp.float32)
    (jv, ji), (tv, ti) = _both(out, w, b, 6)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ti[0], np.arange(6))
    np.testing.assert_allclose(tv, jv)


def test_outproj_topk_ties_across_many_columns():
    """Logits equal to out[:, j % 8]: every row's top k is one residue
    class in ascending columns, however far apart (as on the card, where
    the kernel walks V in tiles)."""
    h, v, k = 8, 1000, 5
    rng = np.random.default_rng(1)
    out = torch.from_numpy(rng.standard_normal((5, h)).astype(np.float32))
    w = torch.from_numpy(np.tile(np.eye(h, 8, dtype=np.float32),
                                 (1, v // 8)))
    vals, idxs = topk_proj.outproj_topk(out, w, torch.zeros(v), k=k)
    best = out.argmax(dim=1)
    for row in range(5):
        assert idxs[row].tolist() == [int(best[row]) + 8 * i
                                      for i in range(k)]
        assert (vals[row] == out[row].max()).all()


def test_outproj_topk_counts_only_kernel_launches():
    """On the CPU the wrapper runs the twin and counts no launch."""
    before = topk_proj.outproj_topk.n_launches
    topk_proj.outproj_topk(torch.ones(2, 3), torch.ones(3, 4),
                           torch.zeros(4), k=2)
    assert topk_proj.outproj_topk.n_launches == before


def test_outproj_topk_rejects_what_the_kernel_does_not_take():
    out, w, b = torch.ones(4, 8), torch.ones(8, 200), torch.zeros(200)
    for k in (0, 129):
        with pytest.raises(ValueError, match="outside"):
            topk_proj.outproj_topk(out, w, b, k=k)
    with pytest.raises(ValueError, match="outside"):
        topk_proj.outproj_topk(out, w[:, :3], b[:3], k=4)     # k > V
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        topk_proj.outproj_topk(out.half(), w.half(), b.half(), k=2)
    with pytest.raises(ValueError, match="out is torch.float32"):
        topk_proj.outproj_topk(out, w.bfloat16(), b, k=2)
    with pytest.raises(ValueError, match="disagree"):
        topk_proj.outproj_topk(out, w[:7], b, k=2)


@pytest.mark.parametrize("n,v,k,dtype,want", [
    (5120, 4188, 5, torch.bfloat16, 3),   # the flagship beam: 80 x 3 blocks
    (1001, 4188, 5, torch.bfloat16, 6),   # S k <= 32 for the merge warp
    (1001, 4188, 1, torch.bfloat16, 16),
    (64, 200, 3, torch.bfloat16, 2),      # at most one range a 128-column tile
    (20000, 4188, 5, torch.bfloat16, 1),  # more row blocks than two an SM
    (5120, 4188, 5, torch.float32, 3),    # f32: the same split, on TF32
    (5120, 4188, 9, torch.bfloat16, 0),   # k > 8: the single-pass kernel
])
def test_splits_fill_one_wave(n, v, k, dtype, want):
    assert topk_proj.splits(n, v, k, dtype, n_sms=132) == want


def test_padded_columns_is_made_once_and_follows_changes():
    """The padded out_w is made once per parameter set, kept with it
    (``params["layouts"]``, through the Decoder module too) and dropped by
    a cast; made again, it follows a change of the weight."""
    from recnet_tpu_torch.models.decoder import Decoder, DecoderConfig
    from recnet_tpu_torch.ops.cuda.layout import (kernel_layouts,
                                                  padded_columns)
    from recnet_tpu_torch.weights import (cast_params, params_from_jax,
                                          params_to_numpy, random_params)
    cfg = DecoderConfig(vocab_size=4188, embedding_size=8, encoder_size=8,
                        hidden_size=16, attn_size=16)
    params = params_from_jax(random_params(cfg, 0), "cpu", torch.bfloat16)
    assert "layouts" not in params                # only on a card
    params["layouts"] = kernel_layouts(params)
    w, p = params["out_w"], params["layouts"]["out_w_padded"]
    assert p.shape == (16, 4192) and p.is_contiguous()
    assert torch.equal(p[:, :4188], w) and not p[:, 4188:].any()
    assert set(params["layouts"]) == {"out_w_padded", "gates", "attn_W",
                                      "out_w"}
    kept = Decoder(cfg, params).params()["layouts"]
    assert kept["out_w_padded"] is p              # kept with the set
    assert "layouts" not in cast_params(params, "float32")
    assert set(params_to_numpy(params)) == set(random_params(cfg, 0))
    f32 = kernel_layouts(cast_params(params, "float32"))   # TF32 tiles
    assert f32["out_w_padded"].dtype == f32["gates"].dtype == torch.float32
    w.add_(1.0)                                   # changed in place
    q = padded_columns(w)
    assert q is not p and torch.equal(q[:, :4188], w)
    aligned = torch.randn(4, 4192).bfloat16()
    assert padded_columns(aligned) is aligned
    assert padded_columns(torch.randn(3, 6)).shape == (3, 8)   # f32: 4 a row
