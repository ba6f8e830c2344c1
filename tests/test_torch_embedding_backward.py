"""The embedding gather's backward on the CPU: the plain twin of
``ops/cuda/embedding.py`` (the kernel's order: stable sort, tiles of R
positions, runs summed in position order, pieces in tile order) against
``jax.vjp`` of a plain ``jnp`` gather ``table[tokens]``: the expression the
JAX decoder writes inline (``params["embedding"][inputs]``,
``recnet_tpu/models/decoder.py:200``), which no function of the JAX package
holds on its own; the order itself bit for bit, the
wrapper's refusals and its counter, and the route of
``parallel.vocab.embed``: the plain gather on the CPU, under ``no_grad``
and on the vocabulary-sharded branch.

Token patterns: the train traffic's (70% one token, then <SOS>, <EOS> and
words uniform over the rest), one token everywhere, the first and last rows
only, and a vocabulary most of whose rows no token reads. f32 tolerance
rtol 1e-5, atol 1e-5: JAX sums each row's cotangents in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recnet_tpu_torch.ops.cuda import embedding
from recnet_tpu_torch.parallel import mesh as t_mesh
from recnet_tpu_torch.parallel import vocab as vocab_par
from torch_embedding_cases import tokens as _tokens

RTOL, ATOL = 1e-5, 1e-5


def _jax_grad(tok, d_rows, v):
    table = jnp.zeros((v, d_rows.shape[1]), jnp.float32)
    _, vjp = jax.vjp(lambda t: t[jnp.asarray(tok.numpy())], table)
    return np.asarray(vjp(jnp.asarray(d_rows.numpy()))[0])


CASES = ([("traffic", r, e, torch.int64 if r != 4 else torch.int32)
          for r in (1, 4, 64) for e in (5, 468)]
         + [("same", r, 5, torch.int64) for r in (1, 4, 64)]
         + [("ends", r, 468, torch.int32) for r in (4, 64)]
         + [("sparse", 4, 5, torch.int64), ("negative", 4, 5, torch.int64)])


@pytest.mark.parametrize("pattern,tile_rows,e,dtype", CASES)
def test_reference_matches_jax_vjp(pattern, tile_rows, e, dtype):
    """N = 203 (a multiple of no R but 1), V = 41; f32 against jax.vjp
    and against float64 ``index_put_`` with accumulate."""
    n, v = 203, 41
    tok = _tokens(pattern, n, v, seed=tile_rows + e)
    tok = tok.to(dtype)
    d_rows = torch.from_numpy(np.random.default_rng(e).standard_normal(
        (n, e)).astype(np.float32))
    got = embedding.embedding_backward_reference(tok, d_rows, v,
                                                 tile_rows=tile_rows)
    assert got.dtype == torch.float32 and got.shape == (v, e)
    np.testing.assert_allclose(got.numpy(), _jax_grad(tok, d_rows, v),
                               rtol=RTOL, atol=ATOL)
    f64 = torch.zeros((v, e), dtype=torch.float64).index_put_(
        (tok.long() % v,), d_rows.double(), accumulate=True)
    np.testing.assert_allclose(got.numpy(), f64.numpy(), rtol=RTOL,
                               atol=ATOL)
    untouched = np.setdiff1d(np.arange(v), tok.long().numpy() % v)
    assert not got[untouched].any()


def test_reference_sums_in_the_kernels_order():
    """One token at 10 positions, R 4: pieces of 4, 4 and 2 positions,
    each summed from zero in position order, then added in tile order; a
    second token's run inside a tile stands alone. Bit for bit against
    numpy float32 in that order, and different from a plain sum's bits on
    these values."""
    x = np.float32([1.0, 1.0, 1.0, 1e8, 2.0, 2.0, 2.0, 2.0, 0.75, 0.75,
                    2.0, 4.0])[:, None]
    tok = torch.tensor([5] * 10 + [7, 7])
    got = embedding.embedding_backward_reference(
        tok, torch.from_numpy(x), 8, tile_rows=4)

    def fold(vals):
        acc = np.float32(0)
        for val in vals:
            acc = np.float32(acc + val)
        return acc

    pieces = [fold(x[0:4, 0]), fold(x[4:8, 0]), fold(x[8:10, 0])]
    want = np.float32(np.float32(pieces[0] + pieces[1]) + pieces[2])
    assert got[5, 0].numpy().tobytes() == want.tobytes()
    assert got[7, 0] == fold(x[10:12, 0])
    assert fold(x[0:10, 0]) != want     # the order shows in these bits
    assert not got[[0, 1, 2, 3, 4, 6]].any()


def test_reference_counts_nothing_and_the_wrapper_runs_it_on_the_cpu():
    tok = _tokens("traffic", 50, 9, seed=1)
    d_rows = torch.randn(50, 6, generator=torch.Generator().manual_seed(0))
    before = embedding.embedding_backward.n_launches
    got = embedding.embedding_backward(tok, d_rows, 9)
    want = embedding.embedding_backward_reference(tok, d_rows, 9)
    assert torch.equal(got, want)
    assert embedding.embedding_backward.n_launches == before
    empty = embedding.embedding_backward(tok[:0], d_rows[:0], 9)
    assert empty.shape == (9, 6) and not empty.any()


@pytest.mark.parametrize("bad", [
    "tokens_2d", "float_tokens", "count", "empty_rows", "tile_zero",
    "tile_large", "devices", "meta"])
def test_wrapper_refuses_what_it_does_not_take(bad):
    tok = torch.zeros(6, dtype=torch.int64)
    d_rows = torch.zeros(6, 4)
    V, R = 5, embedding.TILE_ROWS
    if bad == "tokens_2d":
        tok = tok.view(2, 3)
    elif bad == "float_tokens":
        tok = tok.float()
    elif bad == "count":
        d_rows = d_rows[:5]
    elif bad == "empty_rows":
        V = 0
    elif bad == "tile_zero":
        R = 0
    elif bad == "tile_large":
        R = embedding.MAX_TILE_ROWS + 1
    elif bad == "devices":
        d_rows = d_rows.to("meta")
    elif bad == "meta":
        tok, d_rows = tok.to("meta"), d_rows.to("meta")
    with pytest.raises(ValueError):
        embedding.embedding_backward(tok, d_rows, V, tile_rows=R)


def test_reference_refuses_a_token_outside_the_table():
    with pytest.raises(IndexError):
        embedding.embedding_backward_reference(torch.tensor([0, 5]),
                                               torch.zeros(2, 3), 5)
    with pytest.raises(IndexError):
        embedding.embedding_backward_reference(torch.tensor([-6, 1]),
                                               torch.zeros(2, 3), 5)


def _table_and_tokens(seed=0):
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(17, 6, generator=g).requires_grad_(True)
    tok = _tokens("traffic", 45, 17, seed).view(9, 5)
    return table, tok


def _spy(monkeypatch):
    calls = []
    apply = vocab_par._Gather.apply

    def spy(*args):
        calls.append(args)
        return apply(*args)

    monkeypatch.setattr(vocab_par._Gather, "apply", spy)
    return calls


def test_embed_keeps_the_plain_gather_on_the_cpu(monkeypatch):
    calls = _spy(monkeypatch)
    table, tok = _table_and_tokens()
    rows = vocab_par.embed(table, tok)
    rows.sum().backward()
    assert not calls
    assert torch.equal(rows, table.detach()[tok])


def test_embed_keeps_the_plain_gather_under_no_grad(monkeypatch):
    calls = _spy(monkeypatch)
    table, tok = _table_and_tokens()
    with torch.no_grad():
        rows = vocab_par.embed(table, tok)
    assert not calls and not rows.requires_grad
    assert not vocab_par._kernel_gather(table.detach(), tok)


def test_embed_keeps_the_sharded_branch(monkeypatch):
    """A 'model' group: the rank's rows of the table, never ``_Gather``,
    even where the kernel's route would hold (forced here)."""
    calls = _spy(monkeypatch)
    monkeypatch.setattr(vocab_par, "_kernel_gather", lambda *a: True)
    monkeypatch.setattr(vocab_par._SumOverModel, "apply",
                        lambda x, group: x)
    table, tok = _table_and_tokens()
    shard = t_mesh.Shard(rows=(0, 5, 5), cols=(0, 17, 17),
                         model_group=object())
    rows = vocab_par.embed(table, tok, shard)
    rows.sum().backward()
    assert not calls
    assert torch.equal(rows, table.detach()[tok])


def test_gather_function_backward_equals_the_plain_gathers(monkeypatch):
    """The route forced on CPU tensors: ``_Gather`` runs, its backward the
    twin, and the table's gradient is the plain gather's."""
    calls = _spy(monkeypatch)
    monkeypatch.setattr(vocab_par, "_kernel_gather", lambda *a: True)
    table, tok = _table_and_tokens(3)
    d = torch.randn(9, 5, 6, generator=torch.Generator().manual_seed(4))
    rows = vocab_par.embed(table, tok)
    assert len(calls) == 1
    (rows * d).sum().backward()
    got = table.grad.clone()
    table.grad = None
    (table[tok] * d).sum().backward()
    np.testing.assert_allclose(got.numpy(), table.grad.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(rows, table.detach()[tok])
