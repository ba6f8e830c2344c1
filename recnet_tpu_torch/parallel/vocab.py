"""The vocabulary-parallel pieces of the decoder: what GSPMD inserts on its
own around the JAX package's 'model'-sharded embedding and projection,
written out as collectives over the step's 'model' group.

Each function takes the step's ``parallel.mesh.Shard`` (or None) and
computes on one device what the unsharded code computes when the shard has
no 'model' group:

* ``embed``: each rank looks up the tokens inside its rows of the table,
  zeroes the others, and the ranks sum (every token lies in one shard, so
  the sum is exact); the backward passes the gradient through, since every
  model rank computes the same downstream gradient. Without a 'model'
  group, a CUDA float32 table that requires grad, with grad mode on, takes
  the gather whose backward is the hand-written kernel
  (``ops.cuda.embedding``); everything else the plain ``table[tokens]``;
* ``project``: the hidden state enters the projection by an identity whose
  backward sums over the group (each rank's logit columns give part of
  dL/dh); the rank's logits are its columns;
* ``token_nll``: -log softmax at the targets over columns split across the
  ranks: the global max by an all-reduce MAX outside autograd, the sum of
  exps and the target logit by all-reduce SUMs;
* ``argmax``: the first index of the global maximum (ties to the lower
  column, as ``torch.argmax`` on the whole row).
"""

from __future__ import annotations

import torch
import torch.distributed as tdist
from torch.autograd.function import once_differentiable

from recnet_tpu_torch.ops.cuda import embedding, gemm


def _tp(shard) -> bool:
    return shard is not None and shard.model_group is not None


class _SumOverModel(torch.autograd.Function):
    """All-reduce SUM forward; identity backward (every model rank holds
    the same gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        tdist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _EnterModel(torch.autograd.Function):
    """Identity forward; all-reduce SUM backward (each model rank's part of
    the gradient summed, in float32)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.float()
        tdist.all_reduce(g, group=ctx.group)
        return g.to(grad.dtype), None


class _Gather(torch.autograd.Function):
    """``table[tokens]``; its backward sums the cotangent's rows by token
    in ``embedding.embedding_backward`` (ATen's ``index_put_`` walks a run
    of equal tokens on one warp, row after row)."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.n_rows = table.shape[0]
        return table[tokens]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        tokens, = ctx.saved_tensors
        flat = tokens.reshape(-1).contiguous()
        d_rows = grad.reshape(-1, grad.shape[-1]).contiguous()
        return embedding.embedding_backward(flat, d_rows, ctx.n_rows), None


def _kernel_gather(table: torch.Tensor, tokens: torch.Tensor) -> bool:
    """Whether ``embed`` takes ``_Gather``: what the kernel takes, with a
    gradient to compute."""
    return (table.is_cuda and table.dtype == torch.float32
            and table.dim() == 2 and table.requires_grad
            and torch.is_grad_enabled()
            and tokens.dtype in (torch.int32, torch.int64))


def sum_over_model(x: torch.Tensor, shard) -> torch.Tensor:
    """``x`` summed over the 'model' group, differentiable (each rank's
    part of a sum every rank then uses alike); ``x`` without one."""
    return _SumOverModel.apply(x, shard.model_group) if _tp(shard) else x


def embed(table: torch.Tensor, tokens: torch.Tensor,
          shard=None) -> torch.Tensor:
    """``table[tokens]`` for a table split by rows over 'model'."""
    if not _tp(shard):
        if _kernel_gather(table, tokens):
            return _Gather.apply(table, tokens)
        return table[tokens]
    start, stop, _ = shard.cols
    local = tokens.long() - start
    inside = (local >= 0) & (local < stop - start)
    rows = table[local.clamp(0, stop - start - 1)]
    rows = rows * inside[..., None].to(rows.dtype)
    return _SumOverModel.apply(rows, shard.model_group)


def project(h: torch.Tensor, out_w: torch.Tensor, out_b: torch.Tensor,
            shard=None) -> torch.Tensor:
    """``h @ out_w + out_b``: the rank's logit columns under 'model'.
    Without a 'model' group the product runs on ``gemm.matmul``'s route."""
    if _tp(shard):
        h = _EnterModel.apply(h, shard.model_group)
        return h @ out_w + out_b
    return gemm.matmul(h, out_w, out_b)


def token_nll(logits: torch.Tensor, targets: torch.Tensor,
              shard=None) -> torch.Tensor:
    """-log softmax(logits)[target] per position, float32; logits
    (..., V or the rank's columns), targets (...) int."""
    logits = logits.float()
    targets = targets.long()
    if not _tp(shard):
        logz = torch.logsumexp(logits, dim=-1)
        return logz - logits.gather(-1, targets[..., None])[..., 0]
    group = shard.model_group
    with torch.no_grad():
        top = logits.amax(dim=-1)
        tdist.all_reduce(top, op=tdist.ReduceOp.MAX, group=group)
    shifted = logits - top[..., None]
    sumexp = _SumOverModel.apply(shifted.exp().sum(dim=-1), group)
    start, stop, _ = shard.cols
    local = targets - start
    inside = (local >= 0) & (local < stop - start)
    picked = shifted.gather(-1, local.clamp(0, stop - start - 1)[..., None])
    target = _SumOverModel.apply(picked[..., 0] * inside.to(picked.dtype),
                                 group)
    return torch.log(sumexp) - target


def argmax(logits: torch.Tensor, shard=None) -> torch.Tensor:
    """The argmax over the last axis, int32, over columns split across the
    'model' group: the global maximum by an all-reduce MAX, then the lowest
    global column that holds it by an all-reduce MIN."""
    if not _tp(shard):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    group = shard.model_group
    with torch.no_grad():
        best, idx = logits.max(dim=-1)      # first maximum of the columns
        top = best.float().clone()
        tdist.all_reduce(top, op=tdist.ReduceOp.MAX, group=group)
        col = torch.where(best.float() == top, idx + shard.cols[0],
                          torch.full_like(idx, shard.cols[2]))
        tdist.all_reduce(col, op=tdist.ReduceOp.MIN, group=group)
    return col.to(torch.int32)

