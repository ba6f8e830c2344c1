"""Loss functions with the reference's normalisation quirks.

Port of ``recnet_tpu.ops.losses``. The decoder loss sums each step's
masked-mean cross entropy over the steps and divides by the total token
count (reference: train.py:54-68). Regularisation is ``lambda * sum_p
||p||_2``, a sum of norms, not of squared norms (train.py:69-70,103-104).
Every loss reduces in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from recnet_tpu_torch.parallel import vocab as vocab_par
from recnet_tpu_torch.parallel.mesh import data_sum
from recnet_tpu_torch.utils.misc import tree_leaves


def step_mean_ce(logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor, shard=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, B, V), targets (T, B) int, mask (T, B) bool/float.

    Returns (loss, n_tokens) with
    loss = sum_t mean_{b: mask}(CE_tb) / sum_tb mask. A step whose mask is
    all zero adds 0, which matches the reference's early loop break.

    On a mesh (``shard``, ``parallel.mesh.Shard``) the per-step counts and
    ``n_tokens`` are the whole batch's (summed over 'data'), so that the
    loss is this rank's share of the global loss and the shares, and their
    gradients, sum to the single-device ones; the logits may be the rank's
    vocabulary columns (``parallel.vocab.token_nll``)."""
    mask = mask.to(torch.float32)
    per_step_sum = (vocab_par.token_nll(logits, targets, shard)
                    * mask).sum(dim=1)                           # (T,)
    per_step_cnt = data_sum(mask.sum(dim=1), shard)
    per_step_mean = per_step_sum / per_step_cnt.clamp(min=1.0)
    n_tokens = per_step_cnt.sum()
    return per_step_mean.sum() / n_tokens.clamp(min=1.0), n_tokens


def l2_norm_sum(params, shard=None,
                specs: Optional[Sequence[tuple]] = None) -> torch.Tensor:
    """sum_p ||p||_2 over every leaf of a parameter tree (train.py:69).
    On a 'model' axis a leaf split over it (``specs``, from
    ``parallel.mesh.param_specs``) has the norm of its whole: the square
    root of its squares summed over the group; the others are counted once
    on every rank."""
    leaves = tree_leaves(params)
    specs = specs or [()] * len(leaves)
    total = 0
    for p, spec in zip(leaves, specs):
        sq = p.float().square().sum()
        if "model" in spec:
            sq = vocab_par.sum_over_model(sq, shard)
        total = total + sq.sqrt()
    return total


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise-mean MSE, as torch.nn.MSELoss() (train.py:185)."""
    return (pred.float() - target.float()).square().mean()
