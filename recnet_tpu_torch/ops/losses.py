"""Loss functions with the reference's normalisation quirks.

Port of ``recnet_tpu.ops.losses``. The decoder loss sums each step's
masked-mean cross entropy over the steps and divides by the total token
count (reference: train.py:54-68). Regularisation is ``lambda * sum_p
||p||_2``, a sum of norms, not of squared norms (train.py:69-70,103-104).
Every loss reduces in float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from recnet_tpu_torch.utils.misc import tree_leaves


def step_mean_ce(logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, B, V), targets (T, B) int, mask (T, B) bool/float.

    Returns (loss, n_tokens) with
    loss = sum_t mean_{b: mask}(CE_tb) / sum_tb mask. A step whose mask is
    all zero adds 0, which matches the reference's early loop break."""
    logits = logits.float()
    mask = mask.to(logits.dtype)
    logz = torch.logsumexp(logits, dim=-1)                       # (T, B)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    per_step_sum = ((logz - tgt) * mask).sum(dim=1)              # (T,)
    per_step_cnt = mask.sum(dim=1)
    per_step_mean = per_step_sum / per_step_cnt.clamp(min=1.0)
    n_tokens = per_step_cnt.sum()
    return per_step_mean.sum() / n_tokens.clamp(min=1.0), n_tokens


def l2_norm_sum(params) -> torch.Tensor:
    """sum_p ||p||_2 over every leaf of a parameter tree (train.py:69)."""
    return sum(p.float().square().sum().sqrt() for p in tree_leaves(params))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise-mean MSE, as torch.nn.MSELoss() (train.py:185)."""
    return (pred.float() - target.float()).square().mean()
