"""RecNet's additive attention, deliberately *unnormalised* (no softmax).

Port of ``recnet_tpu.ops.attention``. Scores ``w . tanh(W h + U v + b)``
multiply the values and are mean-pooled over time. ``U v`` does not depend
on the query, so it is computed once per sequence (``precompute_uv``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def precompute_uv(params: Params, values: torch.Tensor) -> torch.Tensor:
    """(B, T, F) -> (B, T, A). Hoisted out of the decode loop."""
    return values @ params["U"]


def attention_scores(params: Params, query: torch.Tensor,
                     uv: torch.Tensor) -> torch.Tensor:
    """query (B, H), uv (B, T, A) -> unnormalised scores (B, T)."""
    wh = query @ params["W"]                               # (B, A)
    act = torch.tanh(wh[:, None, :] + uv + params["b"])
    return (act @ params["w"]).squeeze(-1)


def attend_mean(params: Params, query: torch.Tensor, values: torch.Tensor,
                uv: torch.Tensor, mask: Optional[torch.Tensor] = None,
                denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """context = (1/T) sum_t score_t v_t; ``mask`` zeroes padded steps and
    ``denom`` replaces T (the local reconstructor's T_eff)."""
    scores = attention_scores(params, query, uv)
    if mask is not None:
        scores = scores * mask
    weighted = torch.einsum("bt,btv->bv", scores, values)
    return weighted / (values.shape[1] if denom is None else denom)
