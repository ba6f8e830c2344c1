"""RecNet's additive attention, deliberately *unnormalised* (no softmax).

Port of ``recnet_tpu.ops.attention``. Scores ``w . tanh(W h + U v + b)``
multiply the values and are mean-pooled over time. ``U v`` does not depend
on the query, so it is computed once per sequence (``precompute_uv``).
``init_attention_params`` draws nn.Linear's default init for W, U and w and
ones for the bias b (reference: models/decoder.py:25-29).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from recnet_tpu_torch.ops.cuda import gemm

Params = Dict[str, torch.Tensor]


def init_attention_params(generator: torch.Generator, query_size: int,
                          value_size: int, attn_size: int,
                          dtype=torch.float32) -> Params:
    """W (query, A), U (value, A), w (A, 1) ~ U(-1/sqrt(fan_in), ...),
    b = ones (A,); drawn from ``generator`` on its device."""
    dev = generator.device

    def linear(fan_in, fan_out):
        bound = 1.0 / fan_in ** 0.5
        return torch.empty((fan_in, fan_out), dtype=dtype, device=dev
                           ).uniform_(-bound, bound, generator=generator)
    return {"W": linear(query_size, attn_size),
            "U": linear(value_size, attn_size),
            "b": torch.ones((attn_size,), dtype=dtype, device=dev),
            "w": linear(attn_size, 1)}


def precompute_uv(params: Params, values: torch.Tensor) -> torch.Tensor:
    """(B, T, F) -> (B, T, A). Hoisted out of the decode loop. In the
    train step the product runs on ``gemm.matmul``'s route."""
    return gemm.matmul(values, params["U"])


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
