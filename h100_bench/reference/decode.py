"""The reference along served tokens: the decoder's logits at every step of
a row, fed <SOS> and then the row's own served tokens (eval mode, no
dropout), and the beam search's score of a served path, as the reference's
eval.py scores it: ``log(sigmoid(logit))`` added to the score so far
divided by len ** 0.7, len the position after the path's last <EOS> or,
before one, the step count; logits clamped at log_sigmoid's saturation
point, -log(f32 tiny)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as nnf

from h100_bench.reference.recnet import SOS, Products, decoder_rollout

SATURATION = float(-np.log(np.finfo(np.float32).tiny))


@torch.no_grad()
def logits_along(P: Dict, c: Dict, enc: torch.Tensor, tokens: torch.Tensor,
                 prod: Products) -> torch.Tensor:
    """(S, T, V) logits of rows with features ``enc`` (S, F, E) that served
    ``tokens`` (S, T): step t reads <SOS> (t = 0) or token t - 1."""
    S = tokens.shape[0]
    inputs = torch.cat([torch.full((S, 1), SOS, dtype=tokens.dtype,
                                   device=tokens.device), tokens[:, :-1]], 1)
    logits, _ = decoder_rollout(P, c, enc, inputs.t(), prod)
    return logits.transpose(0, 1)


def path_score(logits: torch.Tensor, tokens: torch.Tensor,
               eos: int) -> torch.Tensor:
    """(S,) beam score of each row's path ``tokens`` (S, T) under
    ``logits`` (S, T, V), in float64."""
    picked = logits.gather(-1, tokens[..., None].long())[..., 0].double()
    gain = nnf.logsigmoid(picked.clamp(max=SATURATION))
    S, T = tokens.shape
    score = torch.zeros(S, dtype=torch.float64, device=logits.device)
    last = torch.full((S,), -1, dtype=torch.long, device=logits.device)
    for t in range(T):
        length = torch.where(last >= 0, last + 1, t + 1).double()
        score = score / length ** 0.7 + gain[:, t]
        last = torch.where(tokens[:, t] == eos, t, last)
    return score
