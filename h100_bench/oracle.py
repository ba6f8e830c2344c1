"""The numbers that decide ``correct``, and the judgement against the
cell's limits (``limits/<workload>.json``).

Training: each of the first steps' loss, the norm of step 1's gradient as
Adam took it (read back from the program's first moment, exp_avg / (1 -
beta1)), and the norm of the parameters' change over the first steps,
each leaf against the reference's. A leaf's gap is the gap between the two
norms, over the reference's norm of that leaf or of the median leaf of its
model, whichever is larger; the number is the worst leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone and stay out of the change.

Captioning: along the served tokens of a sample of rows, the reference's
logits. Greedy: the widest gap by which a served token's logit lies below
the reference's best at its step. Beam: the widest gap by which a served
word lies below the reference's k-th best (a beam keeps its parent's top
k), and the top beam's score against the reference's score of the same
path, relative.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

MOVED = 1e-3     # under this share of the median leaf's gradient: unmoved


def _group(key: str) -> str:
    return key.split("/", 1)[0]


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             keys: Iterable[str]) -> float:
    """The worst leaf's |prog - ref| / max(ref, the group's median ref)."""
    keys = list(keys)
    med = {grp: median(ref[k] for k in keys if _group(k) == grp)
           for grp in {_group(k) for k in keys}}
    worst = 0.0
    for k in keys:
        if k not in prog or not math.isfinite(prog[k]):
            return math.inf
        scale = max(ref[k], med[_group(k)])
        worst = max(worst, abs(prog[k] - ref[k]) / scale if scale else
                    (0.0 if prog[k] == ref[k] else math.inf))
    return worst


def moved_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least MOVED of their
    model's median leaf's."""
    med = {grp: median(v for k, v in ref_grad.items() if _group(k) == grp)
           for grp in {_group(k) for k in ref_grad}}
    return [k for k, v in ref_grad.items() if v >= MOVED * med[_group(k)]]


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """{"loss_gap", "grad_gap", "change_gap"} of the program's (or a
    stand-in's) first steps against the reference's."""
    if len(prog["loss"]) != len(ref["loss"]):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                       for p, r in zip(prog["loss"], ref["loss"]))
    return {"loss_gap": loss_gap,
            "grad_gap": norm_gap(prog["grad"], ref["grad"], ref["grad"]),
            "change_gap": norm_gap(prog["change"], ref["change"],
                                   moved_leaves(ref["grad"]))}


def served_lengths(tokens: np.ndarray, eos: int) -> np.ndarray:
    """A served caption's length: up to and with its first <EOS>, or the
    whole row."""
    hit = tokens == eos
    return np.where(hit.any(1), hit.argmax(1) + 1, tokens.shape[1])


def _positions(lengths, T: int, device) -> torch.Tensor:
    return (torch.arange(T, device=device)[None, :]
            < torch.as_tensor(lengths, device=device)[:, None])


def greedy_gap(ref: torch.Tensor, picked: torch.Tensor, lengths) -> float:
    """Widest gap between the reference's best logit and its logit of the
    ``picked`` token (S, T), over each row's first ``lengths`` steps."""
    best = ref.amax(-1)
    got = ref.gather(-1, picked[..., None].long())[..., 0]
    gap = (best - got)[_positions(lengths, ref.shape[1], ref.device)]
    return float(gap.max()) if gap.numel() else math.inf


def topk_gap(ref: torch.Tensor, picked: torch.Tensor, k: int) -> float:
    """Widest amount by which the reference's logit of a ``picked`` token
    (S, T) lies below its k-th best, 0 where it is within the top k."""
    kth = ref.topk(k, -1).values[..., -1]
    got = ref.gather(-1, picked[..., None].long())[..., 0]
    return max(0.0, float((kth - got).max()))


def control_topk_gap(ref: torch.Tensor, ctl: torch.Tensor, k: int) -> float:
    """``topk_gap`` of the control's own top k: the widest amount by which
    the reference's logit of a word the control keeps lies below the
    reference's k-th best."""
    kth = ref.topk(k, -1).values[..., -1]
    kept = ref.gather(-1, ctl.topk(k, -1).indices).amin(-1)
    return max(0.0, float((kth - kept).max()))


def score_gap(served: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest relative gap between served and reference path scores."""
    served, ref = served.double(), ref.double()
    if not bool(torch.isfinite(served).all()):
        return math.inf
    return float(((served - ref).abs() / ref.abs().clamp(min=1e-30)).max())


def judge(numbers: Dict[str, float], limits: Dict[str, Dict]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(correct, [(name, number, limit)]): correct when every limited
    number is finite and at most its limit."""
    rows = []
    for name in sorted(limits):
        value = numbers.get(name, math.inf)
        rows.append((name, value, float(limits[name]["limit"])))
    ok = bool(rows) and all(math.isfinite(v) and v <= lim
                            for _, v, lim in rows)
    return ok, rows
