"""The reference's optimizer: ``torch.optim.Adam`` with *coupled* L2
weight decay (the decay is added to the gradient before the moments, not
AdamW) and optional AMSGrad (reference: train.py:149-150,186-187), one per
model, and the global-norm clip the reference applies to the decoder only
(train.py:269-270).

The JAX package reproduces this update rule by hand
(``recnet_tpu.training.optim.torch_adam``); the port calls it. Its state
maps to the JAX ``TorchAdamState(count, mu, nu, nu_max)`` as ``step``,
``exp_avg``, ``exp_avg_sq`` and ``max_exp_avg_sq`` (``adam_state`` and
``load_adam_state``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from recnet_tpu_torch.utils.misc import tree_leaves

BETAS = (0.9, 0.999)
EPS = 1e-8


def make_adam(params, learning_rate: float, weight_decay: float = 0.0,
              amsgrad: bool = False) -> torch.optim.Adam:
    """Adam over the leaves of a parameter tree, in the JAX flatten order
    (so its state lines up with the JAX ``TorchAdamState`` leaves), with
    every moment allocated at step 0 as the JAX ``init`` does."""
    opt = torch.optim.Adam(tree_leaves(params), lr=learning_rate,
                           betas=BETAS, eps=EPS, weight_decay=weight_decay,
                           amsgrad=amsgrad)
    zeros = [torch.zeros_like(p) for p in opt.param_groups[0]["params"]]
    load_adam_state(opt, 0, zeros, zeros, zeros if amsgrad else None)
    return opt


def _group_params(opt: torch.optim.Adam) -> List[torch.Tensor]:
    return opt.param_groups[0]["params"]


def adam_state(opt: torch.optim.Adam) -> Tuple[int, List, List,
                                              Optional[List]]:
    """(count, mu, nu, nu_max) of ``opt``, each moment a list of tensors in
    parameter order; nu_max is None without AMSGrad."""
    states = [opt.state[p] for p in _group_params(opt)]
    count = int(states[0]["step"])
    pick = lambda key: [s[key] for s in states]
    return (count, pick("exp_avg"), pick("exp_avg_sq"),
            pick("max_exp_avg_sq") if opt.param_groups[0]["amsgrad"]
            else None)


def load_adam_state(opt: torch.optim.Adam, count: int, mu: Sequence,
                    nu: Sequence, nu_max: Optional[Sequence]) -> None:
    """Set ``opt``'s state from the JAX ``TorchAdamState`` fields, each
    moment a sequence of arrays or tensors in parameter order, through
    ``load_state_dict`` (which moves them to each parameter's device)."""
    amsgrad = opt.param_groups[0]["amsgrad"]
    if amsgrad and nu_max is None:
        raise ValueError("an AMSGrad optimizer needs nu_max")
    # copies: the moments are updated in place, and load_state_dict keeps a
    # tensor that already has the parameter's dtype and device as it is
    copy = lambda x: torch.as_tensor(x).detach().clone()
    state: Dict[int, Dict] = {}
    for i in range(len(_group_params(opt))):
        s = {"step": torch.tensor(float(count), dtype=torch.float32),
             "exp_avg": copy(mu[i]), "exp_avg_sq": copy(nu[i])}
        if amsgrad:
            s["max_exp_avg_sq"] = copy(nu_max[i])
        state[i] = s
    sd = opt.state_dict()
    sd["state"] = state
    opt.load_state_dict(sd)


def clip_by_global_norm(params, max_norm: float, shard=None,
                        specs: Optional[Sequence[tuple]] = None
                        ) -> torch.Tensor:
    """``clip_grad_norm_`` over a parameter tree's gradients; returns the
    norm before clipping. The coefficient max_norm / (norm + 1e-6) is
    clamped to 1, which equals the JAX package's ``where(norm > max_norm,
    ...)`` except for norms within 1e-6 below the limit.

    On a 'model' axis (``shard`` with a model group) the norm is global:
    the squares of the leaves split over the axis (``specs``, from
    ``parallel.mesh.param_specs``) summed over its group, the others
    counted once."""
    leaves = tree_leaves(params)
    if shard is None or shard.model_group is None:
        return torch.nn.utils.clip_grad_norm_(leaves, max_norm)
    squares = [p.grad.float().square().sum() for p in leaves]
    whole = torch.stack([q for q, s in zip(squares, specs)
                         if "model" not in s]).sum()
    split = torch.stack([q for q, s in zip(squares, specs)
                         if "model" in s]).sum()
    tdist.all_reduce(split, group=shard.model_group)
    norm = (whole + split).sqrt()
    coef = (max_norm / (norm + 1e-6)).clamp(max=1.0)
    for p in leaves:
        p.grad.mul_(coef.to(p.grad.dtype))
    return norm
