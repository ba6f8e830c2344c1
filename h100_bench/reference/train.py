"""The reference's first train steps: the joint loss, autograd, the clip of
the decoder's gradients and one Adam per model, as the reference's
train.py runs them (``torch.optim.Adam`` with coupled L2 decay, AMSGrad
where the configuration says so, ``clip_grad_norm_`` on the decoder).

Adam is written out with ``torch.optim.Adam``'s defaults (betas 0.9 and
0.999, eps 1e-8, which the reference's train.py keeps). The dropout draws
of step s come from a device generator seeded as the program's loop seeds
it from the run's training seed and the step: a host generator seeded by
``seed * 2**32 + s`` draws the teacher-forcing Bernoulli, then the
generator's seed.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from h100_bench.reference.recnet import Products, joint_loss
from h100_bench.seeded import flatten, nest

BETAS = (0.9, 0.999)
EPS = 1e-8


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of step ``step`` under training seed
    ``seed``."""
    host = torch.Generator().manual_seed(seed * 2 ** 32 + step)
    torch.rand((), generator=host)                 # teacher forcing's draw
    g = torch.Generator(device=device)
    g.manual_seed(int(torch.randint(2 ** 62, (), generator=host)))
    return g


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{path: 2-norm} in float64."""
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def first_steps(c: Dict, dec0: Dict, rec0: Dict,
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                seed: int, prod: Products, half: bool = False) -> Dict:
    """Run ``len(batches)`` train steps from parameters ``dec0``, ``rec0``
    (trees, left untouched) on batches of (features (B, F, E) float32,
    captions (T, B)). Returns {"loss": [each step's loss], "grad": {leaf:
    the norm of step 1's gradient as Adam takes it, decay added}, "change":
    {leaf: the norm of the parameters' change over the steps}}; leaves are
    "dec/<path>" and "rec/<path>". ``half`` is a fault: each step takes the
    first half of its batch and the mean over it."""
    start = {**{f"dec/{k}": v for k, v in flatten(dec0).items()},
             **{f"rec/{k}": v for k, v in flatten(rec0).items()}}
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in start.items()}
    model = {k: k.split("/", 1)[0] for k in params}
    hyper = {"dec": (c["decoder_learning_rate"], c["decoder_weight_decay"],
                     c["decoder_use_amsgrad"]),
             "rec": (c["reconstructor_learning_rate"],
                     c["reconstructor_weight_decay"],
                     c["reconstructor_use_amsgrad"])}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    vmax = {k: torch.zeros_like(v) for k, v in params.items()}
    losses: List[float] = []
    first: Dict[str, torch.Tensor] = {}
    for s, (enc, caps) in enumerate(batches):
        if half:
            enc, caps = enc[: enc.shape[0] // 2], caps[:, : caps.shape[1] // 2]
        P = nest({k[4:]: p for k, p in params.items() if model[k] == "dec"})
        R = nest({k[4:]: p for k, p in params.items() if model[k] == "rec"})
        loss = joint_loss(P, R, c, enc, caps, prod,
                          step_generator(seed, s, enc.device))
        keys = list(params)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [params[k] for k in keys])))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if c["use_gradient_clip"]:
                dec = [grads[k] for k in keys if model[k] == "dec"]
                total = torch.stack([x.norm() for x in dec]).norm()
                coef = (c["gradient_clip"] / (total + 1e-6)).clamp(max=1.0)
                for k in keys:
                    if model[k] == "dec":
                        grads[k] = grads[k] * coef
            t = s + 1
            for k in keys:
                lr, wd, amsgrad = hyper[model[k]]
                p, gk = params[k], grads[k] + wd * params[k]
                if s == 0:
                    first[k] = gk
                m[k].lerp_(gk, 1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(gk, gk, value=1 - BETAS[1])
                second = v2[k]
                if amsgrad:
                    torch.maximum(vmax[k], v2[k], out=vmax[k])
                    second = vmax[k]
                denom = second.sqrt() / (1 - BETAS[1] ** t) ** 0.5 + EPS
                p.addcdiv_(m[k], denom, value=-lr / (1 - BETAS[0] ** t))
    return {"loss": losses, "grad": norms(first),
            "change": norms({k: params[k] - start[k] for k in params})}
