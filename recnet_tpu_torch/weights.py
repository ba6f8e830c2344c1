"""The weight bridge between the JAX package's param trees and the port.

Both packages keep one layout (input-major weights, see
``models.decoder``), so the bridge is a copy: numpy arrays in, tensors out,
and back. ``train_state_from_jax`` carries a whole JAX ``TrainState``
(both models' params and Adam states) across. Converting to the
reference's torch ``(out, in)`` layout belongs to the later
``import_torch`` port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from recnet_tpu_torch.models.decoder import DecoderConfig
from recnet_tpu_torch.ops.cuda.layout import kernel_layouts

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(dtype) -> torch.dtype:
    """``"float32"``/``"bfloat16"`` or a torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}; "
                         f"expected one of {sorted(_DTYPES)}")
    return _DTYPES[dtype]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(tree: Dict, device="cpu", dtype=None) -> Dict:
    """JAX decoder params (nested dict/list of arrays) -> nested dict of
    tensors on ``device``. Floating arrays are cast to ``dtype`` when given;
    the values are copied bit for bit otherwise, into contiguous tensors
    whatever the arrays' strides (a transposed view included: the kernels
    take contiguous operands only). bf16 and f32 params on a CUDA card carry
    ``"layouts"``, the weight copies the kernels read
    (``ops.cuda.layout.kernel_layouts``), made here once."""
    params = _map(tree, lambda x: torch.from_numpy(
        np.array(x, copy=True, order="C")))
    if dtype is not None:
        params = cast_params(params, dtype)
    params = _map(params, lambda t: t.to(device))
    layouts = (kernel_layouts(params) if torch.device(device).type == "cuda"
               else None)
    if layouts:
        params["layouts"] = layouts
    return params


def _weights_only(params: Dict) -> Dict:
    """``params`` without the kernels' weight copies."""
    return {k: v for k, v in params.items() if k != "layouts"}


def params_to_numpy(params: Dict) -> Dict:
    """The port's params -> nested dict/list of numpy arrays (JAX layout).
    bf16 tensors come back as float32, since numpy has no bfloat16."""
    def to_numpy(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return _map(_weights_only(params), to_numpy)


def cast_params(params: Dict, dtype) -> Dict:
    """Cast every floating tensor to ``dtype`` (the serving precision); the
    kernels' weight copies of the old dtype are dropped."""
    dt = torch_dtype(dtype)
    return _map(_weights_only(params),
                lambda t: t.to(dt) if t.is_floating_point() else t)


def random_params(cfg: DecoderConfig, seed: int) -> Dict:
    """Seeded decoder params as numpy arrays in the JAX layout, drawn like
    the JAX initialiser (N(0,1) embedding, U(+-1/sqrt(fan_in)) weights,
    ones attention bias). For smoke runs and benchmarks: the numbers differ
    from ``jax.random``'s."""
    rng = np.random.default_rng(seed)
    H, E, F, A, V = (cfg.hidden_size, cfg.embedding_size, cfg.encoder_size,
                     cfg.attn_size, cfg.vocab_size)
    G = (4 if cfg.cell_type == "LSTM" else 3) * H

    def uniform(shape, fan_in):
        bound = 1.0 / fan_in ** 0.5
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    layers = []
    for li in range(cfg.n_layers):
        in_size = E + F if li == 0 else H
        layers.append({"w_ih": uniform((in_size, G), H),
                       "w_hh": uniform((H, G), H),
                       "b_ih": uniform((G,), H), "b_hh": uniform((G,), H)})
    return {
        "embedding": rng.standard_normal((V, E)).astype(np.float32),
        "attention": {"W": uniform((H, A), H), "U": uniform((F, A), F),
                      "b": np.ones((A,), np.float32), "w": uniform((A, 1), A)},
        "rnn": layers,
        "out_w": uniform((H, V), H),
        "out_b": uniform((V,), H),
    }


def _adam_fields(opt_state):
    """(count, mu, nu, nu_max) of the ``TorchAdamState`` inside a JAX
    optax chain state (a tuple with empty states around it)."""
    adam = next(s for s in opt_state if hasattr(s, "nu_max"))
    to_np = lambda tree: (None if tree is None
                          else _map(tree, lambda x: np.asarray(x)))
    return (int(np.asarray(adam.count)), to_np(adam.mu), to_np(adam.nu),
            to_np(adam.nu_max))


def train_state_from_jax(jax_state, tc, device="cuda"):
    """The JAX package's ``TrainState`` (step, dec_params, dec_opt,
    rec_params, rec_opt) as the port's ``training.step.TrainState`` on
    ``device``: params and both Adam states copied bit for bit. Reads the
    JAX state's fields as numpy arrays; needs no JAX import."""
    from recnet_tpu_torch.training.step import make_train_state
    to_np = lambda tree: _map(tree, lambda x: np.asarray(x))
    rec = tc.use_recon
    return make_train_state(
        tc, int(np.asarray(jax_state.step)), to_np(jax_state.dec_params),
        to_np(jax_state.rec_params) if rec else None,
        dec_adam=_adam_fields(jax_state.dec_opt),
        rec_adam=_adam_fields(jax_state.rec_opt) if rec else None,
        device=device)
