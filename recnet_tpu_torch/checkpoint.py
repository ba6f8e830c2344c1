"""Read the JAX package's npz checkpoints without JAX.

A step directory holds ``state.npz`` (the TrainState leaves as ``leaf_<i>``
in ``jax.tree_util`` flatten order), ``config.json``, ``vocab.json`` and
``meta.json`` (``recnet_tpu/checkpoint.py``). The flatten order of
``TrainState(step, dec_params, ...)`` puts the step first, then the decoder
params with dict keys sorted:

    leaf_0           step
    leaf_1..4        attention U, W, b, w
    leaf_5           embedding
    leaf_6           out_b
    leaf_7           out_w
    then per layer   b_hh, b_ih, w_hh, w_ih

Only the decoder params are read; the optimizer and reconstructor leaves
that follow are not needed to serve. Writing checkpoints is ROADMAP Queue 1,
item 10.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.data.vocab import Vocab
from recnet_tpu_torch.models.decoder import DecoderConfig, config_from_train

_ATTENTION_KEYS = ("U", "W", "b", "w")          # sorted
_LAYER_KEYS = ("b_hh", "b_ih", "w_hh", "w_ih")  # sorted


def load_config_and_vocab(step_dir: str):
    """(TrainConfig, Vocab) from the step directory's JSON sidecars."""
    with open(os.path.join(step_dir, "config.json")) as f:
        tc = TrainConfig.from_json(f.read())
    with open(os.path.join(step_dir, "vocab.json")) as f:
        vocab = Vocab.from_json(f.read())
    return tc, vocab


def expected_shapes(cfg: DecoderConfig) -> Dict:
    """The decoder param shapes ``cfg`` implies, as a nested dict."""
    H, E, F, A, V = (cfg.hidden_size, cfg.embedding_size, cfg.encoder_size,
                     cfg.attn_size, cfg.vocab_size)
    G = (4 if cfg.cell_type == "LSTM" else 3) * H
    layers = [{"b_hh": (G,), "b_ih": (G,), "w_hh": (H, G),
               "w_ih": (E + F if li == 0 else H, G)}
              for li in range(cfg.n_layers)]
    return {"attention": {"U": (F, A), "W": (H, A), "b": (A,), "w": (A, 1)},
            "embedding": (V, E), "out_b": (V,), "out_w": (H, V),
            "rnn": layers}


def load_decoder_params(step_dir: str, tc, vocab_size: int) -> Dict:
    """The decoder params of an npz checkpoint, as numpy arrays in the JAX
    layout. Raises on an orbax checkpoint and on any shape that disagrees
    with the config."""
    if os.path.isdir(os.path.join(step_dir, "state_orbax")):
        raise ValueError(f"{step_dir} is an orbax checkpoint; the port reads "
                         "npz checkpoints only (save with backend='npz')")
    shapes = expected_shapes(config_from_train(tc, vocab_size))
    with np.load(os.path.join(step_dir, "state.npz")) as data:
        leaves = iter(data[f"leaf_{i}"]
                      for i in range(1, 8 + 4 * len(shapes["rnn"])))
        params = {"attention": {k: next(leaves) for k in _ATTENTION_KEYS}}
        params["embedding"] = next(leaves)
        params["out_b"] = next(leaves)
        params["out_w"] = next(leaves)
        params["rnn"] = [{k: next(leaves) for k in _LAYER_KEYS}
                         for _ in shapes["rnn"]]

    def check(got, want, path):
        if isinstance(want, dict):
            for k in want:
                check(got[k], want[k], f"{path}.{k}")
        elif isinstance(want, list):
            for i, (g, w) in enumerate(zip(got, want)):
                check(g, w, f"{path}[{i}]")
        elif tuple(got.shape) != want:
            raise ValueError(f"checkpoint leaf {path} has shape {got.shape}; "
                             f"the config implies {want}")
    check(params, shapes, "dec_params")
    return params
