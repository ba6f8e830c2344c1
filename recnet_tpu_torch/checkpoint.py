"""The JAX package's npz checkpoints, read and written without JAX.

A step directory holds ``state.npz`` (the TrainState leaves as ``leaf_<i>``
in ``jax.tree_util`` flatten order), ``config.json``, ``vocab.json`` and
``meta.json`` (``recnet_tpu/checkpoint.py``). The flatten order of
``TrainState(step, dec_params, dec_opt, rec_params, rec_opt)`` puts the
step first, then the decoder params with dict keys sorted:

    leaf_0           step
    leaf_1..4        attention U, W, b, w
    leaf_5           embedding
    leaf_6           out_b
    leaf_7           out_w
    then per layer   b_hh, b_ih, w_hh, w_ih

then the decoder's Adam state, ``TorchAdamState(count, mu, nu, nu_max)``
inside the optax chain (count, then mu, nu and, with AMSGrad, nu_max, each
laid out like the params), then the reconstructor's params (attention for
the local variant, out_b, out_w, rnn) and its Adam state.

``meta.json``'s ``structure`` is a hash of the string JAX prints for the
TrainState's tree structure, and the JAX package refuses a checkpoint whose
hash differs. ``structure_string`` writes that string for the port's
configs without JAX. ``load_decoder_params`` reads the decoder for serving
and evaluation; ``save_checkpoint`` / ``load_checkpoint`` write and read
the whole training state (``--resume``). Orbax checkpoints are JAX-only.

On a mesh (``parallel.mesh``) the file keeps this layout: a save gathers
the vocabulary shards over 'model' (every rank takes part) and the primary
alone writes; a load reads the whole leaves on every rank and keeps the
rank's shards. A single-process run and the JAX package load such a
checkpoint as any other.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.data.vocab import Vocab
from recnet_tpu_torch.models.decoder import DecoderConfig, config_from_train
from recnet_tpu_torch.models.reconstructors import ReconstructorConfig
from recnet_tpu_torch.models.reconstructors import \
    config_from_train as rec_config_from_train
from recnet_tpu_torch.parallel import distributed as dist
from recnet_tpu_torch.parallel import mesh as mesh_lib
from recnet_tpu_torch.training.optim import adam_state
from recnet_tpu_torch.training.step import TrainState, make_train_state
from recnet_tpu_torch.utils.misc import tree_fill, tree_leaves

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


def expected_rec_shapes(cfg: ReconstructorConfig) -> Dict:
    """The reconstructor param shapes ``cfg`` implies, as a nested dict."""
    H, Hd, A = cfg.hidden_size, cfg.decoder_hidden_size, cfg.attn_size
    G = (4 if cfg.cell_type == "LSTM" else 3) * H
    in0 = Hd * (2 if cfg.kind == "global" else 1)
    shapes = {"out_b": (H,), "out_w": (H, H),
              "rnn": [{"b_hh": (G,), "b_ih": (G,), "w_hh": (H, G),
                       "w_ih": (in0 if li == 0 else H, G)}
                      for li in range(cfg.n_layers)]}
    if cfg.kind == "local":
        shapes["attention"] = {"U": (Hd, A), "W": (H, A), "b": (A,),
                               "w": (A, 1)}
    return shapes


def _structure(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def _adam_structure(params, amsgrad: bool, weight_decay: float) -> str:
    p = _structure(params)
    adam = (f"CustomNode(namedtuple[TorchAdamState], [*, {p}, {p}, "
            f"{p if amsgrad else 'None'}])")
    empty = "CustomNode(namedtuple[EmptyState], [])"
    # the optax chain of recnet_tpu.training.optim.torch_adam
    return "(" + ", ".join([empty, adam, empty] if weight_decay
                           else [adam, empty]) + ")"


def structure_string(tc, vocab_size: int) -> str:
    """The ``str(jax.tree_util.tree_structure(state))`` of the JAX
    TrainState ``tc`` implies."""
    dec = expected_shapes(config_from_train(tc, vocab_size))
    parts = ["*", _structure(dec),
             _adam_structure(dec, tc.decoder_use_amsgrad,
                             tc.decoder_weight_decay)]
    if tc.use_recon:
        rec = expected_rec_shapes(rec_config_from_train(tc))
        parts += [_structure(rec),
                  _adam_structure(rec, tc.reconstructor_use_amsgrad,
                                  tc.reconstructor_weight_decay)]
    else:
        parts += ["None", "None"]
    return ("PyTreeDef(CustomNode(namedtuple[TrainState], ["
            + ", ".join(parts) + "]))")


def fingerprint(tc, vocab_size: int) -> str:
    """meta.json's ``structure``, as ``recnet_tpu.checkpoint._fingerprint``
    computes it."""
    return hashlib.sha256(
        structure_string(tc, vocab_size).encode()).hexdigest()[:16]


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def state_leaves(state: TrainState, mesh=None,
                 vocab_size: Optional[int] = None) -> list:
    """The TrainState as numpy leaves in the JAX flatten order. On a
    'model' axis the vocabulary shards are gathered first (a collective:
    every rank of the group calls it), which needs ``vocab_size``."""
    items = [state.step]
    models = [(state.dec_params, state.dec_opt)]
    if state.rec_params is not None:
        models.append((state.rec_params, state.rec_opt))
    for params, opt in models:
        items += tree_leaves(params)
        count, mu, nu, nu_max = adam_state(opt)
        items.append(count)
        for moment in (mu, nu) + ((nu_max,) if nu_max is not None else ()):
            items += list(moment)
    if mesh_lib.use_tp(mesh):
        specs = [spec for _, spec in mesh_lib.state_shardings(state, mesh)]
        items = mesh_lib.gather_leaves(items, specs, mesh, vocab_size)
    return [_numpy(x) if torch.is_tensor(x) else np.asarray(x, np.int32)
            for x in items]


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState, tc, vocab,
                    extra: Optional[dict] = None,
                    mesh=None) -> Optional[str]:
    """Write <ckpt_dir>/<step>/ {state.npz, config.json, vocab.json,
    meta.json} in the JAX package's npz layout; returns the step
    directory. ``recnet_tpu.checkpoint.load_checkpoint`` restores it.
    On a process group every rank calls it: the vocabulary shards are
    gathered over 'model', the primary writes, the others return None."""
    if not dist.is_primary() and not mesh_lib.use_tp(mesh):
        return None
    leaves = state_leaves(state, mesh, vocab.n_vocabs)
    if not dist.is_primary():
        return None
    step_dir = os.path.join(ckpt_dir, str(step))
    os.makedirs(step_dir, exist_ok=True)
    np.savez(os.path.join(step_dir, "state.npz"),
             **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
    with open(os.path.join(step_dir, "config.json"), "w") as f:
        f.write(tc.to_json())
    with open(os.path.join(step_dir, "vocab.json"), "w") as f:
        f.write(vocab.to_json())
    meta = {"step": int(step), "n_leaves": len(leaves),
            "structure": fingerprint(tc, vocab.n_vocabs), "backend": "npz"}
    meta.update(extra or {})
    with open(os.path.join(step_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return step_dir


def load_checkpoint(step_dir: str, tc, vocab_size: int, device="cuda",
                    mesh=None) -> Tuple[TrainState, dict]:
    """The whole TrainState of an npz checkpoint (the port's or the JAX
    package's) for ``tc``, on ``device``; returns (state, meta). Raises
    when the structure, a leaf count or a shape disagrees with ``tc``.
    On a 'model' axis (``mesh``) the rank keeps its shards of the
    vocabulary leaves."""
    with open(os.path.join(step_dir, "meta.json")) as f:
        meta = json.load(f)
    if os.path.isdir(os.path.join(step_dir, "state_orbax")):
        raise ValueError(f"{step_dir} is an orbax checkpoint; the port reads "
                         "npz checkpoints only (save with backend='npz')")
    if meta["structure"] != fingerprint(tc, vocab_size):
        raise ValueError(
            "Checkpoint tree structure does not match the model; was it "
            "saved with a different config?")
    dec_shapes = expected_shapes(config_from_train(tc, vocab_size))
    models = [(dec_shapes, tc.decoder_use_amsgrad)]
    if tc.use_recon:
        models.append((expected_rec_shapes(rec_config_from_train(tc)),
                       tc.reconstructor_use_amsgrad))
    with np.load(os.path.join(step_dir, "state.npz")) as data:
        leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    want = [()] + [s for shapes, amsgrad in models
                   for s in tree_leaves(shapes) + [()]
                   + tree_leaves(shapes) * (3 if amsgrad else 2)]
    if len(leaves) != len(want):
        raise ValueError(f"Leaf count mismatch: {len(leaves)} vs "
                         f"{len(want)}")
    for i, (got, shape) in enumerate(zip(leaves, want)):
        if tuple(got.shape) != tuple(shape):
            raise ValueError(f"leaf_{i} has shape {got.shape}; the config "
                             f"implies {tuple(shape)}")
    it = iter(leaves)
    step = int(next(it))
    parts = []
    for shapes, amsgrad in models:
        params = tree_fill(shapes, it)
        count = int(next(it))
        mu, nu = tree_fill(shapes, it), tree_fill(shapes, it)
        nu_max = tree_fill(shapes, it) if amsgrad else None
        parts.append((params, (count, mu, nu, nu_max)))
    rec = parts[1] if len(parts) > 1 else (None, None)
    state = make_train_state(tc, step, parts[0][0], rec[0],
                             dec_adam=parts[0][1], rec_adam=rec[1],
                             device=device)
    return (mesh_lib.shard_state(state, mesh) if mesh is not None
            else state), meta


def prune_old(ckpt_dir: str, keep_last_k: int) -> None:
    """Retention: delete all but the newest k step directories."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
    for step in steps[:-keep_last_k] if keep_last_k > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, str(step)), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()]
    return max(steps) if steps else None


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
