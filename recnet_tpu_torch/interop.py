"""Import and export trained reference (hobincar PyTorch) checkpoints: the
port's copy of ``recnet_tpu/interop.py``.

The reference saves ``torch.save({'iteration', 'dec', 'rec'?, 'dec_opt',
'rec_opt'?, 'loss', 'config'}, <iter>_checkpoint.tar)`` (reference:
train.py:397-420). Two properties of that format shape this module:

* ``'config'`` is the TrainConfig **class object** pickled by reference, so
  the checkpoint carries no hyperparameter values: the architecture is
  recovered from the weight tensors, and the knobs that leave no trace in
  them (``embedding_scale``, ``caption_max_len``, ``encoder_output_len``)
  come from a base config.
* The optimizer state_dicts index parameters by their position in
  ``model.parameters()`` (torch's enumeration order: the root-level
  ``attn_b`` first, then the submodules' weights; reference
  models/decoder.py:22-42, train.py:149-150). The port's ``make_adam``
  indexes them in the JAX flatten order (dict keys sorted). So the moments
  travel as trees shaped like the params, built from and written back to
  the reference's order (``_decoder_layout``): the import and the export
  both permute, and ``make_train_state`` / ``optim.load_adam_state`` take
  the int ``step`` of a torch-1.0 state dict.

Weight layout (ours = torch transposed): torch ``nn.Linear`` / RNN weights
are (out, in); the port keeps the JAX (in, out) layout. The gate order in
the fused RNN weights is torch's own (LSTM i,f,g,o / GRU r,z,n), which is
also ours, so the mapping is a pure transpose. Import and export are host
tools: they read and write files and hold CPU tensors; the imported
directory is a normal port checkpoint that ``cli.eval``, ``cli.caption``,
``cli.serve`` and ``cli.train --resume`` load onto the card.
"""

from __future__ import annotations

import contextlib
import sys
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.models.decoder import DecoderConfig
from recnet_tpu_torch.models.reconstructors import ReconstructorConfig
from recnet_tpu_torch.training.optim import BETAS, EPS, adam_state
from recnet_tpu_torch.training.step import TrainState, make_train_state
from recnet_tpu_torch.utils.misc import tree_fill

# (state_dict key, path into our param tree, transpose?)
Layout = List[Tuple[str, Tuple[Any, ...], bool]]
# an Adam state as the JAX TorchAdamState fields: (count, mu, nu, nu_max),
# each moment a tree like the params (nu_max None without AMSGrad)
AdamTrees = Tuple[int, Dict, Dict, Optional[Dict]]


# --------------------------------------------------------------------------
# Loading the .tar
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _stub_reference_config_module():
    """Make ``config.TrainConfig`` (and friends) resolvable during
    unpickling. The reference pickles its config *class*; loading outside
    the reference repo would raise ModuleNotFoundError. A throwaway stub
    module stands in; the class carries no values, so nothing is lost."""
    prev = sys.modules.get("config")
    if prev is not None and hasattr(prev, "TrainConfig"):
        yield
        return
    stub = types.ModuleType("config")
    for name in ("TrainConfig", "SplitConfig", "EvalConfig"):
        setattr(stub, name, type(name, (), {"__module__": "config"}))
    sys.modules["config"] = stub
    try:
        yield
    finally:
        if prev is None:
            sys.modules.pop("config", None)
        else:
            sys.modules["config"] = prev


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """torch.load a reference ``*_checkpoint.tar`` onto the CPU. It is a
    full pickle (the config class, optimizer dicts), hence
    ``weights_only=False``; ``encoding="latin1"`` reads py2 pickles. Load
    only checkpoints you trust: unpickling can run code."""
    with _stub_reference_config_module():
        ckpt = torch.load(path, map_location="cpu", weights_only=False,
                          encoding="latin1")
    if "dec" not in ckpt:
        raise ValueError(
            f"{path} does not look like a reference checkpoint "
            f"(keys: {sorted(ckpt)}); expected at least 'dec'")
    return ckpt


# --------------------------------------------------------------------------
# state_dict -> our param tree
# --------------------------------------------------------------------------

def _rnn_n_layers(sd: Dict[str, Any]) -> int:
    layers = [int(k.rsplit("_l", 1)[1]) for k in sd
              if k.startswith("rnn.weight_ih_l") and "reverse" not in k]
    if not layers:
        raise ValueError("no rnn.weight_ih_l* keys in state_dict")
    return 1 + max(layers)


def _decoder_layout(sd: Dict[str, Any]) -> Layout:
    """Reference Decoder parameters in torch's enumeration order: both
    ``state_dict()`` and ``parameters()`` walk the module tree root first,
    so the root-level ``attn_b`` (reference decoder.py:27) comes first,
    though it is assigned after embedding/attn_W/attn_U."""
    layout: Layout = [
        ("attn_b", ("attention", "b"), False),
        ("embedding.weight", ("embedding",), False),
        ("attn_W.weight", ("attention", "W"), True),
        ("attn_U.weight", ("attention", "U"), True),
        ("attn_w.weight", ("attention", "w"), True),
    ]
    layout += _rnn_layout(sd)
    layout += [("out.weight", ("out_w",), True),
               ("out.bias", ("out_b",), False)]
    return layout


def _reconstructor_layout(sd: Dict[str, Any]) -> Layout:
    """Reference {Global,Local}Reconstructor parameters in torch's
    enumeration order (the local variant's root-level attn_b first,
    reference local_reconstructor.py:20; the global variant has no
    root-level Parameter)."""
    layout: Layout = []
    if "attn_W.weight" in sd:   # local variant
        layout += [
            ("attn_b", ("attention", "b"), False),
            ("attn_W.weight", ("attention", "W"), True),
            ("attn_U.weight", ("attention", "U"), True),
            ("attn_w.weight", ("attention", "w"), True),
        ]
    layout += _rnn_layout(sd)
    layout += [("out.weight", ("out_w",), True),
               ("out.bias", ("out_b",), False)]
    return layout


def _rnn_layout(sd: Dict[str, Any]) -> Layout:
    out: Layout = []
    for li in range(_rnn_n_layers(sd)):
        out += [
            (f"rnn.weight_ih_l{li}", ("rnn", li, "w_ih"), True),
            (f"rnn.weight_hh_l{li}", ("rnn", li, "w_hh"), True),
            (f"rnn.bias_ih_l{li}", ("rnn", li, "b_ih"), False),
            (f"rnn.bias_hh_l{li}", ("rnn", li, "b_hh"), False),
        ]
    return out


def _fake_sd(n_layers: int, with_attn: bool) -> Dict[str, Any]:
    """A key-only state_dict standing in for layout construction."""
    sd: Dict[str, Any] = {f"rnn.weight_ih_l{i}": None
                          for i in range(n_layers)}
    if with_attn:
        sd["attn_W.weight"] = None
    return sd


def _tree_from_tensors(layout: Layout, get) -> Dict:
    """A param-shaped tree of numpy arrays in the JAX layout;
    ``get(i, sd_key)`` gives the i-th entry of the layout in torch's
    layout. Always copies: ``.numpy()`` views share the module's memory."""
    tree: Dict = {}
    for i, (key, path, transpose) in enumerate(layout):
        val = get(i, key)
        val = val.T.copy() if transpose else np.array(val, copy=True)
        node = tree
        for part, nxt in zip(path[:-1], path[1:]):
            if isinstance(part, int):
                while len(node) <= part:
                    node.append({})
                node = node[part]
            else:
                node = node.setdefault(part, [] if isinstance(nxt, int)
                                       else {})
        node[path[-1]] = val
    return tree


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def decoder_from_state_dict(sd: Dict[str, Any],
                            embedding_scale: float = 1.0
                            ) -> Tuple[Dict, DecoderConfig]:
    """A reference Decoder state_dict as (params, DecoderConfig). The
    architecture comes from the tensor shapes; ``embedding_scale`` leaves
    no trace in the weights (reference default 1.0, config.py:59)."""
    sd = {k: _np(v) for k, v in sd.items()}
    vocab_size, embedding_size = sd["embedding.weight"].shape
    attn_size, hidden_size = sd["attn_W.weight"].shape
    encoder_size = sd["attn_U.weight"].shape[1]
    gates = sd["rnn.weight_hh_l0"].shape[0] // hidden_size
    cfg = DecoderConfig(
        cell_type="LSTM" if gates == 4 else "GRU",
        n_layers=_rnn_n_layers(sd), vocab_size=vocab_size,
        embedding_size=embedding_size, embedding_scale=embedding_scale,
        encoder_size=encoder_size, hidden_size=hidden_size,
        attn_size=attn_size)
    params = _tree_from_tensors(_decoder_layout(sd), lambda i, k: sd[k])
    return params, cfg


def reconstructor_from_state_dict(sd: Dict[str, Any],
                                  caption_max_len: int = 30,
                                  encoder_output_len: int = 28
                                  ) -> Tuple[Dict, ReconstructorConfig]:
    """A reference reconstructor state_dict as (params, config). The
    variant comes from the keys (the local one has attention weights);
    ``caption_max_len`` (the global rescale, global_reconstructor.py:37)
    and ``encoder_output_len`` (the local step count, train.py:122) leave
    no trace in the weights."""
    sd = {k: _np(v) for k, v in sd.items()}
    kind = "local" if "attn_W.weight" in sd else "global"
    hidden_size = sd["rnn.weight_hh_l0"].shape[1]
    gates = sd["rnn.weight_hh_l0"].shape[0] // hidden_size
    in0 = sd["rnn.weight_ih_l0"].shape[1]
    cfg = ReconstructorConfig(
        kind=kind, cell_type="LSTM" if gates == 4 else "GRU",
        n_layers=_rnn_n_layers(sd),
        decoder_hidden_size=in0 if kind == "local" else in0 // 2,
        hidden_size=hidden_size,
        attn_size=sd["attn_b"].shape[0] if kind == "local" else 128,
        caption_max_len=caption_max_len,
        encoder_output_len=encoder_output_len)
    params = _tree_from_tensors(_reconstructor_layout(sd),
                                lambda i, k: sd[k])
    return params, cfg


# --------------------------------------------------------------------------
# torch.optim.Adam state_dict <-> moment trees
# --------------------------------------------------------------------------

def _adam_hypers(opt_sd: Dict[str, Any]) -> Dict[str, Any]:
    g = opt_sd["param_groups"][0]
    return {"lr": float(g["lr"]), "weight_decay": float(g["weight_decay"]),
            "amsgrad": bool(g.get("amsgrad", False)),
            "b1": float(g["betas"][0]), "b2": float(g["betas"][1]),
            "eps": float(g["eps"])}


def adam_state_from_torch(opt_sd: Dict[str, Any], layout: Layout,
                          params: Dict) -> Tuple[AdamTrees, Dict[str, Any]]:
    """A reference optimizer's state_dict as moment trees shaped like
    ``params``: entry i of its state is the layout's i-th parameter (one
    group built from ``model.parameters()``, reference
    train.py:149-150,186-187); moments transpose as their weights do. A
    parameter that never took a step gets zero moments. Returns
    ((count, mu, nu, nu_max), hypers)."""
    hypers = _adam_hypers(opt_sd)
    idx_order = list(opt_sd["param_groups"][0]["params"])
    if len(idx_order) != len(layout):
        raise ValueError(
            f"optimizer has {len(idx_order)} params, model layout has "
            f"{len(layout)} — state_dict/model mismatch")
    state = opt_sd.get("state", {})
    shapes = {key: (path, transpose) for key, path, transpose in layout}

    def moment(name):
        def get(i, key):
            entry = state.get(idx_order[i])
            if entry is None or name not in entry:
                path, transpose = shapes[key]
                node = params
                for part in path:
                    node = node[part]
                return np.zeros(node.T.shape if transpose else node.shape,
                                np.float32)
            return _np(entry[name])
        return _tree_from_tensors(layout, get)

    count = max([int(e["step"]) for e in state.values()] or [0])
    mu, nu = moment("exp_avg"), moment("exp_avg_sq")
    nu_max = moment("max_exp_avg_sq") if hypers["amsgrad"] else None
    return (count, mu, nu, nu_max), hypers


def adam_state_to_torch(adam: AdamTrees, layout: Layout, lr: float,
                        weight_decay: float, amsgrad: bool,
                        b1: float = BETAS[0], b2: float = BETAS[1],
                        eps: float = EPS) -> Dict[str, Any]:
    """Moment trees as a torch.optim.Adam state_dict in the reference's
    parameter order. ``step`` is a plain int (the torch-1.0 form; newer
    torch makes it a tensor on load) and param_groups carry only the keys
    torch 1.0 knew (newer torch fills its own defaults on load)."""
    count, mu, nu, nu_max = adam
    moments = [("exp_avg", mu), ("exp_avg_sq", nu)]
    if amsgrad:
        moments.append(("max_exp_avg_sq", nu_max))
    state: Dict[int, Dict[str, Any]] = {}
    for i, (key, path, transpose) in enumerate(layout):
        entry: Dict[str, Any] = {"step": int(count)}
        for name, tree in moments:
            entry[name] = _tensor_at(tree, path, transpose)
        state[i] = entry
    return {"state": state, "param_groups": [{
        "lr": float(lr), "betas": (float(b1), float(b2)), "eps": float(eps),
        "weight_decay": float(weight_decay), "amsgrad": bool(amsgrad),
        "params": list(range(len(layout)))}]}


def _tensor_at(tree, path, transpose: bool) -> torch.Tensor:
    """The leaf at ``path`` as a float32 CPU tensor in torch's layout."""
    node = tree
    for part in path:
        node = node[part]
    val = np.array(_np(node), dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(val.T) if transpose
                            else val)


# --------------------------------------------------------------------------
# Whole checkpoint <-> TrainState
# --------------------------------------------------------------------------

def train_state_from_reference(ckpt: Dict[str, Any],
                               base_config: Optional[TrainConfig] = None,
                               device="cpu"
                               ) -> Tuple[TrainState, DecoderConfig,
                                          Optional[ReconstructorConfig],
                                          TrainConfig]:
    """A resumable TrainState on ``device`` from a loaded reference
    checkpoint. ``base_config`` supplies the weight-invisible knobs
    (embedding_scale, caption_max_len, encoder_output_len, data paths,
    cadences); every architecture and optimizer knob comes from the
    weights and the optimizer groups."""
    tc = base_config if base_config is not None else TrainConfig()
    dec_params, dcfg = decoder_from_state_dict(
        ckpt["dec"], embedding_scale=tc.embedding_scale)
    dec_adam, dec_hyp = adam_state_from_torch(
        ckpt["dec_opt"], _decoder_layout(ckpt["dec"]), dec_params)

    rec_params = rec_adam = rcfg = None
    rec_hyp: Dict[str, Any] = {}
    if "rec" in ckpt:
        rec_params, rcfg = reconstructor_from_state_dict(
            ckpt["rec"], caption_max_len=tc.caption_max_len,
            encoder_output_len=tc.encoder_output_len)
        rec_adam, rec_hyp = adam_state_from_torch(
            ckpt["rec_opt"], _reconstructor_layout(ckpt["rec"]), rec_params)

    tc = tc.replace(
        decoder_model=dcfg.cell_type,
        decoder_n_layers=dcfg.n_layers,
        embedding_size=dcfg.embedding_size,
        encoder_output_size=dcfg.encoder_size,
        decoder_hidden_size=dcfg.hidden_size,
        decoder_attn_size=dcfg.attn_size,
        decoder_learning_rate=dec_hyp["lr"],
        decoder_weight_decay=dec_hyp["weight_decay"],
        decoder_use_amsgrad=dec_hyp["amsgrad"],
        use_recon=rcfg is not None,
        **({"reconstructor_type": rcfg.kind,
            "reconstructor_model": rcfg.cell_type,
            "reconstructor_n_layers": rcfg.n_layers,
            "reconstructor_hidden_size": rcfg.hidden_size,
            "reconstructor_attn_size": rcfg.attn_size,
            "reconstructor_learning_rate": rec_hyp["lr"],
            "reconstructor_weight_decay": rec_hyp["weight_decay"],
            "reconstructor_use_amsgrad": rec_hyp["amsgrad"]}
           if rcfg is not None else {}),
    )
    state = make_train_state(tc, int(ckpt.get("iteration", 0)), dec_params,
                             rec_params, dec_adam=dec_adam,
                             rec_adam=rec_adam, device=device)
    return state, dcfg, rcfg, tc


def _adam_trees(opt: torch.optim.Adam, params: Dict) -> AdamTrees:
    """``opt``'s state (its moments in the JAX flatten order) as trees
    shaped like ``params``."""
    count, mu, nu, nu_max = adam_state(opt)
    fill = lambda moment: tree_fill(params, iter(moment))
    return (count, fill(mu), fill(nu),
            fill(nu_max) if nu_max is not None else None)


def export_reference_checkpoint(path: str, state: TrainState,
                                tc: TrainConfig,
                                loss: Optional[float] = None) -> None:
    """Write a reference-format ``*_checkpoint.tar`` (train.py:395-418),
    readable by the reference's own py2/torch-1.0 eval.py: the legacy
    (non-zipfile) serialization, pickle protocol 2, int optimizer steps,
    and the ``'config'`` entry pickled as the ``config.TrainConfig`` class
    by reference, as the reference saves it."""
    dec_layout = _decoder_layout(_fake_sd(len(state.dec_params["rnn"]),
                                          True))
    out: Dict[str, Any] = {
        "iteration": int(state.step),
        "dec": {key: _tensor_at(state.dec_params, p, t)
                for key, p, t in dec_layout},
        "dec_opt": adam_state_to_torch(
            _adam_trees(state.dec_opt, state.dec_params), dec_layout,
            tc.decoder_learning_rate, tc.decoder_weight_decay,
            tc.decoder_use_amsgrad),
        "loss": float(loss) if loss is not None else 0.0,
    }
    if state.rec_params is not None:
        rec_layout = _reconstructor_layout(_fake_sd(
            len(state.rec_params["rnn"]), "attention" in state.rec_params))
        out["rec"] = {key: _tensor_at(state.rec_params, p, t)
                      for key, p, t in rec_layout}
        out["rec_opt"] = adam_state_to_torch(
            _adam_trees(state.rec_opt, state.rec_params), rec_layout,
            tc.reconstructor_learning_rate, tc.reconstructor_weight_decay,
            tc.reconstructor_use_amsgrad)

    with _stub_reference_config_module():
        out["config"] = sys.modules["config"].TrainConfig
        torch.save(out, path, pickle_protocol=2,
                   _use_new_zipfile_serialization=False)
