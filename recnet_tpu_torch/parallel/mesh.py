"""The device mesh and its sharding rules: data parallel over 'data', the
vocabulary matrices split over 'model'.

Port of ``recnet_tpu.parallel.mesh``. The JAX package annotates shardings
on one jitted step and lets GSPMD insert the collectives; here each rank
holds its pieces and the step calls the collectives itself:

* ``data``: the batch is split over the axis; after the backward pass the
  gradients are summed over it (``all_reduce_grads``), once a step;
* ``model``: the embedding's rows, ``out_w``'s columns and ``out_b`` (the
  vocabulary-sized leaves, and their Adam moments) are split over the axis
  (``parallel.vocab`` holds the lookup, the projection, the cross entropy
  and the argmax over such shards).

A mesh is laid over one of two kinds of device. In a process group
(``distributed.initialize``) its entries are the ranks, row-major, each
rank one device, and ``torch.distributed``'s ``init_device_mesh`` gives the
axes' groups. Without a group they are a list of this process's devices,
which ``serving.Captioner`` splits its batches over (a test may name one
device twice).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from recnet_tpu_torch.parallel import distributed as dist
from recnet_tpu_torch.training.optim import adam_state, load_adam_state, \
    make_adam
from recnet_tpu_torch.utils.misc import tree_fill, tree_leaves

Spec = Tuple[Optional[str], ...]       # a PartitionSpec as a tuple


class Mesh:
    """Named axes over devices. ``shape`` maps each axis to its size (as a
    JAX mesh's); ``devices`` holds the entries in that shape: ranks in a
    process group, ``torch.device``s otherwise. ``device`` is this
    process's device (the rank's, or the first local one)."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int],
                 devices: np.ndarray, device: torch.device,
                 device_mesh=None):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(axis_names, sizes))
        self.devices = devices
        self.device = device
        self.device_mesh = device_mesh

    @property
    def distributed(self) -> bool:
        """Whether the entries are ranks of a process group."""
        return self.device_mesh is not None

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coordinate(self, axis: str) -> int:
        """This rank's index on ``axis`` (0 off a process group)."""
        if self.device_mesh is None or axis not in self.shape:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of ``axis`` through this rank; None off a
        process group or when the mesh has no such axis."""
        if self.device_mesh is None or axis not in self.shape:
            return None
        return self.device_mesh.get_group(axis)

    def local_devices(self) -> List[torch.device]:
        """The devices along 'data' of a mesh of local devices."""
        if self.distributed:
            raise ValueError("a process group's mesh holds ranks; each rank "
                             "has one device (mesh.device)")
        return list(np.asarray(self.devices).reshape(
            self.size("data"), -1)[:, 0])

    def __repr__(self) -> str:
        kind = "ranks" if self.distributed else "devices"
        return f"Mesh({self.shape}, {kind})"


def make_mesh(shape: Optional[Sequence[Tuple[str, int]]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """shape e.g. (("data", 4), ("model", 2)); no shape, or
    (("data", 1),), puts every device on a 1-D data axis.

    ``devices``: the local devices (``torch.device``s or names) of a mesh
    without a process group. Left out, they are the group's ranks, or
    without a group every visible card. A mesh larger than the devices
    raises ``ValueError``; one smaller takes the first entries, except in
    a process group, where every rank needs a place."""
    group = devices is None and dist.is_initialized()
    if group:
        entries: List[Any] = list(range(tdist.get_world_size()))
    elif devices is not None:
        entries = [torch.device(d) for d in devices]
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no process group and no card; "
                               "name the devices (devices=[...])")
        entries = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if shape is None or tuple(map(tuple, shape)) == (("data", 1),):
        shape = (("data", len(entries)),)
    names = [name for name, _ in shape]
    sizes = [int(size) for _, size in shape]
    n = int(np.prod(sizes))
    if n > len(entries):
        raise ValueError(f"mesh needs {n} devices, have {len(entries)}")
    if group and n != len(entries):
        raise ValueError(f"mesh covers {n} of the group's {len(entries)} "
                         "ranks; every rank needs a place")
    grid = np.empty(n, dtype=object)
    grid[:] = entries[:n]
    grid = grid.reshape(sizes)
    if not group:
        return Mesh(names, sizes, grid, entries[0])
    from torch.distributed.device_mesh import init_device_mesh
    dev = dist.device()
    device_mesh = init_device_mesh(dev.type, tuple(sizes),
                                   mesh_dim_names=tuple(names))
    return Mesh(names, sizes, grid, dev, device_mesh)


class BatchSharding(NamedTuple):
    """The batch dimension ``axis`` split over 'data' (axis 0 for videos
    (B, F, E) and row indices (B,), 1 for time-major captions (T, B); one
    more under a leading (k,) axis of stacked dispatches)."""
    mesh: Mesh
    axis: int = 0

    def slices(self, n: int) -> List[slice]:
        """The 'data' entries' rows of a batch of ``n``: equal slices in
        order. A batch that does not divide raises ValueError."""
        d = self.mesh.size("data")
        if n % d:
            raise ValueError(f"a batch of {n} does not divide over the "
                             f"mesh's 'data' axis of size {d}")
        per = n // d
        return [slice(i * per, (i + 1) * per) for i in range(d)]

    def part(self, x) -> np.ndarray:
        """This rank's slice of ``x`` along ``axis``."""
        x = np.asarray(x)
        index = [slice(None)] * x.ndim
        index[self.axis] = self.slices(x.shape[self.axis])[
            self.mesh.coordinate("data")]
        return x[tuple(index)]


class Replicated(NamedTuple):
    """Every entry holds the whole array."""
    mesh: Mesh

    def part(self, x) -> np.ndarray:
        return np.asarray(x)


def batch_sharding(mesh: Mesh, batch_axis: int = 0) -> BatchSharding:
    return BatchSharding(mesh, batch_axis)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


# --------------------------------------------------------------------------
# Sharding rules
# --------------------------------------------------------------------------

def _spec_for_path(path_str: str, use_tp: bool) -> Spec:
    """Partition rule by parameter name, string for string the JAX
    package's: TP applies only inside the decoder subtree (.dec_params /
    .dec_opt); the reconstructor's out_w and out_b are (hidden, hidden),
    not vocabulary-sized, and stay replicated."""
    if not use_tp:
        return ()
    if not (".dec_params" in path_str or ".dec_opt" in path_str):
        return ()
    if "embedding" in path_str:
        return ("model", None)       # (V, E) split over the vocabulary
    if "out_w" in path_str:
        return (None, "model")       # (H, V)
    if "out_b" in path_str:
        return ("model",)            # (V,)
    return ()


def _paths(tree, prefix: str):
    """(path, leaf) of a parameter tree in flatten order, the path written
    as ``jax.tree_util.keystr`` writes it after ``prefix``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _leaf_spec(path: str, leaf, use_tp: bool) -> Spec:
    spec = _spec_for_path(path, use_tp)
    if spec and leaf.dim() != len(spec):
        spec = ()                    # scalars, mismatched leaves: replicate
    return spec


def use_tp(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.size("model") > 1


def param_specs(params, prefix: str, mesh: Optional[Mesh]) -> List[Spec]:
    """The spec of each leaf of a parameter tree (``prefix`` ".dec_params"
    or ".rec_params"), in flatten order."""
    return [_leaf_spec(path, leaf, use_tp(mesh))
            for path, leaf in _paths(params, prefix)]


def state_shardings(state, mesh: Mesh) -> List[Tuple[str, Spec]]:
    """(path, spec) of every leaf of a ``TrainState``, in the order of
    ``checkpoint.state_leaves`` (the JAX flatten order): the step, each
    model's params, then its Adam count and moments. The moments mirror
    the params, so they take the params' rules."""
    out: List[Tuple[str, Spec]] = [(".step", ())]
    models = [("dec", state.dec_params, state.dec_opt)]
    if state.rec_params is not None:
        models.append(("rec", state.rec_params, state.rec_opt))
    tp = use_tp(mesh)
    for name, params, opt in models:
        out += [(p, _leaf_spec(p, leaf, tp))
                for p, leaf in _paths(params, f".{name}_params")]
        out.append((f".{name}_opt.count", ()))
        moments = ("mu", "nu") + (("nu_max",) if opt.param_groups[0][
            "amsgrad"] else ())
        for moment in moments:
            out += [(p, _leaf_spec(p, leaf, tp))
                    for p, leaf in _paths(params,
                                          f".{name}_opt.{moment}")]
    return out


def vocab_range(vocab_size: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of the ``index``-th of ``parts`` vocabulary shards, as
    ``torch.tensor_split`` cuts them (the first V % parts one row longer),
    so that a V that does not divide still shards."""
    per, extra = divmod(vocab_size, parts)
    start = index * per + min(index, extra)
    return start, start + per + (index < extra)


def _take(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of a full leaf under ``spec``."""
    x = x.detach()
    if "model" not in spec:
        return x.clone()
    dim = spec.index("model")
    return torch.tensor_split(x, mesh.size("model"), dim)[
        mesh.coordinate("model")].clone()


def shard_state(state, mesh: Mesh):
    """A full ``TrainState`` (every rank's, alike) as this rank's: each
    vocabulary leaf of the decoder and its Adam moments cut to the rank's
    shard, everything else as it is. A mesh without a 'model' axis leaves
    the state as it is."""
    if not use_tp(mesh):
        return state
    specs = param_specs(state.dec_params, ".dec_params", mesh)
    params = tree_leaves(state.dec_params)
    shards = [_take(p, s, mesh).requires_grad_(True)
              for p, s in zip(params, specs)]
    dec_params = tree_fill(state.dec_params, iter(shards))
    group = state.dec_opt.param_groups[0]
    opt = make_adam(dec_params, group["lr"], group["weight_decay"],
                    group["amsgrad"])
    count, mu, nu, nu_max = adam_state(state.dec_opt)
    cut = lambda moment: [_take(m, s, mesh) for m, s in zip(moment, specs)]
    load_adam_state(opt, count, cut(mu), cut(nu),
                    cut(nu_max) if nu_max is not None else None)
    return dataclasses.replace(state, dec_params=dec_params, dec_opt=opt)


def gather_vocab(x: torch.Tensor, dim: int, mesh: Mesh,
                 vocab_size: int) -> torch.Tensor:
    """The whole of a leaf split over 'model' along ``dim``, on every rank
    of the group (a sum of zero-padded shards: an all-reduce, which gloo
    also takes on a card). A leaf that is whole already comes back as it
    is."""
    if not use_tp(mesh) or x.shape[dim] == vocab_size:
        return x
    lo, hi = vocab_range(vocab_size, mesh.size("model"),
                         mesh.coordinate("model"))
    shape = list(x.shape)
    shape[dim] = vocab_size
    full = x.new_zeros(shape)
    full.narrow(dim, lo, hi - lo).copy_(x.detach())
    tdist.all_reduce(full, group=mesh.group("model"))
    return full


_VOCAB_DIMS = {"embedding": 0, "out_w": 1, "out_b": 0}


def gather_params(params: Dict, mesh: Optional[Mesh],
                  vocab_size: int) -> Dict:
    """Decoder params with their vocabulary shards gathered (a collective
    over 'model': every rank of the group calls it); whole params, and any
    params off a 'model' axis, come back as they are."""
    if not use_tp(mesh):
        return params
    out = dict(params)
    for key, dim in _VOCAB_DIMS.items():
        out[key] = gather_vocab(params[key], dim, mesh, vocab_size)
    return out


def gather_leaves(leaves: List[torch.Tensor], specs: List[Spec],
                  mesh: Optional[Mesh], vocab_size: int
                  ) -> List[torch.Tensor]:
    """``leaves`` with each one split over 'model' gathered (collective)."""
    return [gather_vocab(x, s.index("model"), mesh, vocab_size)
            if "model" in s else x for x, s in zip(leaves, specs)]


# --------------------------------------------------------------------------
# One step's place on the mesh
# --------------------------------------------------------------------------

class Shard(NamedTuple):
    """A rank's piece of one step: its rows of the global batch and its
    columns of the vocabulary, (start, stop, whole), with the groups that
    sum over each (None where the step is not split that way)."""
    rows: Tuple[int, int, int]
    cols: Tuple[int, int, int]
    data_group: Any = None
    model_group: Any = None

    @property
    def owns_replicated(self) -> bool:
        """Whether this rank adds the terms every data rank computes alike
        (the regularisers), so that the sum over 'data' counts them once:
        the rank with the first rows."""
        return self.rows[0] == 0


def step_shard(mesh: Optional[Mesh], batch_rows: int, vocab_size: int,
               split_batch: bool = True) -> Optional[Shard]:
    """This rank's ``Shard`` of a step over ``batch_rows`` local rows:
    the batch split over 'data' when ``split_batch`` (a train step), whole
    otherwise (the val step); the vocabulary over 'model'. None off a
    process group: one device holds the whole step."""
    if mesh is None or not mesh.distributed:
        return None
    if split_batch:
        d, i = mesh.size("data"), mesh.coordinate("data")
        rows = (i * batch_rows, (i + 1) * batch_rows, d * batch_rows)
        data_group = mesh.group("data")
    else:
        rows, data_group = (0, batch_rows, batch_rows), None
    m = mesh.size("model")
    lo, hi = vocab_range(vocab_size, m, mesh.coordinate("model"))
    return Shard(rows, (lo, hi, vocab_size), data_group,
                 mesh.group("model") if m > 1 else None)


def data_sum(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """``x`` summed over the step's 'data' group (outside autograd: counts
    and masks); ``x`` itself when the batch is whole here."""
    if shard is None or shard.data_group is None:
        return x
    x = x.detach().clone()
    tdist.all_reduce(x, group=shard.data_group)
    return x


def all_reduce_grads(params: List[torch.Tensor], extra: List[torch.Tensor],
                     group) -> List[torch.Tensor]:
    """Sum every parameter's gradient and the 0-d ``extra`` values over
    ``group`` in one all-reduce of a flat buffer; the gradients are
    replaced in place, the summed extras returned."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [e.detach().reshape(-1).to(grads[0].dtype)
                        for e in extra])
    tdist.all_reduce(flat, group=group)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g)
        offset += n
    return list(flat[offset:])
