"""The per-step kernels of the training rollouts' custom backward: the
wrappers of ``csrc/rollout.cu`` and their plain-PyTorch versions.

They serve the ``torch.autograd.Function`` rollouts of ``ops.rnn``
(``lstm_rollout_pre``, ``gru_rollout_pre``) and ``models.decoder``
(``tf_attn_rollout``), the port of the JAX package's custom VJPs
(``recnet_tpu/ops/rnn.py:207-282``, ``recnet_tpu/models/decoder.py:241-340``).
The JAX package leaves this work to XLA's fusion, so no Pallas kernel is
on the path; each elementwise stage of a step is one kernel here, and the
products stay with the callers (``torch.mm`` / ``addmm_``).

* ``cell_forward``: the elementwise part of ``rollout_cell_fwd``. LSTM
  from ``gx = gi + h w_hh`` and ``b_hh``; GRU from ``gx = gi`` and
  ``gh = h w_hh`` and ``b_hh`` (r scales gh's n part, b_hh's included).
  Returns (h', c' (the GRU echoes c), acts): [i, f, g, o] for LSTM,
  [r, z, n, h_n] for GRU, each (B, H) block of acts (B, 4H).
* ``cell_backward``: the elementwise part of ``rollout_cell_bwd`` from the
  carried cotangent ``dh`` plus the step's output cotangent ``dh_out``.
  Returns (dgi, dgh, dh_cell, dc_prev): LSTM dgi is dgh, dh_cell is None
  (its dh_prev is dgh w_hh^T alone) and dc_prev = dc f; GRU dh_cell =
  dh z and dc_prev echoes dc.
* ``attention_forward``: the decoder step's attention from ``wh = h W``
  (the caller's product): ``scores = w . tanh(wh + uv + b)`` (B, F),
  ``ctx = sum_f scores_f enc_f / F`` (B, E) over the scores as stored.
* ``attention_backward``: ``dscores = dctx . enc / F`` and ``dwh = w *
  sum_f dscores_f (1 - act_f^2)`` from ``act = tanh(wh + uv + b)``.
  Returns (dscores, dwh); ``dh += dwh W^T`` is the caller's product.

Each computes in float32 (float64 for float64 operands, on the CPU) and
stores in the operands' dtype. A value stored and read again within a call
(scores, dscores, GRU's h_n) is read as stored. ``out`` takes the output
tensors to write (views of a rollout's (T, B, .) buffers; None entries are
made); without it every output is new.

The wrappers launch the kernels for CUDA tensors (float32 or bfloat16, one
dtype, on one device, contiguous; the gate products gx and gh, their
cotangents dgi and dgh, wh and dwh need only contiguous rows, so that a
caller can lay them beside another product's columns) and raise on
anything else; for CPU tensors they run the plain versions
(``*_reference``), which count nothing. Each wrapper counts its launches
in ``n_launches``; the cell wrappers also by cell type in
``cell_launches``.

The rollouts' loops call the kernels through ``*_steps`` instead: made
once a rollout from its (T, B, .) buffers, each checks every operand as
the wrapper would and makes each step's ctypes arguments then, and
returns ``launch(t)``, which only launches step t and counts it as the
wrapper does (a wrapper call's checks cost more host time than its
kernel takes on the card). ``launch`` holds the tensors whose pointers it
passes.

``attention_probe`` launches the attention kernels' split probes, each
without one part of its kernel's work; ``attention_probe_reference`` is
their plain version. ``cell_forward_probe`` and ``cell_backward_probe``
launch the cell kernels' probes: each kernel's first design ("scalar":
one thread a unit, the values the kernel is held to), and for the forward
an empty kernel at that design's grid ("empty") and the kernel's loads
and stores without the gates ("copy"). No rollout calls them.

The reconstructor's cell rollout (``ops.rnn.lstm_rollout_pre`` /
``gru_rollout_pre``) runs whole: ``cell_rollout_forward`` and
``cell_rollout_backward`` launch ``csrc/cell_rollout.cu``'s persistent
kernels, one launch for all T steps of a direction, with the step loop as
their plain versions (``cell_rollout_*_reference``). The recurrent
product runs on ``wgmma``: in bf16 with the block's slice of W_hh held in
shared memory, in f32 as three TF32 terms with W_hh's chunks streamed
through an mbarrier ring; a block waits only for the blocks that write
the columns it stages, through a readiness word a block in the launch's
scratch (``_scratch``). ``rollout_shape`` computes a launch's shape and shared
memory from the card's SM count and limit (pure Python, tested on the
CPU); ``rollout_plan`` asks the card for both and for the clusters it
holds at once, and raises ``rollout_refusal``'s error on a shape the card
cannot hold; ``rollout_holds`` asks the same before a launch, for the
route rule ``ops.rnn.whole_rollout``. ``cell_rollout_probe`` launches the
split probes. The per-step cell kernels above stay for the decoder's
attention rollout and for the widths no whole-rollout launch holds.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Optional, Sequence

import torch

from recnet_tpu_torch.ops.cuda import build
from recnet_tpu_torch.ops.cuda.whole_decode import check_sm90

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CELLS = ("LSTM", "GRU")
_SMEM_LIMIT = 48 * 1024       # dynamic shared memory without the opt-in
_COUNT_LOCK = threading.Lock()

OptT = Optional[torch.Tensor]


def _library() -> ctypes.CDLL:
    lib = build.load("rollout")
    if getattr(lib, "_recnet_bound", False):
        return lib
    p, i, ld = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.recnet_cell_fwd.argtypes = [i, i, i, i, ld, ld] + [p] * 9
    lib.recnet_cell_fwd_probe.argtypes = [i] * 5 + [ld, ld] + [p] * 9
    lib.recnet_cell_bwd.argtypes = [i, i, i, i, ld, ld] + [p] * 12
    lib.recnet_cell_bwd_probe.argtypes = [i] * 5 + [ld, ld] + [p] * 12
    lib.recnet_attn_fwd.argtypes = [i] * 5 + [ld] + [p] * 8
    lib.recnet_attn_bwd.argtypes = [i] * 5 + [ld] + [p] * 7
    lib.recnet_attn_fwd_probe.argtypes = [i] * 6 + [ld] + [p] * 8
    lib.recnet_attn_bwd_probe.argtypes = [i] * 6 + [ld] + [p] * 7
    lib.recnet_attn_fwd_smem.argtypes = [i, i, i]
    lib.recnet_attn_bwd_smem.argtypes = [i, i, i, i]
    for fn in (lib.recnet_cell_fwd, lib.recnet_cell_fwd_probe,
               lib.recnet_cell_bwd, lib.recnet_cell_bwd_probe,
               lib.recnet_attn_fwd, lib.recnet_attn_bwd,
               lib.recnet_attn_fwd_probe, lib.recnet_attn_bwd_probe,
               lib.recnet_attn_fwd_smem, lib.recnet_attn_bwd_smem):
        fn.restype = i
    lib.recnet_rollout_error_string.argtypes = [i]
    lib.recnet_rollout_error_string.restype = ctypes.c_char_p
    lib._recnet_bound = True
    return lib


def _compute(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _check_shapes(what: str, operands) -> None:
    """``operands``: (name, tensor or None, shape); raises on a shape the
    kernel does not take."""
    for name, t, shape in operands:
        if t is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} is {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")


def _ld(t: OptT) -> int:
    """The row stride (elements) of a tensor whose rows, its last axis,
    are contiguous and may lie wider apart than they are long; 0 for
    None."""
    return 0 if t is None else t.stride(-2)


def _rows_contiguous(t: torch.Tensor) -> bool:
    return t.stride(-1) == 1 and (t.shape[-2] <= 1
                                  or t.stride(-2) >= t.shape[-1])


def _on_cpu(what: str, operands, row_strided: Sequence[str] = ()) -> bool:
    """True when every operand lies on the CPU (the plain version); for
    CUDA operands, checks what the kernel needs and raises otherwise. The
    operands named in ``row_strided`` need only contiguous rows."""
    present = [(name, t) for name, t, _ in operands if t is not None]
    devices = {t.device for _, t in present}
    if len(devices) > 1:
        raise ValueError(f"{what}: operands on {sorted(map(str, devices))}")
    device = present[0][1].device
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {device}")
    dtype = present[0][1].dtype
    for name, t in present:
        if t.dtype not in _DTYPE_CODES or t.dtype != dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}; the kernel takes "
                             f"float32 or bfloat16 operands of one dtype "
                             f"({present[0][0]} is {dtype})")
        if name in row_strided:
            if not _rows_contiguous(t):
                raise ValueError(f"{what}: {name} must have contiguous rows")
        elif not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    check_sm90(device, what)
    return False


def _outputs(out: Optional[Sequence[OptT]], made: Sequence[OptT]):
    """The plain version's outputs written to ``out`` where it gives a
    tensor; else the made ones."""
    if out is None:
        return tuple(made)
    return tuple(m if o is None or m is None else o.copy_(m)
                 for o, m in zip(out, made))


def _empty(out: Optional[Sequence[OptT]], i: int, shape, like):
    given = None if out is None else out[i]
    return given if given is not None else like.new_empty(shape)


def _check_smem(what: str, nbytes: int, widths: str) -> None:
    if nbytes > _SMEM_LIMIT:
        raise ValueError(f"{what}: {widths} need more than {_SMEM_LIMIT} "
                         f"bytes of shared memory")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        text = (lib.recnet_rollout_error_string
                if hasattr(lib, "recnet_rollout_error_string")
                else lib.recnet_cell_rollout_error_string)(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {text} ({err})")


def _ptr(t: OptT):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _count(fn, cell_type: Optional[str] = None) -> None:
    with _COUNT_LOCK:
        fn.n_launches += 1
        if cell_type is not None:
            fn.cell_launches[cell_type] += 1


# --------------------------------------------------------------------------
# the cell
# --------------------------------------------------------------------------

def _cell_dims(cell_type: str, h):
    """(B, H, G) from h or dh (B, H)."""
    if cell_type not in _CELLS:
        raise ValueError(f"Unknown cell type: {cell_type}")
    if h.dim() != 2:
        raise ValueError(f"h (B, H) expected; got {tuple(h.shape)}")
    B, H = h.shape
    if B < 1 or H < 1:
        raise ValueError(f"empty cell: B={B}, H={H}")
    return B, H, (4 if cell_type == "LSTM" else 3) * H


def cell_forward_reference(cell_type: str, gx: torch.Tensor, gh: OptT,
                           bias: torch.Tensor, h: torch.Tensor, c: OptT):
    """Plain version of ``cell_forward``."""
    dt = gx.dtype
    f = _compute(dt)
    H = h.shape[-1]
    b = bias.to(f)
    if cell_type == "LSTM":
        gates = gx.to(f) + b
        i, fg, o = (torch.sigmoid(gates[:, k * H:(k + 1) * H])
                    for k in (0, 1, 3))
        g = torch.tanh(gates[:, 2 * H:3 * H])
        c_new = fg * c.to(f) + i * g
        h_new = o * torch.tanh(c_new)
        return (h_new.to(dt), c_new.to(dt),
                torch.cat([i, fg, g, o], -1).to(dt))
    gi, gr = gx.to(f), gh.to(f)
    hn = (gr[:, 2 * H:] + b[2 * H:]).to(dt).to(f)
    r = torch.sigmoid(gi[:, :H] + gr[:, :H] + b[:H])
    z = torch.sigmoid(gi[:, H:2 * H] + gr[:, H:2 * H] + b[H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * hn)
    h_new = (1.0 - z) * n + z * h.to(f)
    return h_new.to(dt), c, torch.cat([r, z, n, hn], -1).to(dt)


def _cell_forward_operands(what, cell_type, gx, gh, bias, h, c, outs):
    """(B, H, LSTM, the operands as ``_on_cpu`` takes them) of a cell
    forward; raises on a cell, a shape or an operand it does not take."""
    B, H, G = _cell_dims(cell_type, h)
    lstm = cell_type == "LSTM"
    if lstm and (gh is not None or c is None):
        raise ValueError(f"{what} LSTM: gh must be None and c given")
    if not lstm and gh is None:
        raise ValueError(f"{what} GRU: gh must be given")
    operands = [("gx", gx, (B, G)), ("gh", gh, (B, G)), ("bias", bias, (G,)),
                ("h", h, (B, H)), ("c", c if lstm else None, (B, H)),
                ("h_out", outs[0], (B, H)),
                ("c_out", outs[1] if lstm else None, (B, H)),
                ("acts_out", outs[2], (B, 4 * H))]
    _check_shapes(what, operands)
    return B, H, lstm, operands


def _cell_forward_args(cell_type, gx, gh, bias, h, c, h_new, c_new, acts):
    """The ctypes arguments of ``recnet_cell_fwd`` but the stream."""
    lstm = cell_type == "LSTM"
    B, H = h.shape
    return (_DTYPE_CODES[gx.dtype], int(lstm), B, H, _ld(gx), _ld(gh),
            _ptr(gx), _ptr(gh), _ptr(bias), _ptr(h),
            _ptr(c if lstm else None), _ptr(h_new),
            _ptr(c_new if lstm else None), _ptr(acts))


def cell_forward(cell_type: str, gx: torch.Tensor, gh: OptT,
                 bias: torch.Tensor, h: torch.Tensor, c: OptT,
                 out: Optional[Sequence[OptT]] = None):
    """One step's cell from its gate products: LSTM ``gx = gi + h w_hh``
    (B, 4H), ``gh`` None, ``c`` (B, H); GRU ``gx = gi`` and ``gh = h w_hh``
    (B, 3H), ``c`` echoed. ``bias`` is b_hh. ``out`` = (h', c', acts).
    Returns (h', c', acts (B, 4H))."""
    outs = out or (None, None, None)
    B, H, lstm, operands = _cell_forward_operands(
        "cell_forward", cell_type, gx, gh, bias, h, c, outs)
    if _on_cpu("cell_forward", operands, ("gx", "gh")):
        made = cell_forward_reference(cell_type, gx, gh, bias, h, c)
        return _outputs((outs[0], outs[1] if lstm else None, outs[2]), made)
    h_new = _empty(out, 0, (B, H), h)
    c_new = _empty(out, 1, (B, H), h) if lstm else c
    acts = _empty(out, 2, (B, 4 * H), h)
    lib = _library()
    err = lib.recnet_cell_fwd(
        *_cell_forward_args(cell_type, gx, gh, bias, h, c, h_new, c_new,
                            acts), _stream(gx.device))
    _raise_on(lib, err, "cell_forward")
    _count(cell_forward, cell_type)
    return h_new, c_new, acts


cell_forward.n_launches = 0
cell_forward.cell_launches = collections.Counter()


# the cell forward kernel's probes: its first design ("scalar": one thread
# a (row, unit), scalar loads; the values the kernel is held to, bit for
# bit in f32), an empty kernel at that design's grid ("empty": the launch's
# floor) and the kernel's loads and stores with sums in place of the gates
# ("copy": what moving the cell's bytes costs)
CELL_FORWARD_PROBES = {"scalar": 1, "empty": 2, "copy": 3}


def cell_forward_probe_reference(probe: str, cell_type: str,
                                 gx: torch.Tensor, gh: OptT,
                                 bias: torch.Tensor, h: torch.Tensor,
                                 c: OptT):
    """Plain version of ``cell_forward_probe``: "scalar" is
    ``cell_forward_reference``; "copy" gives LSTM h' = c' = c, acts_k =
    gx_k + b_k, GRU h' = h, acts_k = gi_k + gh_k + b_k (k < 3) and acts_3 =
    gh_2 + b_2; "empty" None."""
    if probe not in CELL_FORWARD_PROBES:
        raise ValueError(f"no cell forward probe {probe!r}")
    if probe == "empty":
        return None
    if probe == "scalar":
        return cell_forward_reference(cell_type, gx, gh, bias, h, c)
    dt = gx.dtype
    f = _compute(dt)
    H = h.shape[-1]
    b = bias.to(f)
    if cell_type == "LSTM":
        return c, c, (gx.to(f) + b).to(dt)
    gates = gx.to(f) + gh.to(f) + b
    return h, c, torch.cat([gates, gh[:, 2 * H:].to(f) + b[2 * H:]],
                           -1).to(dt)


def cell_forward_probe(probe: str, cell_type: str, gx: torch.Tensor,
                       gh: OptT, bias: torch.Tensor, h: torch.Tensor,
                       c: OptT, out: Optional[Sequence[OptT]] = None):
    """A probe of the cell forward kernel (CELL_FORWARD_PROBES) on
    ``cell_forward``'s operands (``out`` as there). Returns (h', c', acts)
    as ``cell_forward_probe_reference`` gives them, None for "empty". Not
    counted as a launch of the kernel."""
    if probe not in CELL_FORWARD_PROBES:
        raise ValueError(f"no cell forward probe {probe!r}")
    what = f"cell_forward_probe {probe}"
    outs = out or (None, None, None)
    B, H, lstm, operands = _cell_forward_operands(
        what, cell_type, gx, gh, bias, h, c, outs)
    if _on_cpu(what, operands, ("gx", "gh")):
        made = cell_forward_probe_reference(probe, cell_type, gx, gh, bias,
                                            h, c)
        return made and _outputs((outs[0], outs[1] if lstm else None,
                                  outs[2]), made)
    h_new, acts = _empty(out, 0, (B, H), h), _empty(out, 2, (B, 4 * H), h)
    c_new = _empty(out, 1, (B, H), h) if lstm else c
    lib = _library()
    err = lib.recnet_cell_fwd_probe(
        CELL_FORWARD_PROBES[probe],
        *_cell_forward_args(cell_type, gx, gh, bias, h, c, h_new, c_new,
                            acts), _stream(gx.device))
    _raise_on(lib, err, what)
    return None if probe == "empty" else (h_new, c_new, acts)


def cell_backward_reference(cell_type: str, dh: torch.Tensor, dh_out: OptT,
                            dc: OptT, acts: torch.Tensor, h_prev: OptT,
                            c_prev: OptT, c_t: OptT):
    """Plain version of ``cell_backward``."""
    dt = dh.dtype
    f = _compute(dt)
    H = dh.shape[-1]
    d = dh.to(f) if dh_out is None else dh.to(f) + dh_out.to(f)
    a = acts.to(f)
    if cell_type == "LSTM":
        i, fg, g, o = (a[:, k * H:(k + 1) * H] for k in range(4))
        tc = torch.tanh(c_t.to(f))
        dcell = dc.to(f) + d * o * (1.0 - tc * tc)
        dgates = torch.cat([dcell * g * i * (1.0 - i),
                            dcell * c_prev.to(f) * fg * (1.0 - fg),
                            dcell * i * (1.0 - g * g),
                            d * tc * o * (1.0 - o)], -1).to(dt)
        return dgates, dgates, None, (dcell * fg).to(dt)
    r, z, n, hn = (a[:, k * H:(k + 1) * H] for k in range(4))
    dn = d * (1.0 - z) * (1.0 - n * n)
    dr = dn * hn * r * (1.0 - r)
    dz = d * (h_prev.to(f) - n) * z * (1.0 - z)
    return (torch.cat([dr, dz, dn], -1).to(dt),
            torch.cat([dr, dz, dn * r], -1).to(dt), (d * z).to(dt), dc)


def _cell_backward_operands(what, cell_type, dh, dh_out, dc, acts, h_prev,
                            c_prev, c_t, outs):
    """(B, H, G, LSTM, the operands as ``_on_cpu`` takes them) of a cell
    backward; raises on a cell, a shape or an operand it does not take."""
    B, H, G = _cell_dims(cell_type, dh)
    lstm = cell_type == "LSTM"
    if lstm and (dc is None or c_prev is None or c_t is None):
        raise ValueError(f"{what} LSTM: dc, c_prev and c_t needed")
    if not lstm and h_prev is None:
        raise ValueError(f"{what} GRU: h_prev needed")
    operands = [("dh", dh, (B, H)), ("dh_out", dh_out, (B, H)),
                ("dc", dc if lstm else None, (B, H)),
                ("acts", acts, (B, 4 * H)),
                ("h_prev", None if lstm else h_prev, (B, H)),
                ("c_prev", c_prev if lstm else None, (B, H)),
                ("c_t", c_t if lstm else None, (B, H)),
                ("dgi_out", outs[0], (B, G)),
                ("dgh_out", None if lstm else outs[1], (B, G)),
                ("dh_cell_out", None if lstm else outs[2], (B, H)),
                ("dc_out", outs[3] if lstm else None, (B, H))]
    _check_shapes(what, operands)
    return B, H, G, lstm, operands


def _cell_backward_args(cell_type, dh, dh_out, dc, acts, h_prev, c_prev,
                        c_t, dgi, dgh, dh_cell, dc_prev):
    """The ctypes arguments of ``recnet_cell_bwd`` but the stream."""
    lstm = cell_type == "LSTM"
    B, H = dh.shape
    return (_DTYPE_CODES[dh.dtype], int(lstm), B, H, _ld(dgi),
            _ld(None if lstm else dgh), _ptr(dh), _ptr(dh_out),
            _ptr(dc if lstm else None), _ptr(acts),
            _ptr(None if lstm else h_prev), _ptr(c_prev if lstm else None),
            _ptr(c_t if lstm else None), _ptr(dgi),
            _ptr(None if lstm else dgh), _ptr(dh_cell),
            _ptr(dc_prev if lstm else None))


def _cell_backward_outputs(out, lstm, B, H, G, dh, dc):
    """(dgi, dgh, dh_cell, dc_prev) to write: ``out``'s, else new."""
    dgi = _empty(out, 0, (B, G), dh)
    dgh = dgi if lstm else _empty(out, 1, (B, G), dh)
    dh_cell = None if lstm else _empty(out, 2, (B, H), dh)
    dc_prev = _empty(out, 3, (B, H), dh) if lstm else dc
    return dgi, dgh, dh_cell, dc_prev


def cell_backward(cell_type: str, dh: torch.Tensor, dh_out: OptT, dc: OptT,
                  acts: torch.Tensor, h_prev: OptT, c_prev: OptT, c_t: OptT,
                  out: Optional[Sequence[OptT]] = None):
    """Cotangents of one ``cell_forward`` step from ``dh`` (carried) +
    ``dh_out`` (the step's output cotangent, or None). LSTM takes ``dc``,
    ``c_prev`` and ``c_t``; GRU ``h_prev``. ``out`` = (dgi, dgh, dh_cell,
    dc_prev) (dgh, dh_cell ignored for LSTM). Returns (dgi, dgh, dh_cell,
    dc_prev)."""
    outs = out or (None, None, None, None)
    B, H, G, lstm, operands = _cell_backward_operands(
        "cell_backward", cell_type, dh, dh_out, dc, acts, h_prev, c_prev,
        c_t, outs)
    if _on_cpu("cell_backward", operands, ("dgi_out", "dgh_out")):
        made = cell_backward_reference(cell_type, dh, dh_out, dc, acts,
                                       h_prev, c_prev, c_t)
        if lstm:
            dgi, _, _, dcp = _outputs((outs[0], None, None, outs[3]), made)
            return dgi, dgi, None, dcp
        return _outputs((outs[0], outs[1], outs[2], None), made)
    made = _cell_backward_outputs(out, lstm, B, H, G, dh, dc)
    lib = _library()
    err = lib.recnet_cell_bwd(
        *_cell_backward_args(cell_type, dh, dh_out, dc, acts, h_prev, c_prev,
                             c_t, *made), _stream(dh.device))
    _raise_on(lib, err, "cell_backward")
    _count(cell_backward, cell_type)
    return made


cell_backward.n_launches = 0
cell_backward.cell_launches = collections.Counter()


# the cell backward kernel's probe: its first design ("scalar": one thread
# a (row, unit), scalar loads; the values the kernel is held to, bit for
# bit in f32)
CELL_BACKWARD_PROBES = {"scalar": 1}


def cell_backward_probe(probe: str, cell_type: str, dh: torch.Tensor,
                        dh_out: OptT, dc: OptT, acts: torch.Tensor,
                        h_prev: OptT, c_prev: OptT, c_t: OptT,
                        out: Optional[Sequence[OptT]] = None):
    """A probe of the cell backward kernel (CELL_BACKWARD_PROBES) on
    ``cell_backward``'s operands; returns what ``cell_backward`` returns,
    its outputs ``out``'s (as there) or new (LSTM's dc_prev too). On CPU
    tensors ``cell_backward``'s plain route. Not counted as a launch of
    the kernel."""
    if probe not in CELL_BACKWARD_PROBES:
        raise ValueError(f"no cell backward probe {probe!r}")
    what = f"cell_backward_probe {probe}"
    outs = out or (None, None, None, None)
    B, H, G, lstm, operands = _cell_backward_operands(
        what, cell_type, dh, dh_out, dc, acts, h_prev, c_prev, c_t, outs)
    if _on_cpu(what, operands, ("dgi_out", "dgh_out")):
        return cell_backward(cell_type, dh, dh_out, dc, acts, h_prev,
                             c_prev, c_t, out=out)
    made = _cell_backward_outputs(out, lstm, B, H, G, dh, dc)
    lib = _library()
    err = lib.recnet_cell_bwd_probe(
        CELL_BACKWARD_PROBES[probe],
        *_cell_backward_args(cell_type, dh, dh_out, dc, acts, h_prev, c_prev,
                             c_t, *made), _stream(dh.device))
    _raise_on(lib, err, what)
    return made


# --------------------------------------------------------------------------
# the decoder's attention
# --------------------------------------------------------------------------

def _attention_dims(wh_or_dwh, w, enc):
    """(B, A, F, E) from wh or dwh (B, A) and enc (B, F, E); w (A, 1) or
    (A,)."""
    if wh_or_dwh.dim() != 2 or enc.dim() != 3:
        raise ValueError(f"wh/dwh (B, A), enc (B, F, E) expected; got "
                         f"{tuple(wh_or_dwh.shape)}, {tuple(enc.shape)}")
    (B, A), (_, F, E) = wh_or_dwh.shape, enc.shape
    if min(B, A, F, E) < 1:
        raise ValueError(f"empty attention: B={B} A={A} F={F} E={E}")
    if tuple(w.shape) not in ((A, 1), (A,)):
        raise ValueError(f"w is {tuple(w.shape)}, expected ({A}, 1) or "
                         f"({A},)")
    return B, A, F, E


def attention_forward_reference(wh, uv, b, w, enc):
    """Plain version of ``attention_forward``."""
    dt = wh.dtype
    f = _compute(dt)
    act = torch.tanh(wh.to(f)[:, None, :] + uv.to(f) + b.to(f))
    scores = (act @ w.to(f).reshape(-1, 1))[..., 0].to(dt)
    ctx = torch.einsum("bf,bfe->be", scores.to(f), enc.to(f)) / enc.shape[1]
    return scores, ctx.to(dt)


def attention_forward(wh: torch.Tensor, uv: torch.Tensor, b: torch.Tensor,
                      w: torch.Tensor, enc: torch.Tensor,
                      out: Optional[Sequence[OptT]] = None):
    """wh = h W (B, A; contiguous rows), uv (B, F, A), b (A,), w (A, 1) or
    (A,), enc (B, F, E); ``out`` = (scores, ctx). Returns (scores (B, F),
    ctx (B, E))."""
    B, A, F, E = _attention_dims(wh, w, enc)
    outs = out or (None, None)
    operands = [("wh", wh, (B, A)), ("uv", uv, (B, F, A)), ("b", b, (A,)),
                ("w", w, tuple(w.shape)), ("enc", enc, (B, F, E)),
                ("scores_out", outs[0], (B, F)), ("ctx_out", outs[1], (B, E))]
    _check_shapes("attention_forward", operands)
    if _on_cpu("attention_forward", operands, ("wh",)):
        return _outputs(outs, attention_forward_reference(wh, uv, b, w, enc))
    lib = _library()
    code = _DTYPE_CODES[wh.dtype]
    _check_smem("attention_forward", lib.recnet_attn_fwd_smem(code, F, E),
                f"F={F}, E={E}")
    scores = _empty(out, 0, (B, F), wh)
    ctx = _empty(out, 1, (B, E), wh)
    err = lib.recnet_attn_fwd(
        code, B, F, A, E, _ld(wh), _ptr(wh), _ptr(uv), _ptr(b), _ptr(w),
        _ptr(enc), _ptr(scores), _ptr(ctx), _stream(wh.device))
    _raise_on(lib, err, "attention_forward")
    _count(attention_forward)
    return scores, ctx


attention_forward.n_launches = 0


def attention_backward_reference(dctx, enc, act, w):
    """Plain version of ``attention_backward``."""
    dt = dctx.dtype
    f = _compute(dt)
    F = enc.shape[1]
    dscores = (torch.einsum("be,bfe->bf", dctx.to(f), enc.to(f)) / F).to(dt)
    a = act.to(f)
    dwh = (torch.einsum("bf,bfa->ba", dscores.to(f), 1.0 - a * a)
           * w.to(f).reshape(-1)).to(dt)
    return dscores, dwh


def attention_backward(dctx: torch.Tensor, enc: torch.Tensor,
                       act: torch.Tensor, w: torch.Tensor,
                       out: Optional[Sequence[OptT]] = None):
    """dctx (B, E), enc (B, F, E), act (B, F, A), w (A, 1) or (A,);
    ``out`` = (dscores, dwh), dwh's rows contiguous. Returns (dscores
    (B, F), dwh (B, A))."""
    if act.dim() != 3:
        raise ValueError(f"act (B, F, A) expected; got {tuple(act.shape)}")
    B, A, F, E = _attention_dims(act[:, 0], w, enc)
    outs = out or (None, None)
    operands = [("dctx", dctx, (B, E)), ("enc", enc, (B, F, E)),
                ("act", act, (B, F, A)), ("w", w, tuple(w.shape)),
                ("dscores_out", outs[0], (B, F)), ("dwh_out", outs[1], (B, A))]
    _check_shapes("attention_backward", operands)
    if _on_cpu("attention_backward", operands, ("dwh_out",)):
        return _outputs(outs, attention_backward_reference(dctx, enc, act,
                                                           w))
    lib = _library()
    code = _DTYPE_CODES[dctx.dtype]
    _check_smem("attention_backward",
                lib.recnet_attn_bwd_smem(code, F, A, E),
                f"F={F}, A={A}, E={E}")
    dscores = _empty(out, 0, (B, F), dctx)
    dwh = _empty(out, 1, (B, A), dctx)
    err = lib.recnet_attn_bwd(
        code, B, F, A, E, _ld(dwh), _ptr(dctx), _ptr(enc), _ptr(act),
        _ptr(w), _ptr(dscores), _ptr(dwh), _stream(dctx.device))
    _raise_on(lib, err, "attention_backward")
    _count(attention_backward)
    return dscores, dwh


attention_backward.n_launches = 0


# the attention kernels' split probes, each without one part of its
# kernel's work: the forward without its scores (scores, and so ctx,
# zeros) or without ctx (zeros); the backward without dscores (dscores,
# and so dwh, zeros) or without dwh (zeros)
FORWARD_PROBES = {"scores": 1, "ctx": 2}
BACKWARD_PROBES = {"dscores": 1, "dwh": 2}


def attention_probe_reference(kind: str, probe: str, *operands):
    """Plain version of ``attention_probe``."""
    forward = kind == "forward"
    if probe not in (FORWARD_PROBES if forward else BACKWARD_PROBES):
        raise ValueError(f"no {kind} probe {probe!r}")
    first, second = (attention_forward_reference(*operands) if forward else
                     attention_backward_reference(*operands))
    if probe in ("scores", "dscores"):
        first = torch.zeros_like(first)
    return first, torch.zeros_like(second)


def attention_probe(kind: str, probe: str, *operands):
    """A split probe of the attention kernels: ``kind`` "forward" with
    the operands of ``attention_forward``, or "backward" with those of
    ``attention_backward``; ``probe`` one of FORWARD_PROBES or
    BACKWARD_PROBES. Returns what that wrapper returns, with the dropped
    part's values zero. Not counted as a launch of the kernel."""
    forward = kind == "forward"
    codes = FORWARD_PROBES if forward else BACKWARD_PROBES
    if probe not in codes:
        raise ValueError(f"no {kind} probe {probe!r}")
    if forward:
        names = ("wh", "uv", "b", "w", "enc")
        wh, _, _, w, enc = operands
        B, A, F, E = _attention_dims(wh, w, enc)
    else:
        names = ("dctx", "enc", "act", "w")
        _, enc, act, w = operands
        B, A, F, E = _attention_dims(act[:, 0], w, enc)
    what = f"attention_probe {kind}"
    if _on_cpu(what, [(n, x, None) for n, x in zip(names, operands)],
               ("wh",)):
        return attention_probe_reference(kind, probe, *operands)
    lib = _library()
    first = operands[0]
    code = _DTYPE_CODES[first.dtype]
    outs = (first.new_empty((B, F)),
            first.new_empty((B, E) if forward else (B, A)))
    entry = lib.recnet_attn_fwd_probe if forward else lib.recnet_attn_bwd_probe
    err = entry(codes[probe], code, B, F, A, E,
                _ld(first) if forward else A, *map(_ptr, operands),
                *map(_ptr, outs), _stream(first.device))
    _raise_on(lib, err, f"{what} {probe}")
    return outs


# --------------------------------------------------------------------------
# a rollout's steps: the operands checked once, each step's arguments made
# once
# --------------------------------------------------------------------------

def _rows(x: OptT, T: int):
    """Pointers to x[0], ..., x[T - 1] ((T, ...); every x[t] one buffer
    when x's first stride is 0); T nulls for None."""
    if x is None:
        return [ctypes.c_void_p(None)] * T
    step = x.stride(0) * x.element_size()
    return [ctypes.c_void_p(x.data_ptr() + t * step) for t in range(T)]


def _same(x: OptT, T: int):
    return [_ptr(x)] * T


def _after(x0: OptT, xs: OptT, T: int):
    """Step t's previous state: x0 at t = 0, else xs[t - 1]."""
    return [_ptr(x0)] + _rows(xs, T)[:T - 1]


def _steps(fn, what: str, entry, head, columns, device, T: int,
           operands, cell_type: Optional[str] = None):
    """``launch(t)``: ``entry(*head, column[t] for each column, stream)``
    on the stream current now, counted as ``fn``. ``launch`` holds
    ``operands``, the tensors whose pointers the columns carry, so that
    the allocator lends none of their memory to other tensors while the
    launch can still be called."""
    lib = _library()
    stream = _stream(device)
    args = [tuple(head) + tuple(col[t] for col in columns) + (stream,)
            for t in range(T)]
    held = tuple(t for _, t, _ in operands if t is not None)

    def launch(t: int) -> None:
        _raise_on(lib, entry(*args[t]), what)
        _count(fn, cell_type)

    launch.operands = held
    return launch


def cell_forward_steps(cell_type: str, gx: torch.Tensor, gh: OptT,
                       bias: torch.Tensor, h0: torch.Tensor, c0: OptT,
                       hs: torch.Tensor, cs: OptT, acts: torch.Tensor):
    """``cell_forward`` over a rollout's T steps; returns ``launch(t)``.
    Step t reads gx[t] (T, B, G), GRU's gh[t] (T, B, G), bias and the
    state after step t - 1 (h0, c0 at t = 0, else hs[t - 1], cs[t - 1])
    and writes hs[t], cs[t] (LSTM) and acts[t]. gx and gh need only
    contiguous rows; the caller fills gx[t] and gh[t] before step t.
    Every operand is checked here, once; on CPU tensors ``launch`` runs
    ``cell_forward`` on the step's views."""
    T, B = gx.shape[:2]
    _, H, G = _cell_dims(cell_type, h0)
    lstm = cell_type == "LSTM"
    if lstm != (gh is None) or lstm != (c0 is not None) \
            or lstm != (cs is not None):
        raise ValueError("cell_forward_steps: LSTM takes c0 and cs, GRU gh")
    operands = [("gx", gx, (T, B, G)), ("gh", gh, (T, B, G)),
                ("bias", bias, (G,)), ("h0", h0, (B, H)), ("c0", c0, (B, H)),
                ("hs", hs, (T, B, H)), ("cs", cs, (T, B, H)),
                ("acts", acts, (T, B, 4 * H))]
    _check_shapes("cell_forward_steps", operands)
    if _on_cpu("cell_forward_steps", operands, ("gx", "gh")):
        def launch(t: int) -> None:
            h, c = (h0, c0) if t == 0 else (hs[t - 1],
                                            cs[t - 1] if lstm else None)
            cell_forward(cell_type, gx[t], None if lstm else gh[t], bias, h,
                         c, out=(hs[t], cs[t] if lstm else None, acts[t]))
        return launch
    lib = _library()
    return _steps(cell_forward, "cell_forward", lib.recnet_cell_fwd,
                  (_DTYPE_CODES[gx.dtype], int(lstm), B, H, _ld(gx),
                   _ld(gh)),
                  (_rows(gx, T), _rows(gh, T), _same(bias, T),
                   _after(None if lstm else h0, None if lstm else hs, T),
                   _after(c0, cs, T), _rows(hs, T), _rows(cs, T),
                   _rows(acts, T)), gx.device, T, operands, cell_type)


def cell_backward_steps(cell_type: str, dh: torch.Tensor,
                        dhs: torch.Tensor, dc: OptT, acts: torch.Tensor,
                        h_prev: OptT, c_prev: OptT, cs: OptT,
                        dgi: torch.Tensor, dgh: OptT):
    """``cell_backward`` over a rollout's T steps; returns ``launch(t)``.
    Step t reads the carries ``dh`` (B, H) and (LSTM) ``dc``, dhs[t],
    acts[t] and GRU's h_prev[t] or LSTM's c_prev[t] and cs[t]; it writes
    dgi[t], GRU's dgh[t] and its dh z into ``dh``, LSTM's dc f into ``dc``
    (both in place; the LSTM's dh is the caller's to set, dgi[t] w_hh^T).
    dgi and dgh need only contiguous rows. Checked once; on CPU tensors
    ``launch`` runs ``cell_backward``."""
    T, B = dhs.shape[:2]
    _, H, G = _cell_dims(cell_type, dh)
    lstm = cell_type == "LSTM"
    if lstm and (dc is None or c_prev is None or cs is None):
        raise ValueError("cell_backward_steps LSTM: dc, c_prev and cs "
                         "needed")
    if not lstm and (h_prev is None or dgh is None):
        raise ValueError("cell_backward_steps GRU: h_prev and dgh needed")
    operands = [("dh", dh, (B, H)), ("dhs", dhs, (T, B, H)),
                ("dc", dc if lstm else None, (B, H)),
                ("acts", acts, (T, B, 4 * H)),
                ("h_prev", None if lstm else h_prev, (T, B, H)),
                ("c_prev", c_prev if lstm else None, (T, B, H)),
                ("cs", cs if lstm else None, (T, B, H)),
                ("dgi", dgi, (T, B, G)),
                ("dgh", None if lstm else dgh, (T, B, G))]
    _check_shapes("cell_backward_steps", operands)
    if _on_cpu("cell_backward_steps", operands, ("dgi", "dgh")):
        def launch(t: int) -> None:
            cell_backward(cell_type, dh, dhs[t], dc if lstm else None,
                          acts[t], None if lstm else h_prev[t],
                          c_prev[t] if lstm else None,
                          cs[t] if lstm else None,
                          out=(dgi[t], None if lstm else dgh[t],
                               None if lstm else dh, dc if lstm else None))
        return launch
    lib = _library()
    return _steps(cell_backward, "cell_backward", lib.recnet_cell_bwd,
                  (_DTYPE_CODES[dh.dtype], int(lstm), B, H, _ld(dgi),
                   _ld(None if lstm else dgh)),
                  (_same(dh, T), _rows(dhs, T), _same(dc if lstm else None,
                                                      T),
                   _rows(acts, T), _rows(None if lstm else h_prev, T),
                   _rows(c_prev if lstm else None, T),
                   _rows(cs if lstm else None, T), _rows(dgi, T),
                   _rows(None if lstm else dgh, T),
                   _same(None if lstm else dh, T),
                   _same(dc if lstm else None, T)), dh.device, T, operands,
                  cell_type)


def attention_forward_steps(whs: torch.Tensor, uv: torch.Tensor,
                            b: torch.Tensor, w: torch.Tensor,
                            enc: torch.Tensor, scores: torch.Tensor,
                            ctxs: torch.Tensor):
    """``attention_forward`` over a rollout's T steps; returns
    ``launch(t)``: step t reads whs[t] (T, B, A; contiguous rows, filled
    by the caller before the step) and writes scores[t] (T, B, F) and
    ctxs[t] (T, B, E). Checked once; on CPU tensors ``launch`` runs
    ``attention_forward``."""
    if whs.dim() != 3:
        raise ValueError(f"whs (T, B, A) expected; got {tuple(whs.shape)}")
    T = whs.shape[0]
    B, A, F, E = _attention_dims(whs[0], w, enc)
    operands = [("whs", whs, (T, B, A)), ("uv", uv, (B, F, A)),
                ("b", b, (A,)), ("w", w, tuple(w.shape)),
                ("enc", enc, (B, F, E)), ("scores", scores, (T, B, F)),
                ("ctxs", ctxs, (T, B, E))]
    _check_shapes("attention_forward_steps", operands)
    if _on_cpu("attention_forward_steps", operands, ("whs",)):
        def launch(t: int) -> None:
            attention_forward(whs[t], uv, b, w, enc,
                              out=(scores[t], ctxs[t]))
        return launch
    lib = _library()
    code = _DTYPE_CODES[whs.dtype]
    _check_smem("attention_forward", lib.recnet_attn_fwd_smem(code, F, E),
                f"F={F}, E={E}")
    return _steps(attention_forward, "attention_forward", lib.recnet_attn_fwd,
                  (code, B, F, A, E, _ld(whs)),
                  (_rows(whs, T), _same(uv, T), _same(b, T), _same(w, T),
                   _same(enc, T), _rows(scores, T), _rows(ctxs, T)),
                  whs.device, T, operands)


def attention_backward_steps(dctx: torch.Tensor, enc: torch.Tensor,
                             act: torch.Tensor, w: torch.Tensor,
                             dscores: torch.Tensor, dwhs: torch.Tensor):
    """``attention_backward`` over a rollout's T steps; returns
    ``launch(t)``: step t reads dctx[t] (T, B, E) and act[t] (T, B, F, A)
    and writes dscores[t] and dwhs[t] (T, B, A; contiguous rows). Checked
    once; on CPU tensors ``launch`` runs ``attention_backward``."""
    if act.dim() != 4:
        raise ValueError(f"act (T, B, F, A) expected; got "
                         f"{tuple(act.shape)}")
    T = dctx.shape[0]
    B, A, F, E = _attention_dims(act[0, :, 0], w, enc)
    operands = [("dctx", dctx, (T, B, E)), ("enc", enc, (B, F, E)),
                ("act", act, (T, B, F, A)), ("w", w, tuple(w.shape)),
                ("dscores", dscores, (T, B, F)), ("dwhs", dwhs, (T, B, A))]
    _check_shapes("attention_backward_steps", operands)
    if _on_cpu("attention_backward_steps", operands, ("dwhs",)):
        def launch(t: int) -> None:
            attention_backward(dctx[t], enc, act[t], w,
                               out=(dscores[t], dwhs[t]))
        return launch
    lib = _library()
    code = _DTYPE_CODES[dctx.dtype]
    _check_smem("attention_backward",
                lib.recnet_attn_bwd_smem(code, F, A, E),
                f"F={F}, A={A}, E={E}")
    return _steps(attention_backward, "attention_backward",
                  lib.recnet_attn_bwd, (code, B, F, A, E, _ld(dwhs)),
                  (_rows(dctx, T), _same(enc, T), _rows(act, T), _same(w, T),
                   _rows(dscores, T), _rows(dwhs, T)), dctx.device, T,
                  operands)


# --------------------------------------------------------------------------
# the cell's whole rollout: one launch a direction
# --------------------------------------------------------------------------

# a launch's shape (rollout_plan); the first eight go to the kernel
_PLAN_FIELDS = ("cluster", "clusters", "units", "rows", "k_slice",
                "pass_rows", "stages", "smem", "capacity", "smem_limit")
_KERNEL_FIELDS = 8
ROLLOUT_CLUSTER = {True: 2, False: 8}   # blocks a cluster: forward, backward
_KC = 64                      # the k slice's granule (cell_rollout.cu)
# both bodies (cell_rollout_wgmma_kernel, cell_rollout_tf32_kernel): the
# wgmma widths NW (product rows a block), batch rows a pass (a stage's
# rows), (unit, row) pairs a block in a pass, the tiles' alignment
ROLLOUT_WIDTHS = (32, 64, 96, 104)
ROLLOUT_PASS_ROWS = 104
ROLLOUT_MAX_PAIRS = 6 * 256
_ALIGN = 1024
_READY = 128                  # the readiness scan's bytes (k slice <= 4096)
# the bf16 body: its ring's stages (as many as fit)
ROLLOUT_STAGES = (3, 8)
# the f32 body: its slots (a 32-k chunk's split weight tiles, its staged
# rows and an mbarrier), a staged row's floats
ROLLOUT_F32_SLOTS = 5
_F32_PITCH = 36
# which product sources may be copied in 16-byte pieces (cell_rollout.cu)
_VEC_H0, _VEC_HS, _VEC_DG, _VEC_ACTS, _VEC_W = 1, 2, 4, 8, 16
# the split probes: without the staging and the product (P = 0), without
# the waits for other blocks and the cluster's sum, or without the
# products' MMAs (the staging kept; P = 0)
ROLLOUT_PROBES = {"product": 1, "exchange": 2, "mma": 4}
_plans: dict = {}
_devices: dict = {}
_scratches: dict = {}
_images: dict = {}


def _cell_rollout_library() -> ctypes.CDLL:
    lib = build.load("cell_rollout")
    if getattr(lib, "_recnet_bound", False):
        return lib
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.recnet_cell_rollout_device.argtypes = [p]
    lib.recnet_cell_rollout_capacity.argtypes = [i] * 6 + [p]
    lib.recnet_cell_rollout_fwd.argtypes = [i, i, p] + [i] * 5 + [u] + [p] * 11
    lib.recnet_cell_rollout_bwd.argtypes = [i, i, p] + [i] * 5 + [u] + [p] * 16
    for fn in (lib.recnet_cell_rollout_device,
               lib.recnet_cell_rollout_capacity, lib.recnet_cell_rollout_fwd,
               lib.recnet_cell_rollout_bwd):
        fn.restype = i
    lib.recnet_cell_rollout_error_string.argtypes = [i]
    lib.recnet_cell_rollout_error_string.restype = ctypes.c_char_p
    lib._recnet_bound = True
    return lib


def _rollout_dims(what: str, cell_type: str, x: torch.Tensor, h0):
    """(T, B, H, G) from x (T, B, .) and h0 (B, H)."""
    if cell_type not in _CELLS:
        raise ValueError(f"Unknown cell type: {cell_type}")
    if x.dim() != 3 or h0.dim() != 2:
        raise ValueError(f"{what}: (T, B, .) and h0 (B, H) expected; got "
                         f"{tuple(x.shape)} and {tuple(h0.shape)}")
    (T, B), H = x.shape[:2], h0.shape[1]
    if min(T, B, H) < 1:
        raise ValueError(f"{what}: empty rollout T={T}, B={B}, H={H}")
    return T, B, H, (4 if cell_type == "LSTM" else 3) * H


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil(a, b) * b


def rollout_shape(cell_type: str, forward: bool, dtype: torch.dtype, B: int,
                  H: int, sms: int, smem_limit: int, clusters: int = 0,
                  cap: int = 0) -> dict:
    """The shape of a whole-rollout launch on a card of ``sms`` SMs and
    ``smem_limit`` bytes of shared memory a block, before the card's
    capacity is asked: the direction's cluster size, the clusters (as many
    as H needs over ``cap`` clusters, or sms / cluster; ``clusters`` where
    given), units a block, product rows a block (the wgmma width NW), the
    k slice, batch rows a pass, the ring's stages and the shared memory a
    block: 1024 bytes of alignment, the ring, the readiness scan's bytes
    and the block's b_hh. bf16: a stage is a 64-k tile of the pass's rows
    (as many as fit, up to 8; at least the partials' bytes), beside the
    rows a warpgroup's tile reads past its last stage and the held slice of
    W_hh. f32: 5 slots, each a 32-k chunk's split weight tiles (a hi and a
    lo tile of NW rows of 128 bytes), its rows (36 floats each) and an
    mbarrier; the partials lie over the slots' rows. "images": the bytes
    of the f32 launch's weight tile images in device memory (0 in bf16)."""
    n_g = 4 if cell_type == "LSTM" else 3
    C = ROLLOUT_CLUSTER[forward]
    kc = _round_up(_ceil(H if forward else n_g * H, C), _KC)
    ub = _ceil(H, C * (clusters or cap or max(sms // C, 1)))
    NB = clusters or _ceil(H, C * ub)
    rows = (n_g if forward else 1) * C * ub
    NW = min((w for w in ROLLOUT_WIDTHS if w >= rows),
             default=_round_up(rows, 8))
    Bp = min(_round_up(B, 8), ROLLOUT_PASS_ROWS,
             ROLLOUT_MAX_PAIRS // ub // 8 * 8)
    partials = min(B, Bp) * _round_up(NW, 32) * 4
    if dtype == torch.bfloat16:
        stage, w = max(Bp, 8) * 128, NW * kc * 2
        tail = ((128 if Bp > 64 else 64) - Bp) * 128
        lo, hi = ROLLOUT_STAGES
        fixed = _ALIGN + tail + w + _READY + ub * 16
        stages = max(min((smem_limit - fixed) // stage, hi), lo,
                     _ceil(partials, stage))
    else:
        # a slot: a hi and a lo tile of NW rows of 128 bytes, the rows, an
        # mbarrier
        stage = 2 * NW * 128 + max(Bp, 8) * _F32_PITCH * 4 + 8
        fixed = _ALIGN + _READY + ub * 16
        stages = ROLLOUT_F32_SLOTS
    # f32: the blocks' tile images of W_hh in device memory, a hi and a lo
    # tile a 32-k chunk of the slice
    images = (0 if dtype == torch.bfloat16
              else C * NB * (kc // 32) * 2 * NW * 128)
    return {"cluster": C, "clusters": NB, "units": ub, "rows": NW,
            "k_slice": kc, "pass_rows": Bp, "stages": stages,
            "smem": fixed + stages * stage, "images": images}


def _device_info(device: torch.device):
    """(SMs, shared-memory limit a block, readiness words a scratch)."""
    if device not in _devices:
        lib = _cell_rollout_library()
        raw = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            _raise_on(lib, lib.recnet_cell_rollout_device(raw),
                      "cell_rollout device query")
        _devices[device] = tuple(raw)
    return _devices[device]


def _capacity(plan: dict, cell_type, forward, dtype, device) -> int:
    if plan["smem"] > plan["smem_limit"] or \
            plan["rows"] not in ROLLOUT_WIDTHS:
        return 0
    lib = _cell_rollout_library()
    cap = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.recnet_cell_rollout_capacity(
            _DTYPE_CODES[dtype], int(cell_type == "LSTM"), int(forward),
            plan["rows"], plan["cluster"], plan["smem"], ctypes.byref(cap))
    _raise_on(lib, err, "cell_rollout capacity query")
    return cap.value


def _plan(cell_type: str, forward: bool, dtype: torch.dtype, B: int,
          H: int, device: torch.device, clusters: int):
    """``rollout_plan``'s plan and ctypes array, made once a key; checked
    by no one here."""
    key = (cell_type, forward, dtype, B, H, device, clusters)
    if key not in _plans:
        sms, limit, words = _device_info(device)
        plan = rollout_shape(cell_type, forward, dtype, B, H, sms, limit,
                             clusters)
        plan.update(smem_limit=limit, capacity=_capacity(
            {**plan, "smem_limit": limit}, cell_type, forward, dtype,
            device))
        if not clusters and 0 < plan["capacity"] < plan["clusters"]:
            plan = {**rollout_shape(cell_type, forward, dtype, B, H, sms,
                                    limit, cap=plan["capacity"]),
                    "smem_limit": limit}
            plan["capacity"] = _capacity(plan, cell_type, forward, dtype,
                                         device)
        plan["words"] = words
        raw = (ctypes.c_int * _KERNEL_FIELDS)(
            *(plan[f] for f in _PLAN_FIELDS[:_KERNEL_FIELDS]))
        _plans[key] = (plan, raw)
    return _plans[key]


def rollout_refusal(plan: dict, what: str = "cell_rollout",
                    widths: str = "these widths", device="the card"):
    """The error a launch of ``plan`` (``rollout_shape``'s fields with
    "smem_limit", "capacity" and "words") meets, or None where the card
    holds it: a ValueError on widths a block cannot hold, a RuntimeError
    on a grid the card cannot hold at once (a persistent launch that is
    not co-resident would never finish). Pure Python."""
    if plan["rows"] > ROLLOUT_WIDTHS[-1]:
        return ValueError(f"{what}: {widths} give a block {plan['rows']} "
                          f"product rows, more than {ROLLOUT_WIDTHS[-1]}")
    if plan["pass_rows"] < 8 or \
            plan["units"] * plan["pass_rows"] > ROLLOUT_MAX_PAIRS:
        return ValueError(f"{what}: {widths} give a block {plan['units']} "
                          f"units a pass of at least 8 rows, more than "
                          f"{ROLLOUT_MAX_PAIRS} pairs")
    if plan["k_slice"] > 32 * _READY:
        return ValueError(f"{what}: {widths} give a block a k slice of "
                          f"{plan['k_slice']}, more than {32 * _READY}")
    if plan["smem"] > plan["smem_limit"]:
        return ValueError(f"{what}: {widths} need {plan['smem']} bytes of "
                          f"shared memory a block, more than the card's "
                          f"{plan['smem_limit']}")
    if plan["clusters"] > plan["capacity"]:
        return RuntimeError(f"{what}: {plan['clusters']} clusters of "
                            f"{plan['cluster']} blocks cannot be co-resident "
                            f"on {device} (it holds {plan['capacity']} at "
                            f"once); a persistent rollout needs every block "
                            f"resident")
    if plan["clusters"] * plan["cluster"] > plan["words"]:
        return ValueError(f"{what}: {widths} take more than {plan['words']} "
                          f"blocks")
    return None


def rollout_plan(cell_type: str, forward: bool, dtype: torch.dtype, B: int,
                 H: int, device, clusters: int = 0):
    """The shape of a whole-rollout launch on ``device`` (``rollout_shape``
    at the card's SM count and shared-memory limit, with fewer clusters and
    more units a block where the card holds fewer clusters at once), with
    "capacity": the clusters the card holds at once and "smem_limit"; and
    the ctypes array the launch takes. ``clusters`` (0: as many as H needs,
    spread over the card) is for tests. Raises ``rollout_refusal``'s error
    where the card cannot hold the launch."""
    device = torch.device(device)
    plan, raw = _plan(cell_type, forward, dtype, B, H, device, clusters)
    err = rollout_refusal(
        plan, f"cell_rollout_{'forward' if forward else 'backward'}",
        f"{cell_type} H={H}, B={B}, {dtype}", device)
    if err is not None:
        raise err
    return plan, raw


def rollout_holds(cell_type: str, dtype: torch.dtype, B: int, H: int,
                  device) -> bool:
    """Whether ``device`` holds both directions' whole-rollout launches of
    a (B, H) rollout: ``rollout_refusal`` finds nothing in either plan.
    ``ops.rnn``'s route rule, asked before a launch. On the H100 (132 SMs,
    clusters of 8 backward, 15 of them at once) the LSTM's backward holds
    H up to 15 x 8 x 13 = 1560: 13 units a block are its 104 product
    rows."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"cell_rollout: {dtype}; the kernels take "
                         f"{sorted(map(str, _DTYPE_CODES))}")
    device = torch.device(device)
    return all(rollout_refusal(_plan(cell_type, forward, dtype, B, H,
                                     device, 0)[0]) is None
               for forward in (True, False))


def _scratch(device: torch.device, steps: int):
    """The scratch of a launch of ``steps`` steps on the current stream of
    ``device`` (launches on one stream run in turn) and its readiness base:
    a readiness word a block, which a launch leaves at most base + steps.
    The base advances past that each launch, so that no word is reset
    between launches; the words are zeroed only before the base would
    wrap."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    if key not in _scratches:
        words = _device_info(device)[2]
        _scratches[key] = [torch.zeros(words, dtype=torch.int32,
                                       device=device), 0]
    entry = _scratches[key]
    if entry[1] + steps + 1 >= 2 ** 31:
        entry[0].zero_()
        entry[1] = 0
    base = entry[1]
    entry[1] += steps + 1
    return entry[0], base


def _images_buffer(device: torch.device, nbytes: int) -> torch.Tensor:
    """At least ``nbytes`` of device memory for an f32 launch's weight tile
    images on the current stream of ``device`` (launches on one stream run
    in turn), kept and grown as launches need; an empty tensor for 0."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _images.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _images[key] = torch.empty(nbytes, dtype=torch.uint8,
                                         device=device)
    return buf


def _vec(t: OptT, bit: int, width: Optional[int] = None) -> int:
    """``bit`` where t's rows (of ``width`` items, its last axis by default)
    may be copied in 16-byte pieces."""
    if t is None:
        return 0
    width = t.shape[-1] if width is None else width
    return bit if (t.data_ptr() % 16 == 0
                   and width * t.element_size() % 16 == 0) else 0


def cell_rollout_forward_reference(cell_type: str, gi_all: torch.Tensor,
                                   w_hh: torch.Tensor, b_hh: torch.Tensor,
                                   h0: torch.Tensor, c0: OptT,
                                   states: Optional[Sequence[OptT]] = None,
                                   matmul=torch.matmul):
    """Plain version of ``cell_rollout_forward``: the step loop, each
    product ``h w_hh`` in float32 (float64) over stored values, LSTM's
    gates rounded to the operands' dtype after ``gi +``, GRU's gh after the
    product, as the per-step route's cuBLAS products store them. With
    ``states`` = (hs, cs) given, step t starts from hs[t - 1], cs[t - 1]
    (h0, c0 at t = 0) in place of its own: each step from another run's
    state. ``matmul`` computes the products (the f32 kernel's three TF32
    terms: ``whole_decode.matmul_3xtf32_reference``)."""
    dt = gi_all.dtype
    w = w_hh.to(_compute(dt))
    lstm = cell_type == "LSTM"
    h, c, hs, cs, acts = h0, c0, [], [], []
    for t, gi in enumerate(gi_all):
        if states is not None and t > 0:
            h, c = states[0][t - 1], states[1][t - 1] if lstm else None
        p = matmul(h.to(w.dtype), w)
        if lstm:
            h, c, a = cell_forward_reference(
                cell_type, (gi.to(w.dtype) + p).to(dt), None, b_hh, h, c)
            cs.append(c)
        else:
            h, _, a = cell_forward_reference(cell_type, gi, p.to(dt), b_hh,
                                             h, None)
        hs.append(h)
        acts.append(a)
    return (torch.stack(hs), torch.stack(cs) if lstm else None,
            torch.stack(acts))


def cell_rollout_backward_reference(cell_type: str, dhs: torch.Tensor,
                                    acts: torch.Tensor, w_hh: torch.Tensor,
                                    h0: torch.Tensor, hs: OptT, c0: OptT,
                                    cs: OptT,
                                    steps_out: Optional[Sequence[OptT]] = None,
                                    carries: Optional[Sequence[OptT]] = None,
                                    matmul=torch.matmul):
    """Plain version of ``cell_rollout_backward``: the reversed step loop,
    each product ``dgates w_hh^T`` in float32 (float64), dh rounded to the
    operands' dtype after it (GRU: after adding the cell's dh z).
    ``steps_out`` = (dh_steps, dc_steps) as for the wrapper; with
    ``carries`` = (dh_steps, dc_steps) given, step t takes its carries from
    them in place of its own (each step from another run's carries).
    ``matmul`` computes the products, as for the forward."""
    dt = dhs.dtype
    w_t = w_hh.to(_compute(dt)).t()
    lstm = cell_type == "LSTM"
    T = dhs.shape[0]
    dh = torch.zeros_like(h0)
    dc = torch.zeros_like(h0) if lstm else None
    dgi, dgh = [None] * T, [None] * T
    for t in reversed(range(T)):
        if steps_out is not None:
            steps_out[0][t].copy_(dh)
            if lstm:
                steps_out[1][t].copy_(dc)
        if carries is not None:
            dh, dc = carries[0][t], carries[1][t] if lstm else None
        gi_t, gh_t, dh_cell, dc = cell_backward_reference(
            cell_type, dh, dhs[t], dc, acts[t],
            None if lstm else (h0 if t == 0 else hs[t - 1]),
            (c0 if t == 0 else cs[t - 1]) if lstm else None,
            cs[t] if lstm else None)
        p = matmul(gh_t.to(w_t.dtype), w_t)
        dh = p.to(dt) if lstm else (dh_cell.to(w_t.dtype) + p).to(dt)
        dgi[t], dgh[t] = gi_t, gh_t
    dgi = torch.stack(dgi)
    return dgi, dgi if lstm else torch.stack(dgh), dh, dc


def _forward_operands(cell_type, gi_all, w_hh, b_hh, h0, c0, outs):
    T, B, H, G = _rollout_dims("cell_rollout_forward", cell_type, gi_all, h0)
    lstm = cell_type == "LSTM"
    if lstm != (c0 is not None):
        raise ValueError("cell_rollout_forward: LSTM takes c0, GRU none")
    return (T, B, H, G), [
        ("gi_all", gi_all, (T, B, G)), ("w_hh", w_hh, (H, G)),
        ("b_hh", b_hh, (G,)), ("h0", h0, (B, H)), ("c0", c0, (B, H)),
        ("hs_out", outs[0], (T, B, H)),
        ("cs_out", outs[1] if lstm else None, (T, B, H)),
        ("acts_out", outs[2], (T, B, 4 * H))]


def _launch_forward(cell_type, gi_all, w_hh, b_hh, h0, c0, hs, cs, acts,
                    clusters, probe):
    T, B, H = gi_all.shape[0], gi_all.shape[1], h0.shape[1]
    lstm = cell_type == "LSTM"
    plan, raw = rollout_plan(cell_type, True, gi_all.dtype, B, H,
                             gi_all.device, clusters)
    lib = _cell_rollout_library()
    scratch, base = _scratch(gi_all.device, T)
    images = _images_buffer(gi_all.device, plan["images"])
    err = lib.recnet_cell_rollout_fwd(
        _DTYPE_CODES[gi_all.dtype], int(lstm), raw, T, B, H, probe,
        _vec(h0, _VEC_H0) | _vec(hs, _VEC_HS) | _vec(w_hh, _VEC_W, H), base,
        _ptr(gi_all), _ptr(w_hh),
        _ptr(b_hh), _ptr(h0), _ptr(c0), _ptr(hs), _ptr(cs), _ptr(acts),
        _ptr(scratch), _ptr(images), _stream(gi_all.device))
    _raise_on(lib, err, "cell_rollout_forward")


def cell_rollout_forward(cell_type: str, gi_all: torch.Tensor,
                         w_hh: torch.Tensor, b_hh: torch.Tensor,
                         h0: torch.Tensor, c0: OptT,
                         out: Optional[Sequence[OptT]] = None,
                         clusters: int = 0):
    """The forward of a whole rollout in one launch: gi_all (T, B, G) (the
    input gates, G = 4H LSTM / 3H GRU), w_hh (H, G), b_hh (G,), h0 (B, H),
    c0 (B, H) for LSTM, None for GRU; ``out`` = (hs, cs, acts). Returns
    (hs (T, B, H), cs (T, B, H) or None, acts (T, B, 4H): [i, f, g, o] /
    [r, z, n, h_n]). ``clusters`` as for ``rollout_plan``, for tests."""
    outs = out or (None, None, None)
    (T, B, H, _), operands = _forward_operands(cell_type, gi_all, w_hh, b_hh,
                                               h0, c0, outs)
    lstm = cell_type == "LSTM"
    _check_shapes("cell_rollout_forward", operands)
    if _on_cpu("cell_rollout_forward", operands):
        made = cell_rollout_forward_reference(cell_type, gi_all, w_hh, b_hh,
                                              h0, c0)
        return _outputs((outs[0], outs[1] if lstm else None, outs[2]), made)
    hs = _empty(out, 0, (T, B, H), h0)
    cs = _empty(out, 1, (T, B, H), h0) if lstm else None
    acts = _empty(out, 2, (T, B, 4 * H), h0)
    _launch_forward(cell_type, gi_all, w_hh, b_hh, h0, c0, hs, cs, acts,
                    clusters, 0)
    _count(cell_rollout_forward, cell_type)
    return hs, cs, acts


cell_rollout_forward.n_launches = 0
cell_rollout_forward.cell_launches = collections.Counter()


def _backward_operands(cell_type, dhs, acts, w_hh, h0, hs, c0, cs, outs,
                       steps_out=None):
    T, B, H, G = _rollout_dims("cell_rollout_backward", cell_type, dhs, h0)
    lstm = cell_type == "LSTM"
    if lstm and (c0 is None or cs is None):
        raise ValueError("cell_rollout_backward LSTM: c0 and cs needed")
    if not lstm and hs is None:
        raise ValueError("cell_rollout_backward GRU: hs needed")
    if steps_out is not None and (steps_out[0] is None
                                  or lstm != (steps_out[1] is not None)):
        raise ValueError("cell_rollout_backward: steps_out is (dh_steps, "
                         "dc_steps) for LSTM, (dh_steps, None) for GRU")
    steps = steps_out or (None, None)
    return (T, B, H, G), [
        ("dh_steps", steps[0], (T, B, H)), ("dc_steps", steps[1], (T, B, H)),
        ("dhs", dhs, (T, B, H)), ("acts", acts, (T, B, 4 * H)),
        ("w_hh", w_hh, (H, G)), ("h0", h0, (B, H)),
        ("hs", None if lstm else hs, (T, B, H)),
        ("c0", c0 if lstm else None, (B, H)),
        ("cs", cs if lstm else None, (T, B, H)),
        ("dgi_out", outs[0], (T, B, G)),
        ("dgh_out", None if lstm else outs[1], (T, B, G)),
        ("dh0_out", outs[2], (B, H)),
        ("dc0_out", outs[3] if lstm else None, (B, H))]


def _launch_backward(cell_type, dhs, acts, w_hh, h0, hs, c0, cs, dgi, dgh,
                     dh0, dc0, clusters, probe, steps_out=None):
    T, B, H = dhs.shape[0], dhs.shape[1], h0.shape[1]
    lstm = cell_type == "LSTM"
    plan, raw = rollout_plan(cell_type, False, dhs.dtype, B, H, dhs.device,
                             clusters)
    lib = _cell_rollout_library()
    scratch, base = _scratch(dhs.device, T)
    images = _images_buffer(dhs.device, plan["images"])
    err = lib.recnet_cell_rollout_bwd(
        _DTYPE_CODES[dhs.dtype], int(lstm), raw, T, B, H, probe,
        _vec(dgi if lstm else dgh, _VEC_DG) | _vec(acts, _VEC_ACTS)
        | _vec(w_hh, _VEC_W, H), base,
        _ptr(dhs), _ptr(acts), _ptr(w_hh), _ptr(h0),
        _ptr(None if lstm else hs), _ptr(c0 if lstm else None),
        _ptr(cs if lstm else None), _ptr(dgi), _ptr(None if lstm else dgh),
        _ptr(dh0), _ptr(dc0), *map(_ptr, steps_out or (None, None)),
        _ptr(scratch), _ptr(images), _stream(dhs.device))
    _raise_on(lib, err, "cell_rollout_backward")


def cell_rollout_backward(cell_type: str, dhs: torch.Tensor,
                          acts: torch.Tensor, w_hh: torch.Tensor,
                          h0: torch.Tensor, hs: OptT, c0: OptT, cs: OptT,
                          out: Optional[Sequence[OptT]] = None,
                          clusters: int = 0,
                          steps_out: Optional[Sequence[OptT]] = None):
    """The backward of a whole rollout in one launch, from the output
    cotangents dhs (T, B, H) and the forward's acts (T, B, 4H); LSTM reads
    c0 and cs (its c_prev and c_t), GRU h0 and hs (its h_prev). ``out`` =
    (dgi, dgh, dh0, dc0). Returns (dgi (T, B, G), dgh, dh0 (B, H), dc0):
    LSTM's dgh is dgi (the gates' cotangents) and dc0 (B, H); GRU's dc0
    None. ``steps_out`` = (dh_steps, dc_steps) (T, B, H) (dc_steps None for
    GRU), where given, receives the carried dh and dc into each step (zero
    at T - 1), so that a test can check each step from the kernel's own
    carries. ``clusters`` as for ``rollout_plan``, for tests."""
    outs = out or (None, None, None, None)
    (T, B, H, G), operands = _backward_operands(
        cell_type, dhs, acts, w_hh, h0, hs, c0, cs, outs, steps_out)
    lstm = cell_type == "LSTM"
    _check_shapes("cell_rollout_backward", operands)
    if _on_cpu("cell_rollout_backward", operands):
        made = cell_rollout_backward_reference(cell_type, dhs, acts, w_hh,
                                               h0, hs, c0, cs, steps_out)
        if lstm:
            dgi, _, dh0, dc0 = _outputs((outs[0], None, outs[2], outs[3]),
                                        made)
            return dgi, dgi, dh0, dc0
        return _outputs((outs[0], outs[1], outs[2], None), made)
    dgi = _empty(out, 0, (T, B, G), dhs)
    dgh = dgi if lstm else _empty(out, 1, (T, B, G), dhs)
    dh0 = _empty(out, 2, (B, H), dhs)
    dc0 = _empty(out, 3, (B, H), dhs) if lstm else None
    _launch_backward(cell_type, dhs, acts, w_hh, h0, hs, c0, cs, dgi, dgh,
                     dh0, dc0, clusters, 0, steps_out)
    _count(cell_rollout_backward, cell_type)
    return dgi, dgh, dh0, dc0


cell_rollout_backward.n_launches = 0
cell_rollout_backward.cell_launches = collections.Counter()


def cell_rollout_probe(kind: str, probe: str, *operands):
    """A split probe of the whole-rollout kernels on the card: ``kind``
    "forward" with the operands of ``cell_rollout_forward`` or "backward"
    with those of ``cell_rollout_backward``; ``probe`` "product" (no
    staging, no waits for readiness and no product: the cell runs on P =
    0, so its outputs are the plain version's with w_hh = 0), "mma" (the
    staging kept, the MMAs dropped: P = 0 as well) or "exchange" (no waits
    for other blocks (the readiness words) and no cluster sum: each block's own partial product over a fixed input,
    h0 forward and acts[t] backward). Returns what the wrapper returns.
    Counts no launch; CUDA tensors only."""
    if kind not in ("forward", "backward") or probe not in ROLLOUT_PROBES:
        raise ValueError(f"no {kind} probe {probe!r}")
    forward = kind == "forward"
    cell_type = operands[0]
    lstm = cell_type == "LSTM"
    if forward:
        (T, B, H, _), checked = _forward_operands(*operands,
                                                  (None, None, None))
    else:
        (T, B, H, G), checked = _backward_operands(*operands,
                                                   (None,) * 4)
    what = f"cell_rollout_probe {kind}"
    _check_shapes(what, checked)
    if _on_cpu(what, checked):
        raise ValueError(f"{what}: the split probes run on the card only")
    if forward:
        _, gi_all, w_hh, b_hh, h0, c0 = operands
        hs, acts = h0.new_empty((T, B, H)), h0.new_empty((T, B, 4 * H))
        cs = h0.new_empty((T, B, H)) if lstm else None
        _launch_forward(cell_type, gi_all, w_hh, b_hh, h0, c0, hs, cs, acts,
                        0, ROLLOUT_PROBES[probe])
        return hs, cs, acts
    _, dhs, acts, w_hh, h0, hs, c0, cs = operands
    dgi = h0.new_empty((T, B, G))
    dgh = dgi if lstm else h0.new_empty((T, B, G))
    dh0 = h0.new_empty((B, H))
    dc0 = h0.new_empty((B, H)) if lstm else None
    _launch_backward(cell_type, dhs, acts, w_hh, h0, hs, c0, cs, dgi, dgh,
                     dh0, dc0, 0, ROLLOUT_PROBES[probe])
    return dgi, dgh, dh0, dc0


KERNELS = (cell_forward, cell_backward, attention_forward, attention_backward,
           cell_rollout_forward, cell_rollout_backward)


def reset_counts() -> None:
    """Every wrapper's launch counts to 0."""
    for fn in KERNELS:
        fn.n_launches = 0
    for fn in (cell_forward, cell_backward, cell_rollout_forward,
               cell_rollout_backward):
        fn.cell_launches.clear()
