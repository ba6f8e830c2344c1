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
their plain version. No rollout calls them.
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
    lib.recnet_cell_bwd.argtypes = [i, i, i, i, ld, ld] + [p] * 12
    lib.recnet_attn_fwd.argtypes = [i] * 5 + [ld] + [p] * 8
    lib.recnet_attn_bwd.argtypes = [i] * 5 + [ld] + [p] * 7
    lib.recnet_attn_fwd_probe.argtypes = [i] * 6 + [ld] + [p] * 8
    lib.recnet_attn_bwd_probe.argtypes = [i] * 6 + [ld] + [p] * 7
    lib.recnet_attn_fwd_smem.argtypes = [i, i, i]
    lib.recnet_attn_bwd_smem.argtypes = [i, i, i, i]
    for fn in (lib.recnet_cell_fwd, lib.recnet_cell_bwd, lib.recnet_attn_fwd,
               lib.recnet_attn_bwd, lib.recnet_attn_fwd_probe,
               lib.recnet_attn_bwd_probe, lib.recnet_attn_fwd_smem,
               lib.recnet_attn_bwd_smem):
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
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.recnet_rollout_error_string(err).decode()}"
                           f" ({err})")


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


def cell_forward(cell_type: str, gx: torch.Tensor, gh: OptT,
                 bias: torch.Tensor, h: torch.Tensor, c: OptT,
                 out: Optional[Sequence[OptT]] = None):
    """One step's cell from its gate products: LSTM ``gx = gi + h w_hh``
    (B, 4H), ``gh`` None, ``c`` (B, H); GRU ``gx = gi`` and ``gh = h w_hh``
    (B, 3H), ``c`` echoed. ``bias`` is b_hh. ``out`` = (h', c', acts).
    Returns (h', c', acts (B, 4H))."""
    B, H, G = _cell_dims(cell_type, h)
    lstm = cell_type == "LSTM"
    if lstm and (gh is not None or c is None):
        raise ValueError("cell_forward LSTM: gh must be None and c given")
    if not lstm and gh is None:
        raise ValueError("cell_forward GRU: gh must be given")
    outs = out or (None, None, None)
    operands = [("gx", gx, (B, G)), ("gh", gh, (B, G)), ("bias", bias, (G,)),
                ("h", h, (B, H)), ("c", c if lstm else None, (B, H)),
                ("h_out", outs[0], (B, H)),
                ("c_out", outs[1] if lstm else None, (B, H)),
                ("acts_out", outs[2], (B, 4 * H))]
    _check_shapes("cell_forward", operands)
    if _on_cpu("cell_forward", operands, ("gx", "gh")):
        made = cell_forward_reference(cell_type, gx, gh, bias, h, c)
        return _outputs((outs[0], outs[1] if lstm else None, outs[2]), made)
    h_new = _empty(out, 0, (B, H), h)
    c_new = _empty(out, 1, (B, H), h) if lstm else c
    acts = _empty(out, 2, (B, 4 * H), h)
    lib = _library()
    err = lib.recnet_cell_fwd(
        _DTYPE_CODES[gx.dtype], int(lstm), B, H, _ld(gx), _ld(gh), _ptr(gx),
        _ptr(gh), _ptr(bias), _ptr(h), _ptr(c if lstm else None),
        _ptr(h_new), _ptr(c_new if lstm else None), _ptr(acts),
        _stream(gx.device))
    _raise_on(lib, err, "cell_forward")
    _count(cell_forward, cell_type)
    return h_new, c_new, acts


cell_forward.n_launches = 0
cell_forward.cell_launches = collections.Counter()


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


def cell_backward(cell_type: str, dh: torch.Tensor, dh_out: OptT, dc: OptT,
                  acts: torch.Tensor, h_prev: OptT, c_prev: OptT, c_t: OptT,
                  out: Optional[Sequence[OptT]] = None):
    """Cotangents of one ``cell_forward`` step from ``dh`` (carried) +
    ``dh_out`` (the step's output cotangent, or None). LSTM takes ``dc``,
    ``c_prev`` and ``c_t``; GRU ``h_prev``. ``out`` = (dgi, dgh, dh_cell,
    dc_prev) (dgh, dh_cell ignored for LSTM). Returns (dgi, dgh, dh_cell,
    dc_prev)."""
    B, H, G = _cell_dims(cell_type, dh)
    lstm = cell_type == "LSTM"
    if lstm and (dc is None or c_prev is None or c_t is None):
        raise ValueError("cell_backward LSTM: dc, c_prev and c_t needed")
    if not lstm and h_prev is None:
        raise ValueError("cell_backward GRU: h_prev needed")
    outs = out or (None, None, None, None)
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
    _check_shapes("cell_backward", operands)
    if _on_cpu("cell_backward", operands, ("dgi_out", "dgh_out")):
        made = cell_backward_reference(cell_type, dh, dh_out, dc, acts,
                                       h_prev, c_prev, c_t)
        if lstm:
            dgi, _, _, dcp = _outputs((outs[0], None, None, outs[3]), made)
            return dgi, dgi, None, dcp
        return _outputs((outs[0], outs[1], outs[2], None), made)
    dgi = _empty(out, 0, (B, G), dh)
    dgh = dgi if lstm else _empty(out, 1, (B, G), dh)
    dh_cell = None if lstm else _empty(out, 2, (B, H), dh)
    dc_prev = _empty(out, 3, (B, H), dh) if lstm else dc
    lib = _library()
    err = lib.recnet_cell_bwd(
        _DTYPE_CODES[dh.dtype], int(lstm), B, H, _ld(dgi),
        _ld(None if lstm else dgh), _ptr(dh), _ptr(dh_out),
        _ptr(dc if lstm else None), _ptr(acts),
        _ptr(None if lstm else h_prev), _ptr(c_prev if lstm else None),
        _ptr(c_t if lstm else None), _ptr(dgi),
        _ptr(None if lstm else dgh), _ptr(dh_cell),
        _ptr(dc_prev if lstm else None), _stream(dh.device))
    _raise_on(lib, err, "cell_backward")
    _count(cell_backward, cell_type)
    return dgi, dgh, dh_cell, dc_prev


cell_backward.n_launches = 0
cell_backward.cell_launches = collections.Counter()


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

KERNELS = (cell_forward, cell_backward, attention_forward, attention_backward)

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


def reset_counts() -> None:
    """Every wrapper's launch counts to 0."""
    for fn in KERNELS:
        fn.n_launches = 0
    cell_forward.cell_launches.clear()
    cell_backward.cell_launches.clear()
