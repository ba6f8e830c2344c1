"""The fused attention + GRU decoder step on Hopper (K4): the wrappers of
``csrc/fused_step.cu`` and their plain-PyTorch twins.

Counterpart of ``recnet_tpu/ops/pallas/fused_step.py``:

* ``fused_gru_attn_step`` runs one GRU decoder step, attention included:
  ``score_f = w . tanh(W h + uv_f + b)``, ``ctx = sum_f score_f enc_f / L``
  summed ``frame_chunk`` frames at a time, then the gates
  ``[emb, ctx] @ W_ih + h @ W_hh + b`` and the GRU cell. It returns h'
  (B, H); the vocab projection and the argmax stay with the caller.
* ``fused_gru_attn_step_reference`` is its plain twin, with the kernels'
  casts and summation order; ``gru_attn_step_reference`` is the plain
  restatement of the Pallas module, for parity tests.

Three bodies run the step; ``step_body`` picks one by dtype and shape, as
the whole decode picks its body. bf16 with H a multiple of 16 takes the
tensor-core route, two kernels: the attention pass writes each row's gate
operand X = [emb, ctx, zero pad, h] and the gate GEMM multiplies X by the
gate tiles of ``layout.gate_tiles`` on the tensor cores, with the GRU cell
in its epilogue (plain restatements: ``attention_pass_reference`` and
``gate_cell_reference``; the test hooks ``_attention_pass`` and
``_gate_cell`` run each kernel alone). f32 with H a multiple of 16 takes
the TF32 route, the same two stages in f32: the attention pass (W h,
the scores, then ctx as a stream of enc: three launches), then the gate
GEMM on three-term TF32 products over the f32 tiles of
``layout.gate_tiles_f32`` (plain restatements:
``attention_pass_tf32_reference`` and ``gate_cell_tf32_reference``, the
products as ``whole_decode.matmul_3xtf32_reference`` models them; test
hooks ``_attention_pass_tf32`` and ``_gate_cell_tf32``). Other shapes and
``cuda_cores=True`` take the CUDA-core body, the first design, whose
blocks of 8 rows each stream all the weights. Each takes any B and masks
the ragged tail.

The wrappers launch the kernels for CUDA tensors and raise on anything
they do not take, a failed build or launch included; for CPU tensors they
run the plain versions. ``step_launcher`` checks the operands of a loop of
steps once (``decoding.greedy_decode_pallas``) and gives a launch that
checks only each step's emb and h. ``fused_gru_attn_step`` counts its
launches in ``n_launches`` and per body in ``body_launches``; a launch on
the tensor-core route runs two CUDA kernels, on the TF32 route four, and
counts as one. The test hooks count nothing.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, Optional

import torch

from recnet_tpu_torch.ops.cuda import build, layout
from recnet_tpu_torch.ops.cuda.whole_decode import (
    _tensor_cores, _tf32, check_sm90, matmul_3xtf32_reference)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OPERANDS = ("emb", "h", "enc", "uv", "attn_w", "attn_v", "attn_b", "w_ih",
             "w_hh", "bias3")
# the two-kernel routes' kernels (csrc/fused_step.cu recnet_fused_step_tc,
# recnet_fused_step_tf32)
_ATTENTION_PASS, _GATE_CELL = 1, 2
# the TF32 route (csrc/fused_step.cu): X's columns come in k8 steps; the
# W h launch's rows and columns of a tile and parts of its k range, and
# the H100's shared memory a block; kernel B's rows a block, as it is
# built for them (with 256 / rows unit tiles: either gives the same h',
# bit for bit), and its parts of the k range (a cluster's blocks)
TF32_K = 8
WH_ROWS, WH_COLS, WH_PARTS = 16, 32, 16
SMEM_LIMIT = 232448
GATE_ROWS_CHOICES, GATE_PARTS = (128, 32), 8


def pack_gru_bias(b_ih: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """(2, 3H): row 0 = b_ih, row 1 = b_hh."""
    return torch.stack([b_ih, b_hh])


def _gru_cell(gi, gh, h):
    """h' of the GRU (gate order r, z, n; r scales the hidden-side n)."""
    H = h.shape[-1]
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1.0 - z) * n + z * h


def gru_attn_step_reference(emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih,
                            w_hh, b_ih, b_hh, emb_size):
    """Plain restatement of the step, in the operands' dtype, for parity
    testing (``recnet_tpu.ops.pallas.fused_step.gru_attn_step_reference``)."""
    wh = h @ attn_w
    act = torch.tanh(wh[:, None, :] + uv + attn_b[0])
    scores = (act @ attn_v).squeeze(-1)
    ctx = torch.einsum("bl,blf->bf", scores, enc) / enc.shape[1]
    x = torch.cat([emb, ctx], -1)
    return _gru_cell(x @ w_ih + b_ih, h @ w_hh + b_hh, h)


def step_body(dtype: torch.dtype, hidden: int,
              cuda_cores: bool = False) -> str:
    """The body that runs the step on the card: "tensor_cores" for bf16
    with ``hidden`` a multiple of 16 (the rule of the whole decode's
    tensor-core body), "tf32" for f32 with ``hidden`` a multiple of 16
    where the TF32 route's W h launch holds the width
    (``attn_tf32_fits``), else "cuda_cores", the first design;
    ``cuda_cores`` forces the latter."""
    if cuda_cores:
        return "cuda_cores"
    if _tensor_cores(dtype, hidden):
        return "tensor_cores"
    return ("tf32" if _tf32(dtype, hidden) and attn_tf32_fits(hidden)
            else "cuda_cores")


def gate_width(in_size: int, hidden: int, multiple: int = 16) -> int:
    """Columns of the gate operand X: ``in_size`` (E + F) padded to a
    multiple of ``multiple``, then ``hidden``: the rows of
    ``layout.gate_tiles`` (16, the bf16 route's) or of
    ``layout.gate_tiles_f32`` (``TF32_K``, the TF32 route's)."""
    return -(-in_size // multiple) * multiple + hidden


def attn_tf32_smem_bytes(H: int) -> int:
    """Shared memory of the TF32 route's W h launch (csrc/fused_step.cu
    WhSmem): a tile's WH_COLS columns of W, its WH_ROWS rows of h as
    copied (rows H + 4 apart; then the WH_PARTS parts' sums) and by k,
    each 16-byte aligned."""
    size = 0
    for floats in (H * WH_COLS, max(WH_ROWS * (H + 4),
                                    WH_PARTS * WH_ROWS * WH_COLS),
                   H * WH_ROWS):
        size = -(-(size + 4 * floats) // 16) * 16
    return size


def gate_rows(B: int) -> int:
    """Rows a block of the TF32 route's gate GEMM at batch B: 128, or 32
    where tiles of 128 rows would pad B by more than an eighth of it (B =
    100 and 192 take 32, 128 and 1000 take 128). On the H100 128 rows are
    faster where they pad little, 32 where they pad much (``chip_smoke.py
    --gate-rows`` times both). A row's h' is the same bit for bit at
    either, so it does not change with the batch."""
    big, small = GATE_ROWS_CHOICES
    return big if 8 * (-(-B // big) * big - B) <= B else small


def gate_blocks(B: int, hidden: int) -> int:
    """Blocks of the TF32 route's gate GEMM: unit groups of 256 / rows
    16-unit tiles x row tiles x GATE_PARTS parts of the k range, at
    ``gate_rows(B)`` rows a block."""
    rows = gate_rows(B)
    group = 256 // rows
    return -(-(hidden // 16) // group) * -(-B // rows) * GATE_PARTS


def attn_tf32_fits(H: int) -> bool:
    """Whether the TF32 route's W h launch fits a block's shared memory
    (H up to 907; the other launches hold no operand whole)."""
    return attn_tf32_smem_bytes(H) <= SMEM_LIMIT


def _check(named: Dict[str, torch.Tensor], emb_size: int,
           frame_chunk: int) -> None:
    """What the kernels take on either body, for the operands ``named``
    (all of the step's, or the attention pass's): f32 or bf16 throughout
    and consistent shapes; L a multiple of ``frame_chunk``."""
    dtype = named["h"].dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {dtype}")
    for name, t in named.items():
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, h is {dtype}")
    B, L, F = named["enc"].shape
    H = named["h"].shape[-1]
    A = named["attn_w"].shape[-1]
    E = emb_size
    want = dict(emb=(B, E), h=(B, H), enc=(B, L, F), uv=(B, L, A),
                attn_w=(H, A), attn_v=(A, 1), attn_b=(1, A),
                w_ih=(E + F, 3 * H), w_hh=(H, 3 * H), bias3=(2, 3 * H))
    for name, t in named.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; the step "
                             f"needs {want[name]}")
    if frame_chunk < 1 or L % frame_chunk != 0:
        raise ValueError(f"frames {L} not divisible by frame_chunk "
                         f"{frame_chunk}")
    if B < 1:
        raise ValueError("empty batch")


def _check_gates(x: torch.Tensor, tiles: torch.Tensor,
                 bias3: torch.Tensor) -> None:
    """What the gate stage takes: X (B, 16 k16 steps), the gate tiles of
    those k16 steps and bias3 (2, 3H), in one dtype."""
    H, steps = 16 * tiles.shape[0], x.shape[1] // 16
    want = dict(x=(x.shape[0], 16 * steps), tiles=(H // 16, steps, 3, 16, 16),
                bias3=(2, 3 * H))
    for name, t in dict(x=x, tiles=tiles, bias3=bias3).items():
        if t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype}, x is {x.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; the gate "
                             f"stage needs {want[name]} (tiles as "
                             f"layout.gate_tiles makes them)")


def _check_gates_tf32(x: torch.Tensor, tiles: torch.Tensor,
                      bias3: torch.Tensor) -> None:
    """What the TF32 route's gate stage takes: X (B, 8 k8 steps), f32, the
    f32 gate tiles of those k8 steps (``layout.gate_tiles_f32``) and bias3
    (2, 3H), all f32."""
    H, steps = 16 * tiles.shape[0], x.shape[1] // TF32_K
    want = dict(x=(x.shape[0], TF32_K * steps),
                tiles=(H // 16, steps, 3, 32, 4), bias3=(2, 3 * H))
    for name, t in dict(x=x, tiles=tiles, bias3=bias3).items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}; the TF32 route takes "
                             f"float32")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; the gate "
                             f"stage needs {want[name]} (tiles as "
                             f"layout.gate_tiles_f32 makes them)")


def _context(h32, enc, uv, attn_w, attn_v, attn_b, frame_chunk):
    """ctx / L in f32, in the Pallas kernel's order: W h and the scores in
    f32; each chunk of ``frame_chunk`` frames summed from zero and its sum
    added to the running ctx."""
    f32, L = torch.float32, enc.shape[1]
    wh = h32 @ attn_w.to(f32)
    v32, b32 = attn_v.to(f32), attn_b[0].to(f32)
    ctx = torch.zeros((enc.shape[0], enc.shape[2]), dtype=f32,
                      device=enc.device)
    for j in range(0, L, frame_chunk):
        acc = torch.zeros_like(ctx)
        for f in range(j, j + frame_chunk):
            act = torch.tanh(wh + uv[:, f].to(f32) + b32)
            acc = acc + (act @ v32) * enc[:, f].to(f32)
        ctx = ctx + acc
    return ctx / L


def fused_gru_attn_step_reference(emb, h, enc, uv, attn_w, attn_v, attn_b,
                                  w_ih, w_hh, bias3, *, emb_size: int,
                                  frame_chunk: int = 1) -> torch.Tensor:
    """Plain twin of K4 with the Pallas kernel's casts and order: W h, the
    scores and ctx in f32 (``_context``); ctx / L cast to dtype before its
    gate product; emb and h read in dtype; h' computed in f32 and stored in
    dtype."""
    _check(dict(zip(_OPERANDS, (emb, h, enc, uv, attn_w, attn_v, attn_b,
                                w_ih, w_hh, bias3))), emb_size, frame_chunk)
    f32, dtype, E = torch.float32, h.dtype, emb_size
    h32 = h.to(f32)
    ctx = _context(h32, enc, uv, attn_w, attn_v, attn_b,
                   frame_chunk).to(dtype).to(f32)
    w32 = w_ih.to(f32)
    gi = emb.to(f32) @ w32[:E] + ctx @ w32[E:] + bias3[0].to(f32)
    gh = h32 @ w_hh.to(f32) + bias3[1].to(f32)
    return _gru_cell(gi, gh, h32).to(dtype)


def attention_pass_reference(emb, h, enc, uv, attn_w, attn_v, attn_b, *,
                             frame_chunk: int = 1,
                             multiple: int = 16) -> torch.Tensor:
    """Plain restatement of the tensor-core route's first kernel: the gate
    operand X (B, ``gate_width(E + F, H, multiple)``) in h's dtype, each
    row [emb, ctx / L cast to dtype (``_context``), zeros up to a multiple
    of ``multiple`` columns, h]."""
    named = dict(zip(_OPERANDS, (emb, h, enc, uv, attn_w, attn_v, attn_b)))
    _check(named, emb.shape[1], frame_chunk)
    (B, E), F, H = emb.shape, enc.shape[2], h.shape[1]
    ctx = _context(h.float(), enc, uv, attn_w, attn_v, attn_b, frame_chunk)
    x = torch.zeros((B, gate_width(E + F, H, multiple)), dtype=h.dtype,
                    device=h.device)
    x[:, :E] = emb
    x[:, E:E + F] = ctx.to(h.dtype)
    x[:, -H:] = h
    return x


def gate_cell_reference(x: torch.Tensor, tiles: torch.Tensor,
                        bias3: torch.Tensor) -> torch.Tensor:
    """Plain restatement of the tensor-core route's second kernel: h' from
    the gate operand X (``attention_pass_reference``) and the gate tiles
    (``layout.gate_tiles``, [H / 16 unit tiles][k16 steps][gate][16
    inputs][16 units]). gi sums the k16 steps of [emb, ctx, pad] and gh
    those of h, in f32; the biases and the GRU cell in f32; h (X's last H
    columns) is exact in dtype. Returns h' in x's dtype."""
    _check_gates(x, tiles, bias3)
    f32 = torch.float32
    n_ut, steps = tiles.shape[:2]
    B, H, nkx = x.shape[0], 16 * n_ut, steps - n_ut
    xs, w = x.to(f32).view(B, steps, 16), tiles.to(f32)
    gates = lambda xk, wk: torch.einsum("bsk,usgkj->bguj", xk, wk).reshape(
        B, 3 * H)
    gi = gates(xs[:, :nkx], w[:, :nkx]) + bias3[0].to(f32)
    gh = gates(xs[:, nkx:], w[:, nkx:]) + bias3[1].to(f32)
    return _gru_cell(gi, gh, x[:, -H:].to(f32)).to(x.dtype)


def attention_pass_tf32_reference(emb, h, enc, uv, attn_w, attn_v, attn_b,
                                  *, frame_chunk: int = 1) -> torch.Tensor:
    """Plain restatement of the TF32 route's first kernel: X (B,
    ``gate_width(E + F, H, TF32_K)``) in f32, each row [emb, ctx / L
    (``_context``), zeros up to a multiple of 8 columns, h]: the rows of
    ``layout.gate_tiles_f32``."""
    if h.dtype != torch.float32:
        raise ValueError(f"the TF32 route takes float32, not {h.dtype}")
    return attention_pass_reference(emb, h, enc, uv, attn_w, attn_v, attn_b,
                                    frame_chunk=frame_chunk, multiple=TF32_K)


def gate_cell_tf32_reference(x: torch.Tensor, tiles: torch.Tensor,
                             bias3: torch.Tensor) -> torch.Tensor:
    """Plain restatement of the TF32 route's second kernel: h' from X
    (``attention_pass_tf32_reference``) and the f32 gate tiles
    (``layout.gate_tiles_f32``), gi over X's [emb, ctx, pad] columns and gh
    over its h columns, each product in three TF32 terms as
    ``matmul_3xtf32_reference`` models them; the biases and the GRU cell in
    f32."""
    _check_gates_tf32(x, tiles, bias3)
    H = 16 * tiles.shape[0]
    kx = x.shape[1] - H
    w = layout.gate_rows_f32(tiles)
    gi = matmul_3xtf32_reference(x[:, :kx], w[:kx]) + bias3[0]
    gh = matmul_3xtf32_reference(x[:, kx:], w[kx:]) + bias3[1]
    return _gru_cell(gi, gh, x[:, kx:])


def _library() -> ctypes.CDLL:
    lib = build.load("fused_step")
    if getattr(lib, "_recnet_bound", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.recnet_fused_step.argtypes = [i] + [p] * 11 + [i] * 7 + [p]
    lib.recnet_fused_step.restype = i
    lib.recnet_fused_step_tc.argtypes = [i] + [p] * 11 + [i] * 8 + [p]
    lib.recnet_fused_step_tc.restype = i
    lib.recnet_fused_step_tf32.argtypes = [i] + [p] * 12 + [i] * 9 + [p]
    lib.recnet_fused_step_tf32.restype = i
    lib.recnet_fused_step_tf32_attn_smem.argtypes = [i]
    lib.recnet_fused_step_tf32_attn_smem.restype = ctypes.c_longlong
    lib.recnet_fused_step_tf32_clusters.argtypes = [i]
    lib.recnet_fused_step_tf32_clusters.restype = i
    lib.recnet_cuda_error_string.argtypes = [i]
    lib.recnet_cuda_error_string.restype = ctypes.c_char_p
    lib._recnet_bound = True
    return lib


def _check_cuda(named, device: torch.device) -> None:
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_sm90(device, "fused-step")


def _raise_on(lib, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"fused-step kernel launch failed: "
            f"{lib.recnet_cuda_error_string(err).decode()} ({err})")


def _launch_tc(kernels: int, x: torch.Tensor, h_out=None, *, emb=None,
               h=None, enc=None, uv=None, attn_w=None, attn_v=None,
               attn_b=None, tiles=None, bias3=None, frame_chunk: int = 1):
    """Run the tensor-core route's kernels (``_ATTENTION_PASS`` and/or
    ``_GATE_CELL``) on x's stream; operands a kernel does not read may be
    None. Serves the stage hooks; ``step_launcher`` binds its own call."""
    for name, t in (("h", h), ("tiles", tiles), ("x", x)):
        if t is not None and t.data_ptr() % 16:   # 16-byte copies
            raise ValueError(f"{name} must start 16-byte aligned")
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(0 if t is None else t.data_ptr())
    B, ldx = x.shape
    H = 16 * tiles.shape[0] if tiles is not None else h.shape[1]
    L, F = enc.shape[1:] if enc is not None else (0, 0)
    A = attn_w.shape[1] if attn_w is not None else 0
    E = emb.shape[1] if emb is not None else 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.recnet_fused_step_tc(
            kernels, *(ptr(t) for t in (emb, h, enc, uv, attn_w, attn_v,
                                        attn_b, tiles, bias3, x, h_out)),
            B, L, F, A, E, H, ldx, frame_chunk, ctypes.c_void_p(stream))
    _raise_on(lib, err)


def _launch_tf32(kernels: int, x: torch.Tensor, h_out=None, *, emb=None,
                 h=None, enc=None, uv=None, attn_w=None, attn_v=None,
                 attn_b=None, tiles=None, bias3=None, frame_chunk: int = 1,
                 rows_per_block: Optional[int] = None):
    """Run the TF32 route's kernels (``_ATTENTION_PASS`` and/or
    ``_GATE_CELL``) on x's stream, as ``_launch_tc`` runs the tensor-core
    route's; kernel B at ``gate_rows(B)`` rows a block unless
    ``rows_per_block`` forces one of GATE_ROWS_CHOICES (``chip_smoke.py
    --gate-rows`` times each)."""
    for name, t in (("tiles", tiles), ("x", x)):
        if t is not None and t.data_ptr() % 16:   # 16-byte copies
            raise ValueError(f"{name} must start 16-byte aligned")
    B, ldx = x.shape
    rows_per_block = rows_per_block or gate_rows(B)
    if rows_per_block not in GATE_ROWS_CHOICES:
        raise ValueError(f"rows_per_block takes {GATE_ROWS_CHOICES}, not "
                         f"{rows_per_block}")
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(0 if t is None else t.data_ptr())
    H = 16 * tiles.shape[0] if tiles is not None else h.shape[1]
    L, F = enc.shape[1:] if enc is not None else (0, 0)
    A = attn_w.shape[1] if attn_w is not None else 0
    E = emb.shape[1] if emb is not None else 0
    scratch = (torch.empty((B, A + L), dtype=x.dtype, device=x.device)
               if enc is not None else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.recnet_fused_step_tf32(
            kernels, *(ptr(t) for t in (emb, h, enc, uv, attn_w, attn_v,
                                        attn_b, tiles, bias3, x, scratch,
                                        h_out)),
            B, L, F, A, E, H, ldx, frame_chunk, rows_per_block,
            ctypes.c_void_p(stream))
    _raise_on(lib, err)


def _check_route(dtype: torch.dtype, hidden: int) -> None:
    if step_body(dtype, hidden) != "tensor_cores":
        raise ValueError(f"the tensor-core route takes bf16 with H a "
                         f"multiple of 16, not {dtype} with H = {hidden}")


def _attention_pass(emb, h, enc, uv, attn_w, attn_v, attn_b, *,
                    frame_chunk: int = 1) -> torch.Tensor:
    """Test hook: the tensor-core route's first kernel alone, X as
    ``attention_pass_reference`` gives it (bf16, H a multiple of 16); CPU
    tensors run that restatement. Not counted as a launch of K4."""
    named = dict(zip(_OPERANDS, (emb, h, enc, uv, attn_w, attn_v, attn_b)))
    if enc.device.type == "cpu":
        return attention_pass_reference(**named, frame_chunk=frame_chunk)
    _check(named, emb.shape[1], frame_chunk)
    (B, E), F, H = emb.shape, enc.shape[2], h.shape[1]
    _check_route(h.dtype, H)
    _check_cuda(named, enc.device)
    x = torch.empty((B, gate_width(E + F, H)), dtype=h.dtype,
                    device=enc.device)
    _launch_tc(_ATTENTION_PASS, x, **named, frame_chunk=frame_chunk)
    return x


def _gate_cell(x: torch.Tensor, tiles: torch.Tensor,
               bias3: torch.Tensor) -> torch.Tensor:
    """Test hook: the tensor-core route's second kernel alone, h' as
    ``gate_cell_reference`` gives it; CPU tensors run that restatement.
    Not counted as a launch of K4."""
    if x.device.type == "cpu":
        return gate_cell_reference(x, tiles, bias3)
    _check_gates(x, tiles, bias3)
    H = 16 * tiles.shape[0]
    _check_route(x.dtype, H)
    _check_cuda(dict(x=x, tiles=tiles, bias3=bias3), x.device)
    h_out = torch.empty((x.shape[0], H), dtype=x.dtype, device=x.device)
    _launch_tc(_GATE_CELL, x, h_out, tiles=tiles, bias3=bias3)
    return h_out


def _check_tf32_route(dtype: torch.dtype, hidden: int) -> None:
    if step_body(dtype, hidden) != "tf32":
        raise ValueError(f"the TF32 route takes float32 with H a multiple "
                         f"of 16 whose W h tile fits a block, not {dtype} "
                         f"with H = {hidden}")


def _attention_pass_tf32(emb, h, enc, uv, attn_w, attn_v, attn_b, *,
                         frame_chunk: int = 1) -> torch.Tensor:
    """Test hook: the TF32 route's first kernel alone, X as
    ``attention_pass_tf32_reference`` gives it; CPU tensors run that
    restatement. Not counted as a launch of K4."""
    named = dict(zip(_OPERANDS, (emb, h, enc, uv, attn_w, attn_v, attn_b)))
    if enc.device.type == "cpu":
        return attention_pass_tf32_reference(**named,
                                             frame_chunk=frame_chunk)
    _check(named, emb.shape[1], frame_chunk)
    (B, E), (L, F), (H, A) = emb.shape, enc.shape[1:], attn_w.shape
    _check_tf32_route(h.dtype, H)
    _check_cuda(named, enc.device)
    x = torch.empty((B, gate_width(E + F, H, TF32_K)), dtype=h.dtype,
                    device=enc.device)
    _launch_tf32(_ATTENTION_PASS, x, **named, frame_chunk=frame_chunk)
    return x


def _gate_cell_tf32(x: torch.Tensor, tiles: torch.Tensor,
                    bias3: torch.Tensor) -> torch.Tensor:
    """Test hook: the TF32 route's second kernel alone, h' as
    ``gate_cell_tf32_reference`` gives it, at ``gate_rows`` rows a block;
    CPU tensors run that restatement. Not counted as a launch of K4."""
    if x.device.type == "cpu":
        return gate_cell_tf32_reference(x, tiles, bias3)
    _check_gates_tf32(x, tiles, bias3)
    H = 16 * tiles.shape[0]
    _check_tf32_route(x.dtype, H)
    _check_cuda(dict(x=x, tiles=tiles, bias3=bias3), x.device)
    h_out = torch.empty((x.shape[0], H), dtype=x.dtype, device=x.device)
    _launch_tf32(_GATE_CELL, x, h_out, tiles=tiles, bias3=bias3)
    return h_out


def step_launcher(emb: torch.Tensor, h: torch.Tensor, enc: torch.Tensor,
                  uv: torch.Tensor, attn_w: torch.Tensor,
                  attn_v: torch.Tensor, attn_b: torch.Tensor,
                  w_ih: torch.Tensor, w_hh: torch.Tensor,
                  bias3: torch.Tensor, *, emb_size: int,
                  frame_chunk: int = 1, tiles: Optional[torch.Tensor] = None,
                  cuda_cores: bool = False):
    """K4 for a loop of steps on the card: checks every operand once, as
    ``fused_gru_attn_step`` takes them, and returns ``launch(emb, h) ->
    h'``. ``launch`` runs one step on the operands given here but emb and
    h, which it takes anew and checks against the ones given here (shape,
    dtype, device, layout); it launches on the stream current here and
    counts as ``fused_gru_attn_step`` does. The tensor-core and TF32
    routes' gate operand X is one scratch tensor that every launch reuses
    (the stream orders them). For CPU tensors ``launch`` runs the plain
    twin."""
    device = enc.device
    ops = (emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh, bias3)
    if device.type == "cpu":
        return lambda emb, h: fused_gru_attn_step_reference(
            emb, h, *ops[2:], emb_size=emb_size, frame_chunk=frame_chunk)
    if device.type != "cuda":
        raise ValueError(f"no fused-step route for {device}")
    named = dict(zip(_OPERANDS, ops))
    _check(named, emb_size, frame_chunk)
    B, L, F = enc.shape
    H, A = attn_w.shape
    body = step_body(h.dtype, H, cuda_cores)
    if body in ("tensor_cores", "tf32"):
        if tiles is None:
            tiles = (layout.gate_tiles(w_ih, w_hh, 3) if body == "tensor_cores"
                     else layout.gate_tiles_f32(w_ih, w_hh, 3))
        named["tiles"] = tiles
    _check_cuda(named, device)
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    if body in ("tensor_cores", "tf32"):
        tc = body == "tensor_cores"
        x = torch.empty((B, gate_width(emb_size + F, H, 16 if tc else TF32_K)),
                        dtype=h.dtype, device=device)
        (_check_gates if tc else _check_gates_tf32)(x, tiles, bias3)
        for name, t in (("tiles", tiles), ("x", x)):
            if t.data_ptr() % 16:   # 16-byte copies
                raise ValueError(f"{name} must start 16-byte aligned")
        head = _ATTENTION_PASS | _GATE_CELL
        held = (enc, uv, attn_w, attn_v, attn_b, tiles, bias3, x)
        dims = (B, L, F, A, emb_size, H, x.shape[1], frame_chunk)
        if tc:
            entry, dims = lib.recnet_fused_step_tc, dims + (stream,)
        else:   # W h's and the scores' scratch beside X
            held += (torch.empty((B, A + L), dtype=h.dtype, device=device),)
            entry = lib.recnet_fused_step_tf32
            dims = dims + (gate_rows(B), stream)
    else:
        entry, head = lib.recnet_fused_step, _DTYPE_CODES[h.dtype]
        held = ops[2:]
        dims = (B, L, F, A, emb_size, H, frame_chunk, stream)
    fixed = [ptr(t) for t in held]
    shapes, dtype = dict(emb=emb.shape, h=h.shape), h.dtype
    aligned = body == "tensor_cores"   # the attention pass copies h by 16 B

    def launch(emb: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        for name, t in (("emb", emb), ("h", h)):
            if (t.shape != shapes[name] or t.dtype != dtype
                    or t.device != device or not t.is_contiguous()):
                raise ValueError(
                    f"{name} must be a contiguous {dtype} tensor of shape "
                    f"{tuple(shapes[name])} on {device}")
        if aligned and h.data_ptr() % 16:
            raise ValueError("h must start 16-byte aligned")
        h_out = torch.empty_like(h)
        with torch.cuda.device(device):
            _raise_on(lib, entry(head, ptr(emb), ptr(h), *fixed, ptr(h_out),
                                 *dims))
        fused_gru_attn_step.n_launches += 1
        fused_gru_attn_step.body_launches[body] += 1
        return h_out

    launch.operands = held   # the tensors behind ``fixed``, kept alive
    return launch


def fused_gru_attn_step(emb: torch.Tensor, h: torch.Tensor,
                        enc: torch.Tensor, uv: torch.Tensor,
                        attn_w: torch.Tensor, attn_v: torch.Tensor,
                        attn_b: torch.Tensor, w_ih: torch.Tensor,
                        w_hh: torch.Tensor, bias3: torch.Tensor, *,
                        emb_size: int, frame_chunk: int = 1,
                        tiles: Optional[torch.Tensor] = None,
                        cuda_cores: bool = False) -> torch.Tensor:
    """K4: one fused decoder step.

    emb (B, E); h (B, H); enc (B, L, F); uv (B, L, A); attn_w (H, A);
    attn_v (A, 1); attn_b (1, A); w_ih (E + F, 3H); w_hh (H, 3H); bias3
    (2, 3H) from ``pack_gru_bias``; all float32 or all bfloat16. Returns h'
    (B, H) in h's dtype. ``frame_chunk`` frames are summed into ctx at a
    time, as the Pallas grid's frame axis does; L must divide by it. Any B.

    On the card ``step_body`` picks the body. The tensor-core route (bf16)
    reads ``tiles``, the gate weights as ``layout.gate_tiles(w_ih, w_hh,
    3)`` lays them out, the TF32 route (f32) as ``layout.gate_tiles_f32``
    does (either a parameter set's ``params["layouts"]["gates"]``), and
    makes them for the call when they are not given; each runs the
    attention pass (one CUDA kernel, or three on the TF32 route), then the
    gate GEMM with the GRU cell, and counts one launch. ``cuda_cores`` runs the CUDA-core body instead. A
    loop of steps checks its operands once with ``step_launcher``."""
    return step_launcher(emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh,
                         bias3, emb_size=emb_size, frame_chunk=frame_chunk,
                         tiles=tiles, cuda_cores=cuda_cores)(emb, h)


fused_gru_attn_step.n_launches = 0
fused_gru_attn_step.body_launches = collections.Counter()
