"""The fused vocab projection + top-k on Hopper: the wrapper of
``csrc/topk_proj.cu`` and its plain-PyTorch twin.

Counterpart of ``recnet_tpu/ops/pallas/topk_proj.py``. ``outproj_topk``
returns the k best logits of each row of ``out @ out_w + out_b`` without
writing the logits out: values (N, k) float32 and columns (N, k) int32, in
``lax.top_k`` order (value descending, the lowest column first among equal
values). The logits are float32 whatever the input type.

The wrapper launches the kernel for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors it runs the twin,
``outproj_topk_reference``. The twin does not use ``torch.topk``, whose
order among equal values is not specified: it runs k rounds of row max,
first column of the max, mask, as the Pallas kernel does. The wrapper
counts its launches in ``n_launches``, one a call, and by route in
``route_launches`` ("split" for bf16, "tf32_split" for f32, "single_pass").
With k <= 8 a call is two CUDA kernels, counted as one launch and timed as
one: the split kernel, which writes an (N, S, k) scratch (``splits`` gives
S), then the merge kernel over it; bf16 on m16n8k16, f32 on three-term
TF32 products (each operand split into hi = tf32(x) and lo = tf32(x - hi)
as it is loaded). The split kernel reads out_w with its rows padded to 16
bytes (``layout.padded_columns``; f32 rows of V = 4188 already are), which
the caller makes once per parameter set and passes as ``padded_w``.
``f32_single_pass=True`` runs f32 on the first design, the single pass on
CUDA-core FMAs, kept as the split route's baseline. Unlike the Pallas
wrapper there is no ``block_b``: the kernel masks the ragged edges itself,
so any N and V work.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Optional, Tuple

import torch

from recnet_tpu_torch.ops.cuda import build
from recnet_tpu_torch.ops.cuda.layout import padded_columns

MAX_K = 128
SPLIT_MAX_K = 8        # the split kernel keeps each row's k best in registers
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS, _COLS = 64, 128  # the kernel's row block and vocab tile


_COUNT_LOCK = threading.Lock()


def _library() -> ctypes.CDLL:
    lib = build.load("topk_proj")
    if getattr(lib, "_recnet_bound", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.recnet_topk_proj.argtypes = [i, p, p, p, p, p, i, i, i, i, i, p, p,
                                     i, p]
    lib.recnet_topk_proj.restype = i
    lib.recnet_topk_error_string.argtypes = [i]
    lib.recnet_topk_error_string.restype = ctypes.c_char_p
    lib._recnet_bound = True
    return lib


def _check(out: torch.Tensor, out_w: torch.Tensor, out_b: torch.Tensor,
           k: int) -> None:
    """Shapes, types and k, for both routes."""
    if out.dim() != 2 or out_w.dim() != 2 or out_b.dim() != 1:
        raise ValueError(f"out (N, H), out_w (H, V), out_b (V,) expected; "
                         f"got {tuple(out.shape)}, {tuple(out_w.shape)}, "
                         f"{tuple(out_b.shape)}")
    N, H = out.shape
    V = out_w.shape[1]
    if out_w.shape[0] != H or out_b.shape[0] != V:
        raise ValueError(f"out {tuple(out.shape)}, out_w "
                         f"{tuple(out_w.shape)} and out_b "
                         f"{tuple(out_b.shape)} disagree")
    if N < 1 or H < 1:
        raise ValueError(f"empty projection: N={N}, H={H}")
    if not 1 <= k <= min(MAX_K, V):
        raise ValueError(f"k={k} outside 1..min({MAX_K}, V={V})")
    for name, t in (("out", out), ("out_w", out_w), ("out_b", out_b)):
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes "
                             "float32 or bfloat16")
        if t.dtype != out.dtype:
            raise ValueError(f"{name} is {t.dtype}, out is {out.dtype}")


def splits(N: int, V: int, k: int, dtype: torch.dtype, n_sms: int) -> int:
    """S, the vocab ranges of the split kernel: as many (64 rows, range)
    blocks as fit two an SM in one wave, at most one range a 128-column
    tile and S k <= 32 for the merge warp (64 in f32, two entries a lane);
    0 (the single-pass kernel) for k > 8 or another type than bf16 and
    f32. The flagship beam: N = 5120 (B = 1024) 3 ranges; N = 500 (the
    eval batch, B = 100) 6 in bf16, 12 in f32."""
    if dtype not in _DTYPE_CODES or k > SPLIT_MAX_K:
        return 0
    row_blocks, tiles = -(-N // _ROWS), -(-V // _COLS)
    merge = 64 if dtype == torch.float32 else 32
    return max(1, min(2 * n_sms // row_blocks, tiles, merge // k))


def topk_rounds(work: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k of each row of ``work`` (N, V) in ``lax.top_k`` order: k rounds
    of row max, first column of the max (as ``torch.max`` along a dim
    returns it), mask to -inf. Overwrites ``work``. Returns (values (N, k)
    in ``work``'s dtype, columns (N, k) int32)."""
    vals, idxs = [], []
    for _ in range(k):
        m, i = work.max(dim=-1)
        vals.append(m)
        idxs.append(i)
        work.scatter_(-1, i[:, None], float("-inf"))
    return torch.stack(vals, -1), torch.stack(idxs, -1).to(torch.int32)


def outproj_topk_reference(out: torch.Tensor, out_w: torch.Tensor,
                           out_b: torch.Tensor, *,
                           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: the f32 logits (operands widened to f32, bias added in
    f32), then ``topk_rounds``."""
    f32 = torch.float32
    return topk_rounds(out.to(f32) @ out_w.to(f32) + out_b.to(f32), k)


def outproj_topk(out: torch.Tensor, out_w: torch.Tensor, out_b: torch.Tensor,
                 *, k: int, padded_w: Optional[torch.Tensor] = None,
                 f32_single_pass: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``top_k(out @ out_w + out_b, k)`` in one launch, without writing the
    logits. out (N, H); out_w (H, V); out_b (V,); float32 or bfloat16 and
    1 <= k <= min(128, V). ``padded_w``: ``padded_columns(out_w)``, made
    once per parameter set (``params["layouts"]["out_w_padded"]``); the
    split route makes it for the call when it is None. Returns (values
    (N, k) float32, columns (N, k) int32)."""
    _check(out, out_w, out_b, k)
    if out.device.type == "cpu":
        return outproj_topk_reference(out, out_w, out_b, k=k)
    if out.device.type != "cuda":
        raise ValueError(f"no top-k projection route for {out.device}")
    for name, t in (("out_w", out_w), ("out_b", out_b)):
        if t.device != out.device:
            raise ValueError(f"{name} is on {t.device}, out on {out.device}")
    for name, t in (("out", out), ("out_w", out_w), ("out_b", out_b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    major, minor = torch.cuda.get_device_capability(out.device)
    if major != 9:
        raise RuntimeError(
            f"the top-k projection kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(out.device)} is sm_{major}{minor}")
    N, H = out.shape
    V = out_w.shape[1]
    vals = torch.empty((N, k), dtype=torch.float32, device=out.device)
    idxs = torch.empty((N, k), dtype=torch.int32, device=out.device)
    S = splits(N, V, k, out.dtype, torch.cuda.get_device_properties(
        out.device).multi_processor_count)
    if f32_single_pass and out.dtype == torch.float32:
        S = 0
    scr_v = torch.empty((N, S, k), dtype=torch.float32, device=out.device)
    scr_i = torch.empty((N, S, k), dtype=torch.int32, device=out.device)
    if S:
        if padded_w is None:
            padded_w = padded_columns(out_w)
        per = 16 // out_w.element_size()
        if (padded_w.dtype != out_w.dtype or padded_w.device != out.device
                or not padded_w.is_contiguous()
                or padded_w.shape[0] != H or padded_w.shape[1] < V
                or padded_w.shape[1] % per):
            raise ValueError(f"padded_w {tuple(padded_w.shape)} "
                             f"{padded_w.dtype} is not out_w {(H, V)} "
                             f"{out_w.dtype} with rows padded to 16 bytes")
        out_w = padded_w
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.recnet_topk_proj(
            _DTYPE_CODES[out.dtype], ptr(out), ptr(out_w), ptr(out_b),
            ptr(vals), ptr(idxs), N, H, V, out_w.shape[1], k, ptr(scr_v),
            ptr(scr_i), S, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"top-k projection kernel launch failed: "
            f"{lib.recnet_topk_error_string(err).decode()} ({err})")
    route = ("single_pass" if not S else
             "tf32_split" if out.dtype == torch.float32 else "split")
    with _COUNT_LOCK:    # a mesh Captioner's shards launch from threads
        outproj_topk.n_launches += 1      # split + merge count as one
        outproj_topk.route_launches[route] += 1
    return vals, idxs


outproj_topk.n_launches = 0
outproj_topk.route_launches = collections.Counter()
