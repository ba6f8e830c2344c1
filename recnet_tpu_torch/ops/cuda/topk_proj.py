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
counts its launches in ``n_launches``. Unlike the Pallas wrapper there is no
``block_b``: the kernel masks the ragged edges itself, so any N and V work.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from recnet_tpu_torch.ops.cuda import build

MAX_K = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = build.load("topk_proj")
    if getattr(lib, "_recnet_bound", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.recnet_topk_proj.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
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
                 *, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``top_k(out @ out_w + out_b, k)`` in one launch, without writing the
    logits. out (N, H); out_w (H, V); out_b (V,); float32 or bfloat16 and
    1 <= k <= min(128, V). Returns (values (N, k) float32, columns (N, k)
    int32)."""
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
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.recnet_topk_proj(
            _DTYPE_CODES[out.dtype], ptr(out), ptr(out_w), ptr(out_b),
            ptr(vals), ptr(idxs), N, H, V, k, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"top-k projection kernel launch failed: "
            f"{lib.recnet_topk_error_string(err).decode()} ({err})")
    outproj_topk.n_launches += 1
    return vals, idxs


outproj_topk.n_launches = 0
