"""The fused attention + GRU decoder step on Hopper (K4): the wrapper of
``csrc/fused_step.cu`` and its plain-PyTorch twins.

Counterpart of ``recnet_tpu/ops/pallas/fused_step.py``:

* ``fused_gru_attn_step`` runs one GRU decoder step, attention included:
  ``score_f = w . tanh(W h + uv_f + b)``, ``ctx = sum_f score_f enc_f / L``
  summed ``frame_chunk`` frames at a time, then the gates
  ``[emb, ctx] @ W_ih + h @ W_hh + b`` and the GRU cell. It returns h'
  (B, H); the vocab projection and the argmax stay with the caller.
* ``fused_gru_attn_step_reference`` is its plain twin, with the kernel's
  casts and summation order; ``gru_attn_step_reference`` is the plain
  restatement of the Pallas module, for parity tests.

The wrapper launches the kernel for CUDA tensors and raises on anything it
does not take; for CPU tensors it runs the twin. It counts its launches in
``n_launches``. Like K1 it takes no ``block_b``: a block owns 8 rows and
masks the ragged tail, so any B works.
"""

from __future__ import annotations

import ctypes

import torch

from recnet_tpu_torch.ops.cuda import build
from recnet_tpu_torch.ops.cuda.whole_decode import check_sm90

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OPERANDS = ("emb", "h", "enc", "uv", "attn_w", "attn_v", "attn_b", "w_ih",
             "w_hh", "bias3")


def pack_gru_bias(b_ih: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """(2, 3H): row 0 = b_ih, row 1 = b_hh."""
    return torch.stack([b_ih, b_hh])


def gru_attn_step_reference(emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih,
                            w_hh, b_ih, b_hh, emb_size):
    """Plain restatement of the step, in the operands' dtype, for parity
    testing (``recnet_tpu.ops.pallas.fused_step.gru_attn_step_reference``)."""
    wh = h @ attn_w
    act = torch.tanh(wh[:, None, :] + uv + attn_b[0])
    scores = (act @ attn_v).squeeze(-1)
    ctx = torch.einsum("bl,blf->bf", scores, enc) / enc.shape[1]
    x = torch.cat([emb, ctx], -1)
    gi = x @ w_ih + b_ih
    gh = h @ w_hh + b_hh
    H = h.shape[-1]
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1.0 - z) * n + z * h


def _check(ops, emb_size: int, frame_chunk: int) -> None:
    """What the kernel takes on either route: f32 or bf16 throughout and
    consistent shapes; L a multiple of ``frame_chunk``."""
    named = dict(zip(_OPERANDS, ops))
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
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}; "
                             f"the step needs {shape}")
    if frame_chunk < 1 or L % frame_chunk != 0:
        raise ValueError(f"frames {L} not divisible by frame_chunk "
                         f"{frame_chunk}")
    if B < 1:
        raise ValueError("empty batch")


def fused_gru_attn_step_reference(emb, h, enc, uv, attn_w, attn_v, attn_b,
                                  w_ih, w_hh, bias3, *, emb_size: int,
                                  frame_chunk: int = 1) -> torch.Tensor:
    """Plain twin of K4 with the Pallas kernel's casts and order: W h, the
    scores and ctx in f32; ctx summed per chunk of ``frame_chunk`` frames
    and each chunk's sum added to the running ctx; ctx / L cast to dtype
    before its gate product; emb and h read in dtype; h' computed in f32
    and stored in dtype."""
    _check((emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh, bias3),
           emb_size, frame_chunk)
    f32, dtype = torch.float32, h.dtype
    E, L = emb_size, enc.shape[1]
    H = h.shape[-1]
    h32 = h.to(f32)
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
    ctx = (ctx / L).to(dtype).to(f32)
    w32 = w_ih.to(f32)
    gi = emb.to(f32) @ w32[:E] + ctx @ w32[E:] + bias3[0].to(f32)
    gh = h32 @ w_hh.to(f32) + bias3[1].to(f32)
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return ((1.0 - z) * n + z * h32).to(dtype)


def _library() -> ctypes.CDLL:
    lib = build.load("fused_step")
    if getattr(lib, "_recnet_bound", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.recnet_fused_step.argtypes = [i] + [p] * 11 + [i] * 7 + [p]
    lib.recnet_fused_step.restype = i
    lib.recnet_cuda_error_string.argtypes = [i]
    lib.recnet_cuda_error_string.restype = ctypes.c_char_p
    lib._recnet_bound = True
    return lib


def fused_gru_attn_step(emb: torch.Tensor, h: torch.Tensor,
                        enc: torch.Tensor, uv: torch.Tensor,
                        attn_w: torch.Tensor, attn_v: torch.Tensor,
                        attn_b: torch.Tensor, w_ih: torch.Tensor,
                        w_hh: torch.Tensor, bias3: torch.Tensor, *,
                        emb_size: int, frame_chunk: int = 1) -> torch.Tensor:
    """K4: one fused decoder step.

    emb (B, E); h (B, H); enc (B, L, F); uv (B, L, A); attn_w (H, A);
    attn_v (A, 1); attn_b (1, A); w_ih (E + F, 3H); w_hh (H, 3H); bias3
    (2, 3H) from ``pack_gru_bias``; all float32 or all bfloat16. Returns h'
    (B, H) in h's dtype. ``frame_chunk`` frames are summed into ctx at a
    time, as the Pallas grid's frame axis does; L must divide by it.
    Any B: a block of the kernel owns 8 rows and masks the ragged tail."""
    ops = (emb, h, enc, uv, attn_w, attn_v, attn_b, w_ih, w_hh, bias3)
    device = enc.device
    if device.type == "cpu":
        return fused_gru_attn_step_reference(
            *ops, emb_size=emb_size, frame_chunk=frame_chunk)
    if device.type != "cuda":
        raise ValueError(f"no fused-step route for {device}")
    _check(ops, emb_size, frame_chunk)
    for name, t in zip(_OPERANDS, ops):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, enc on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_sm90(device, "fused-step")
    B, L, F = enc.shape
    H, A = attn_w.shape
    h_out = torch.empty_like(h)
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.recnet_fused_step(
            _DTYPE_CODES[h.dtype], *(ptr(t) for t in ops), ptr(h_out), B, L,
            F, A, emb_size, H, frame_chunk, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"fused-step kernel launch failed: "
            f"{lib.recnet_cuda_error_string(err).decode()} ({err})")
    fused_gru_attn_step.n_launches += 1
    return h_out


fused_gru_attn_step.n_launches = 0
