"""The greedy whole-decode on Hopper: wrappers of ``csrc/whole_decode.cu``
and their plain-PyTorch twins.

Counterpart of ``recnet_tpu/ops/pallas/whole_decode.py``:

* ``whole_greedy_decode`` (K1) runs the whole T-step greedy loop in one
  launch and returns tokens (B, T);
* ``whole_greedy_decode_segment`` (K2) runs ``seg_len`` steps from a
  carried (h, c, token) and returns (tokens (B, seg_len), h, c, token).

Both launch the one CUDA kernel (K1 from a zero state and <SOS>). A wrapper
launches it for CUDA tensors and raises on anything the kernel does not
take; for CPU tensors it runs its plain twin (``*_reference``), which
mirrors the Pallas step's casts in plain PyTorch. Each wrapper counts its
launches in ``n_launches``.

Unlike the Pallas wrappers there is no ``block_b``: a block owns 8 rows and
masks the ragged tail, so any B works. ``emb_scale`` multiplies the gathered
embedding row, as ``decoder_step`` does (the Pallas step leaves it out,
which is exact only at the shipped scale 1.0).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from recnet_tpu_torch.ops.cuda import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_N_GATES = {"GRU": 3, "LSTM": 4}


def _library() -> ctypes.CDLL:
    lib = build.load("whole_decode")
    if getattr(lib, "_recnet_bound", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.recnet_whole_decode.argtypes = ([i, i] + [p] * 18 + [i] * 8
                                        + [ctypes.c_float, p])
    lib.recnet_whole_decode.restype = i
    lib.recnet_cuda_error_string.argtypes = [i]
    lib.recnet_cuda_error_string.restype = ctypes.c_char_p
    lib._recnet_bound = True
    return lib


def _weights(params: Dict):
    a, r = params["attention"], params["rnn"][0]
    return (params["embedding"], a["W"], a["w"], a["b"], r["w_ih"],
            r["w_hh"], params["out_w"], params["out_b"])


def _check_cuda(named: Dict[str, torch.Tensor], dtype: torch.dtype,
                device: torch.device) -> None:
    for name, t in named.items():
        want = torch.int32 if name == "token" else dtype
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, enc on {device}")
        if t.dtype != want:
            raise ValueError(f"{name} is {t.dtype}; the kernel needs {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(params, enc, uv, bias2, h, c, token, *, emb_size: int,
            n_steps: int, cell_type: str, emb_scale: float):
    """Run the CUDA kernel for ``n_steps`` steps; returns
    (tokens (B, n_steps), h, c, token (B, 1))."""
    device, dtype = enc.device, enc.dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {dtype}")
    if cell_type not in _N_GATES:
        raise ValueError(f"the kernel takes a GRU or LSTM, not {cell_type!r}")
    major, minor = torch.cuda.get_device_capability(device)
    if major != 9:
        raise RuntimeError(
            f"the whole-decode kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is sm_{major}{minor}")
    emb, W, w, b, w_ih, w_hh, out_w, out_b = _weights(params)
    _check_cuda(dict(enc=enc, uv=uv, embedding=emb, attn_W=W, attn_w=w,
                     attn_b=b, w_ih=w_ih, w_hh=w_hh, bias2=bias2,
                     out_w=out_w, out_b=out_b, h=h, c=c, token=token),
                dtype, device)
    B, L, F = enc.shape
    V, E = emb.shape
    H, A = W.shape
    G = _N_GATES[cell_type] * H
    shapes = dict(uv=(uv.shape, (B, L, A)), attn_w=(w.shape, (A, 1)),
                  attn_b=(b.shape, (A,)), w_ih=(w_ih.shape, (E + F, G)),
                  w_hh=(w_hh.shape, (H, G)), bias2=(bias2.shape, (2, G)),
                  out_w=(out_w.shape, (H, V)), out_b=(out_b.shape, (V,)),
                  h=(h.shape, (B, H)), c=(c.shape, (B, H)),
                  token=(token.shape, (B, 1)))
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"{name} has shape {tuple(got)}; the kernel "
                             f"needs {want} ({cell_type})")
    if E != emb_size:
        raise ValueError(f"embedding width {E} != emb_size {emb_size}")
    if B < 1 or n_steps < 1:
        raise ValueError(f"empty decode: B={B}, n_steps={n_steps}")

    tokens = torch.empty((B, n_steps), dtype=torch.int32, device=device)
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    tok_out = torch.empty((B, 1), dtype=torch.int32, device=device)
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.recnet_whole_decode(
            _DTYPE_CODES[dtype], _N_GATES[cell_type], ptr(enc), ptr(uv),
            ptr(emb), ptr(W), ptr(w), ptr(b), ptr(w_ih), ptr(w_hh),
            ptr(bias2), ptr(out_w), ptr(out_b), ptr(h), ptr(c), ptr(token),
            ptr(tokens), ptr(h_out), ptr(c_out), ptr(tok_out), B, L, F, A,
            E, H, V, n_steps, ctypes.c_float(emb_scale),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"whole-decode kernel launch failed: "
            f"{lib.recnet_cuda_error_string(err).decode()} ({err})")
    return tokens, h_out, c_out, tok_out


def _device_route(enc: torch.Tensor) -> str:
    if enc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no whole-decode route for {enc.device}")
    return enc.device.type


# --------------------------------------------------------------------------
# plain twins
# --------------------------------------------------------------------------

def _intkey_argmax(logits: torch.Tensor) -> torch.Tensor:
    """First index of the max under the order-preserving int key of f32
    logits (the Pallas kernel's argmax: -0.0 < +0.0). (B, V) -> (B, 1)."""
    bits = logits.float().contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    top = key.max(dim=-1, keepdim=True).values
    V = logits.shape[-1]
    iota = torch.arange(V, dtype=torch.int32, device=logits.device)
    masked = torch.where(key == top, iota, torch.full_like(iota, V))
    return masked.min(dim=-1, keepdim=True).values


def _decode_reference(params, enc, uv, bias2, h, c, token, *, emb_size: int,
                      n_steps: int, cell_type: str, emb_scale: float):
    """``n_steps`` greedy steps in plain PyTorch with the casts of the
    Pallas step (``_make_step``): dtype operands, f32 accumulation (a
    product of dtype values widened to f32), ctx cast to dtype before its
    gate product, h and c computed in f32 and stored in dtype."""
    f32 = torch.float32
    dtype = enc.dtype
    emb, W, w, b, w_ih, w_hh, out_w, out_b = _weights(params)
    E, H, L = emb_size, W.shape[0], enc.shape[1]
    W, w, b = W.to(f32), w.to(f32), b.to(f32)
    w_emb, w_ctx = w_ih[:E].to(f32), w_ih[E:].to(f32)
    w_hh, out_w, out_b = w_hh.to(f32), out_w.to(f32), out_b.to(f32)
    b_ih, b_hh = bias2[0].to(f32), bias2[1].to(f32)
    enc_f, uv_f = enc.to(f32), uv.to(f32)

    toks = []
    for _ in range(n_steps):
        e = (emb[token[:, 0]].to(f32) * emb_scale).to(dtype).to(f32)
        h32 = h.to(f32)
        act = torch.tanh((h32 @ W)[:, None, :] + uv_f + b)     # (B, L, A)
        score = act @ w                                         # (B, L, 1)
        ctx = torch.zeros_like(enc_f[:, 0])
        for f in range(L):
            ctx = ctx + score[:, f] * enc_f[:, f]
        ctx = (ctx / L).to(dtype).to(f32)
        gi = e @ w_emb + ctx @ w_ctx + b_ih
        gh = h32 @ w_hh + b_hh
        if cell_type == "GRU":
            r = torch.sigmoid(gi[:, :H] + gh[:, :H])
            z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
            n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
            h = ((1.0 - z) * n + z * h32).to(dtype)
        elif cell_type == "LSTM":
            g = gi + gh
            c32 = (torch.sigmoid(g[:, H:2 * H]) * c.to(f32)
                   + torch.sigmoid(g[:, :H]) * torch.tanh(g[:, 2 * H:3 * H]))
            h = (torch.sigmoid(g[:, 3 * H:]) * torch.tanh(c32)).to(dtype)
            c = c32.to(dtype)
        else:
            raise ValueError(f"Unknown cell type: {cell_type}")
        token = _intkey_argmax(h.to(f32) @ out_w + out_b)
        toks.append(token)
    return torch.cat(toks, dim=1), h, c, token


def whole_greedy_decode_reference(params: Dict, enc: torch.Tensor,
                                  uv: torch.Tensor, bias2: torch.Tensor, *,
                                  emb_size: int, max_len: int, sos: int = 1,
                                  cell_type: str = "GRU",
                                  emb_scale: float = 1.0) -> torch.Tensor:
    """Plain twin of K1: tokens (B, max_len + 1) int32."""
    B, H = enc.shape[0], params["attention"]["W"].shape[0]
    z = torch.zeros((B, H), dtype=enc.dtype, device=enc.device)
    tok = torch.full((B, 1), sos, dtype=torch.int32, device=enc.device)
    return _decode_reference(params, enc, uv, bias2, z, z, tok,
                             emb_size=emb_size, n_steps=max_len + 1,
                             cell_type=cell_type, emb_scale=emb_scale)[0]


def whole_greedy_decode_segment_reference(
        params: Dict, enc: torch.Tensor, uv: torch.Tensor,
        bias2: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
        token: torch.Tensor, *, emb_size: int, seg_len: int,
        cell_type: str = "GRU", emb_scale: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K2: (tokens (B, seg_len), h, c, token (B, 1))."""
    return _decode_reference(params, enc, uv, bias2, h, c, token,
                             emb_size=emb_size, n_steps=seg_len,
                             cell_type=cell_type, emb_scale=emb_scale)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def whole_greedy_decode(params: Dict, enc: torch.Tensor, uv: torch.Tensor,
                        bias2: torch.Tensor, *, emb_size: int, max_len: int,
                        sos: int = 1, cell_type: str = "GRU",
                        emb_scale: float = 1.0) -> torch.Tensor:
    """K1: the whole greedy decode in one launch.

    params: decoder params (embedding, attention{W,w,b}, rnn[0], out_w,
    out_b); enc (B, L, F); uv (B, L, A); bias2 (2, nG*H) = [b_ih, b_hh].
    Returns tokens (B, max_len + 1) int32."""
    kw = dict(emb_size=emb_size, cell_type=cell_type, emb_scale=emb_scale)
    if _device_route(enc) == "cpu":
        return whole_greedy_decode_reference(params, enc, uv, bias2,
                                             max_len=max_len, sos=sos, **kw)
    B, H = enc.shape[0], params["attention"]["W"].shape[0]
    V = params["embedding"].shape[0]
    if not 0 <= sos < V:
        raise ValueError(f"sos token {sos} outside the vocab of {V}")
    z = torch.zeros((B, H), dtype=enc.dtype, device=enc.device)
    tok = torch.full((B, 1), sos, dtype=torch.int32, device=enc.device)
    tokens = _launch(params, enc, uv, bias2, z, z, tok,
                     n_steps=max_len + 1, **kw)[0]
    whole_greedy_decode.n_launches += 1
    return tokens


whole_greedy_decode.n_launches = 0


def whole_greedy_decode_segment(
        params: Dict, enc: torch.Tensor, uv: torch.Tensor,
        bias2: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
        token: torch.Tensor, *, emb_size: int, seg_len: int,
        cell_type: str = "GRU", emb_scale: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: ``seg_len`` greedy steps from (h, c, token (B, 1) int32).
    Returns (tokens (B, seg_len), h, c, token)."""
    kw = dict(emb_size=emb_size, cell_type=cell_type, emb_scale=emb_scale)
    if _device_route(enc) == "cpu":
        return whole_greedy_decode_segment_reference(
            params, enc, uv, bias2, h, c, token, seg_len=seg_len, **kw)
    out = _launch(params, enc, uv, bias2, h, c, token, n_steps=seg_len, **kw)
    whole_greedy_decode_segment.n_launches += 1
    return out


whole_greedy_decode_segment.n_launches = 0
