"""The train step's float32 matrix products on Hopper tensor cores: the
wrapper of ``csrc/gemm_tf32x3.cu``, its plain-PyTorch twin and the
``torch.autograd.Function`` the step's products take.

``launch(a, b)`` is ``a (M, K) @ b (K, N)`` on the kernel, with an
optional ``bias`` (N,), into a given ``out`` (M, N), or added onto it
(``accumulate``, as ``out.addmm_(a, b)``): each operand split as hi =
tf32(x), lo = tf32(x - hi), a b = a_lo b_hi + a_hi b_lo + a_hi b_hi on
the TF32 tensor cores, the tensor cores' sums added to float32 sums every
32 k (about 2^-21 of |a b| a product;
``whole_decode.matmul_3xtf32_reference`` is the model of these terms). Any
strides with one of each operand's two equal to 1 (else a copy); ragged
shapes; split-K for the weight gradients' small outputs, summed in a fixed
order (the same bits on every call). It takes CUDA float32 tensors and
raises on anything else; there is no fallback.

``mm(a, b)``, with the same arguments, is the step's route: ``launch``
for CUDA float32 tensors whose product fills at least half a wave of the
card (``kernel_pays``: tiles times splits against the SMs), else
``mm_reference``, torch's own product. A product that fills less, such
as the decoder's dh = dg [w_hh | W]^T a step at B 1024 (32 tiles), runs
sooner on cuBLAS's float32 kernels than as a partial wave of this kernel
(0.053 against 0.109 ms on the H100), at float32's own error. CPU tensors
and the bf16 products of autocast take ``mm_reference`` too.

``matmul(x, w, bias)`` is ``x (..., K) @ w (K, N) + bias``: where grad mode
is on and x and w are float32 outside autocast (the train step; decoding
runs under ``no_grad``) it takes ``_Product``, whose forward and backward
(dx = dy w^T, dw = x^T dy) are ``mm``: the kernel on the card, the plain
products on the CPU. Elsewhere ``x @ w + bias`` as torch computes it.

``launch.n_launches`` counts the products that launched the kernel: one
a product, split-K's second pass included.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from recnet_tpu_torch.ops.cuda import build

TILE_M = 128            # kBM of csrc/gemm_tf32x3.cu
TILE_N = 128            # kBN
TILE_K = 32             # kBK: the k of a slot, split-K's granule
SPLIT_MIN_K = 4096      # split-K only over this many k
SPLIT_K_CHUNK = 1024    # a split's least k
SPLIT_MAX = 64
WAVE_FILL = 0.9         # the least share of the last wave a split rule takes
MIN_WAVE = 0.5          # the least share of a wave the kernel takes
_COUNT_LOCK = threading.Lock()


def _library() -> ctypes.CDLL:
    lib = build.load("gemm_tf32x3")
    if getattr(lib, "_recnet_bound", False):
        return lib
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.recnet_gemm_tf32x3.argtypes = [p, q, i, p, q, i, p, q, q, p, q, q,
                                       p, i, i, i, i, i, i, i, i, p]
    lib.recnet_gemm_tf32x3.restype = i
    lib.recnet_gemm_error_string.argtypes = [i]
    lib.recnet_gemm_error_string.restype = ctypes.c_char_p
    lib._recnet_bound = True
    return lib


def _check(a: torch.Tensor, b: torch.Tensor, bias, out) -> None:
    """Shapes and devices, for both routes."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a (M, K) @ b (K, N) expected; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    M, N = a.shape[0], b.shape[1]
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"bias {tuple(bias.shape)} for {N} columns")
    if out is not None and tuple(out.shape) != (M, N):
        raise ValueError(f"out {tuple(out.shape)} for a ({M}, {N}) product")
    for name, t in (("b", b), ("bias", bias), ("out", out)):
        if t is not None and t.device != a.device:
            raise ValueError(f"a on {a.device}, {name} on {t.device}")


def mm_reference(a: torch.Tensor, b: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None,
                 accumulate: bool = False) -> torch.Tensor:
    """Plain twin of ``mm``: torch's own product in the operands' dtype (on
    the card that is float32 on the CUDA cores for float32)."""
    _check(a, b, bias, out)
    if out is None:
        if accumulate:
            raise ValueError("accumulate needs out")
        y = a @ b
        return y if bias is None else y + bias
    if accumulate:
        out.addmm_(a, b)
        if bias is not None:
            out.add_(bias)
    elif bias is None:
        torch.mm(a, b, out=out)
    else:
        torch.addmm(bias, a, b, out=out)
    return out


def _layout(x: torch.Tensor) -> Tuple[torch.Tensor, bool, int]:
    """(x, row_major, ld): element (i, j) of the 2-D ``x`` at i ld + j
    (row-major) or i + j ld; a copy where neither stride is 1."""
    R, C = x.shape
    s0, s1 = x.stride()
    if C == 1 or s1 == 1:
        return x, True, s0 if R > 1 else C
    if R == 1 or s0 == 1:
        return x, False, s1 if C > 1 else R
    x = x.contiguous()
    return x, True, C


def _aligned(x: torch.Tensor, ld: int) -> bool:
    """Whether 16-byte pieces along x's unit stride start aligned."""
    return x.data_ptr() % 16 == 0 and ld % 4 == 0


@functools.lru_cache(maxsize=None)
def splits_for(M: int, N: int, K: int, n_sms: int) -> int:
    """Split-K's split count for a (M, N, K) product on ``n_sms`` SMs: 1
    under SPLIT_MIN_K, else the least count whose last wave of tiles fills
    WAVE_FILL of the SMs (the best count where none does), each split at
    least SPLIT_K_CHUNK of k."""
    if K < SPLIT_MIN_K:
        return 1
    tiles = -(-M // TILE_M) * -(-N // TILE_N)
    best, best_fill = 1, 0.0
    for s in range(1, min(SPLIT_MAX, K // SPLIT_K_CHUNK) + 1):
        blocks = tiles * s
        fill = blocks / (-(-blocks // n_sms) * n_sms)
        if fill >= WAVE_FILL:
            return s
        if fill > best_fill + 1e-9:
            best, best_fill = s, fill
    return best


def split_chunk(K: int, splits: int) -> Tuple[int, int]:
    """(splits, kchunk): k a split in whole TILE_K, and the count that
    covers K with it."""
    if splits <= 1:
        return 1, K
    kchunk = -(-K // splits)
    kchunk = -(-kchunk // TILE_K) * TILE_K
    return -(-K // kchunk), kchunk


def kernel_pays(M: int, N: int, K: int, n_sms: int) -> bool:
    """Whether a (M, N, K) product's blocks (its tiles times split-K's
    splits) fill at least MIN_WAVE of a wave of ``n_sms`` SMs: the
    products ``mm`` launches the kernel for."""
    splits, _ = split_chunk(K, splits_for(M, N, K, n_sms))
    return -(-M // TILE_M) * -(-N // TILE_N) * splits >= MIN_WAVE * n_sms


@functools.lru_cache(maxsize=None)
def _n_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class Plan(NamedTuple):
    """A launch in the kernel's frame: C_k (M x N) = A_k (M x K) B_k (K x
    N). A_k's element (m, k) at a[m a_ld + k] (a_kmajor) or a[m + k a_ld];
    B_k's (k, n) at b[k + n b_ld] (b_kmajor) or b[k b_ld + n]; C_k's at
    out[m c_rs + n c_cs], bias's at bias[m bias_rs + n bias_cs] (element
    offsets from each tensor's first element). ``swapped``: C_k = C^T."""
    a: torch.Tensor
    a_ld: int
    a_kmajor: bool
    b: torch.Tensor
    b_ld: int
    b_kmajor: bool
    c_rs: int
    c_cs: int
    bias_rs: int
    bias_cs: int
    M: int
    N: int
    K: int
    swapped: bool
    splits: int
    kchunk: int
    vec_a: bool
    vec_b: bool


def plan(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
         bias: Optional[torch.Tensor], n_sms: int) -> Plan:
    """The launch of ``a @ b`` into ``out`` (pure Python on the tensors'
    shapes, strides and addresses). A row-major a is K-major, a
    column-major b K-major; a K-major a with an N-major b is swapped
    (C^T = b^T a^T), so that B is K-major: the producer's 16-byte
    stores."""
    M, K = a.shape
    N = b.shape[1]
    a, a_rows, a_ld = _layout(a)
    b, b_rows, b_ld = _layout(b)
    c_rs, c_cs = out.stride()
    bias_rs, bias_cs = 0, (bias.stride(0) if bias is not None else 0)
    a_k, b_k, swapped = a_rows, not b_rows, False
    if a_k and not b_k:
        a, b, a_ld, b_ld = b, a, b_ld, a_ld
        a_k, b_k, swapped = False, True, True
        M, N = N, M
        c_rs, c_cs = c_cs, c_rs
        bias_rs, bias_cs = bias_cs, bias_rs
    splits, kchunk = split_chunk(K, splits_for(M, N, K, n_sms))
    return Plan(a, a_ld, a_k, b, b_ld, b_k, c_rs, c_cs, bias_rs, bias_cs,
                M, N, K, swapped, splits, kchunk, _aligned(a, a_ld),
                _aligned(b, b_ld))


def launch(a: torch.Tensor, b: torch.Tensor, *,
           bias: Optional[torch.Tensor] = None,
           out: Optional[torch.Tensor] = None,
           accumulate: bool = False) -> torch.Tensor:
    """``a @ b`` (+ bias) on the kernel, into ``out`` or onto it
    (``accumulate``): CUDA float32 tensors only."""
    _check(a, b, bias, out)
    for name, t in (("a", a), ("b", b), ("bias", bias), ("out", out)):
        if t is not None and not (t.is_cuda and t.dtype == torch.float32):
            raise ValueError(f"{name} is {t.dtype} on {t.device}: the "
                             "kernel takes CUDA float32 operands")
    if accumulate and out is None:
        raise ValueError("accumulate needs out")
    major, minor = torch.cuda.get_device_capability(a.device)
    if major != 9:
        raise RuntimeError(
            f"the TF32 GEMM is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(a.device)} is sm_{major}{minor}")
    M, K = a.shape
    N = b.shape[1]
    if out is None:
        out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        if not accumulate:
            out.zero_()
            if bias is not None:
                out.add_(bias)
        return out
    pl = plan(a, b, out, bias, _n_sms(a.device))
    ws = (torch.empty((pl.splits, pl.M, pl.N), dtype=torch.float32,
                      device=a.device) if pl.splits > 1 else None)
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.recnet_gemm_tf32x3(
            ptr(pl.a), pl.a_ld, int(pl.a_kmajor), ptr(pl.b), pl.b_ld,
            int(pl.b_kmajor), ptr(out), pl.c_rs, pl.c_cs, ptr(bias),
            pl.bias_rs, pl.bias_cs, ptr(ws), pl.M, pl.N, pl.K, pl.splits,
            pl.kchunk, int(accumulate), int(pl.vec_a), int(pl.vec_b),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"TF32 GEMM launch failed: "
            f"{lib.recnet_gemm_error_string(err).decode()} ({err})")
    with _COUNT_LOCK:
        launch.n_launches += 1
    return out


launch.n_launches = 0


def mm(a: torch.Tensor, b: torch.Tensor, *,
       bias: Optional[torch.Tensor] = None,
       out: Optional[torch.Tensor] = None,
       accumulate: bool = False) -> torch.Tensor:
    """``a @ b`` (+ bias), into ``out`` or onto it (``accumulate``):
    ``launch`` for CUDA float32 tensors where ``kernel_pays``,
    ``mm_reference`` for any other."""
    _check(a, b, bias, out)
    if (a.is_cuda and a.dtype == torch.float32
            and kernel_pays(a.shape[0], b.shape[1], a.shape[1],
                            _n_sms(a.device))):
        return launch(a, b, bias=bias, out=out, accumulate=accumulate)
    return mm_reference(a, b, bias=bias, out=out, accumulate=accumulate)


class _Product(torch.autograd.Function):
    """``x (R, K) @ w (K, N) + bias`` with its gradients, every product
    through ``mm``."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return mm(x, w, bias=bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        return (mm(dy, w.t()) if need_x else None,
                mm(x.t(), dy) if need_w else None,
                dy.sum(0) if ctx.has_bias and need_b else None)


def product_route(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> bool:
    """Whether ``matmul`` takes ``_Product``: float32 operands outside
    autocast with grad mode on."""
    return (torch.is_grad_enabled()
            and not torch.is_autocast_enabled(x.device.type)
            and x.dtype == w.dtype == torch.float32 and w.dim() == 2
            and x.dim() >= 1
            and (bias is None or bias.dtype == torch.float32))


def matmul(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` (+ ``bias`` (N,)), the train step's
    products: through ``_Product`` where ``product_route`` says so, else
    torch's own ``x @ w + bias``."""
    if not product_route(x, w, bias):
        y = x @ w
        return y if bias is None else y + bias
    if x.dim() == 2:
        return _Product.apply(x, w, bias)
    y = _Product.apply(x.reshape(-1, x.shape[-1]), w, bias)
    return y.reshape(*x.shape[:-1], w.shape[1])
