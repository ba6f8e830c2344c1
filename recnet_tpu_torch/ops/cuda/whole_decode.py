"""The greedy whole-decode on Hopper: wrappers of ``csrc/whole_decode.cu``,
``csrc/whole_decode_tf32.cu`` (and their probe sources) and their
plain-PyTorch twins.

Counterpart of ``recnet_tpu/ops/pallas/whole_decode.py``:

* ``whole_greedy_decode`` (K1) runs the whole T-step greedy loop in one
  launch and returns tokens (B, T); its keywords ``early_exit``, ``dual``
  and ``ablate`` select the K5 variants of the same kernel, and
  ``cuda_cores`` the CUDA-core body for any of them;
* ``whole_greedy_decode_segment`` (K2) runs ``seg_len`` steps from a
  carried (h, c, token) and returns (tokens (B, seg_len), h, c, token).

Both launch one CUDA kernel (K1 from a zero state and <SOS>) on one of
three bodies, chosen by ``kernel_route``: every bf16 launch with H a
multiple of 16 runs on the tensor-core body, production, the early exit and
the K5 probes ``dual`` and ``ablate`` alike (the probes from a library of
their own, ``whole_decode_probes``); every f32 launch with H a multiple of
16 whose buffers fit a block runs on the TF32 body
(``csrc/whole_decode_tf32.cuh``: three-term TF32 products on the tensor
cores, a tile of 8 rows (16 under ``dual``) spread over a cluster of
``cluster_size`` blocks; the probes from ``whole_decode_tf32_probes``);
f32 and bf16 with other H, f32 the TF32 body cannot hold, and any launch
asked for with ``cuda_cores`` run on the CUDA-core body. ``dual`` on the
tensor-core and TF32 bodies takes 16 rows a tile as two 8-row halves that
share each weight tile read from L2, half the production step's L2 bytes a
row; each SM's own read stream, not the L2 bytes in total, bounds the
decode, so on the tensor-core body it takes production's time where both
fit one wave (B = 1024 on an H100) and gains where production needs two
(B = 2048: 0.58 of its time). The ``ablate`` parts split the production
step by phase (full - variant).
A build or launch failure on any body raises; nothing falls back to
another body or to the twin. A wrapper launches the kernel for CUDA tensors
and raises on anything the kernel does not take; for CPU tensors it runs
its plain twin (``*_reference``), which mirrors the Pallas step's casts in
plain PyTorch. Each wrapper counts its launches in ``n_launches`` and by
body in ``body_launches``; K1 counts its K5 variants apart, in
``variant_launches``, each under its name and, on the CUDA-core body, with
"[cuda_cores]" after it.

Unlike the Pallas wrappers there is no ``block_b``: a block owns 8 rows (16
under ``dual`` on the tensor-core and TF32 bodies) and masks the ragged
tail, so any B works.
``emb_scale`` multiplies the gathered embedding row, as ``decoder_step``
does (the Pallas step leaves it out, which is exact only at the shipped
scale 1.0). A token outside [0, V) gathers a zero embedding row, as the
Pallas one-hot product does.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from recnet_tpu_torch.ops.cuda import build
from recnet_tpu_torch.ops.cuda import layout

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_N_GATES = {"GRU": 3, "LSTM": 4}
ROWS_PER_BLOCK = 8     # the kernel's tile: the early exit stops per block

# the kernel's variant bits (csrc/whole_decode_tc.cuh)
_EARLY_EXIT, _DUAL, _ABL_EMB, _TENSOR_CORES = 1, 2, 4, 256
_ABL_ATTN_SHIFT, _ABL_PROJ_SHIFT = 3, 5
_BUILT_VARIANTS = frozenset(
    [0, _EARLY_EXIT, _DUAL, _ABL_EMB]
    + [m << _ABL_ATTN_SHIFT for m in (1, 2, 3)]
    + [m << _ABL_PROJ_SHIFT for m in (1, 2, 3)])

# the three bodies (``kernel_route``)
TENSOR_CORES, CUDA_CORES, TF32 = "tensor_cores", "cuda_cores", "tf32"
# Whether f32 takes the TF32 body (else the CUDA-core body, the first
# design). A fixed rule, not a fallback: the TF32 body took 4.0-4.1 ms a
# flagship decode at the eval batch (B = 100) against 22.1-22.3, and
# 16.2-16.9 at B = 1024 against 23.7-24.1, on the H100 (chip_smoke.py
# [times]); the two give the same tokens up to the sum order.
F32_ON_TF32 = True
MAX_CLUSTER = 8        # the TF32 body's largest cluster (the portable one)
# the shared memory a Hopper block can have, and the tensor-core body's
# warps (csrc/whole_decode_tc.cuh SMEM_LIMIT, NWARPS)
SMEM_LIMIT = 232_448
_TC_WARPS = 16


def _ablated(ablate: str) -> Tuple[bool, int, int]:
    """The substring tests of the Pallas ``_make_step``, in its order:
    (zero embedding, attention mode, projection mode). Attention: 0
    production, 1 ``attn`` (ctx = 0), 2 ``score1`` (score = act[:, 0]), 3
    ``fma`` (ctx = sum_f score_f, not divided by L). Projection: 0
    production, 1 ``proj`` (the token stays), 2 ``nativeargmax`` (plain
    first-max argmax), 3 ``argmax`` (token = int(max logit))."""
    attn = (1 if "attn" in ablate else 2 if "score1" in ablate
            else 3 if "fma" in ablate else 0)
    proj = (1 if "proj" in ablate else 2 if "nativeargmax" in ablate
            else 3 if "argmax" in ablate else 0)
    return "emb" in ablate, attn, proj


def _variant(early_exit: bool, dual: bool, ablate: str) -> int:
    emb, attn, proj = _ablated(ablate)
    return ((_EARLY_EXIT if early_exit else 0) | (_DUAL if dual else 0)
            | (_ABL_EMB if emb else 0) | attn << _ABL_ATTN_SHIFT
            | proj << _ABL_PROJ_SHIFT)


class Route(NamedTuple):
    """Where a launch goes: the body (TENSOR_CORES or CUDA_CORES), the
    variant bits the C entry point takes, and the library that holds it."""
    body: str
    variant: int
    library: str


def _tensor_cores(dtype: torch.dtype, H: int) -> bool:
    """Whether the tensor-core body takes these operands: bf16 in 16-unit
    tiles."""
    return dtype == torch.bfloat16 and H % 16 == 0


def _tf32(dtype: torch.dtype, H: int) -> bool:
    """Whether the TF32 body takes these operands: f32 in 16-unit tiles."""
    return dtype == torch.float32 and H % 16 == 0


def kernel_route(dtype: torch.dtype, H: int, *, early_exit: bool = False,
                 dual: bool = False, ablate: str = "",
                 cuda_cores: bool = False, tf32_fits: bool = True) -> Route:
    """The body and variant bits of a launch. Every variant (production,
    ``early_exit``, ``dual``, one ``ablate`` part) runs on the tensor-core
    body where it takes the operands (bf16, H % 16 == 0), and in f32 on
    the TF32 body (H % 16 == 0, while ``F32_ON_TF32`` holds and the
    variant's buffers fit a block: ``tf32_fits``, from ``tf32_smem_bytes``;
    not at H = 1536, say), unless ``cuda_cores`` asks for the CUDA-core
    body, which takes any of them; the probes (``dual``, ``ablate``) live
    in the libraries ``whole_decode_probes`` and
    ``whole_decode_tf32_probes``. f32 the TF32 body does not take runs on
    the CUDA-core body, by this rule and never after a failure. Raises
    ``ValueError`` on options the kernel is not built for."""
    _check_options(early_exit, dual, ablate)
    variant = _variant(early_exit, dual, ablate)
    if variant not in _BUILT_VARIANTS:
        raise ValueError("the kernel is built for one ablated part at a "
                         "time (emb, attn, score1, fma, proj, nativeargmax, "
                         "argmax)")
    probe = (variant & ~_EARLY_EXIT) != 0
    if not cuda_cores and F32_ON_TF32 and _tf32(dtype, H) and tf32_fits:
        return Route(TF32, variant, "whole_decode_tf32_probes" if probe
                     else "whole_decode_tf32")
    if cuda_cores or not _tensor_cores(dtype, H):
        return Route(CUDA_CORES, variant, "whole_decode")
    return Route(TENSOR_CORES, variant | _TENSOR_CORES,
                 "whole_decode_probes" if probe else "whole_decode")


def tc_smem_bytes(n_gates: int, variant: int, L: int, A: int, K: int,
                  H: int) -> int:
    """The tensor-core body's shared memory in bytes (K = E + F): the rows'
    buffers, 8 rows or 16 under ``dual``, and each warp's ring of weight
    tiles, 4 slots (3 for an LSTM under ``dual``). Mirrors ``TcSmem`` in
    ``csrc/whole_decode_tc.cuh`` (``recnet_whole_decode_tc_smem``)."""
    rows = 2 * ROWS_PER_BLOCK if variant & _DUAL else ROWS_PER_BLOCK
    slots = 3 if variant & _DUAL and n_gates == 4 else 4
    ld = lambda n: -(-n // 64) * 64 + 8    # whole k16 steps, +8
    align16 = lambda n: -(-n // 16) * 16
    o = 0
    for nbytes in (2 * rows * ld(K),       # x = [emb, ctx]
                   2 * 2 * rows * ld(H),   # h, double-buffered
                   2 * rows * H,           # c
                   4 * rows * A,           # W h
                   4 * 2 * A,              # attn w, b
                   4 * rows * L,           # scores
                   4 * 2 * _TC_WARPS * rows,   # argmax reduction
                   4 * rows):              # tokens
        o = align16(o + nbytes)
    return o + 2 * _TC_WARPS * slots * n_gates * 256


def check_tc_fits(n_gates: int, variant: int, L: int, A: int, K: int,
                  H: int) -> int:
    """The tensor-core body's shared memory for these shapes; raises
    ``ValueError`` where a block cannot have it."""
    need = tc_smem_bytes(n_gates, variant, L, A, K, H)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"the tensor-core body needs {need} bytes of shared memory at "
            f"L={L}, A={A}, E+F={K}, H={H} ({n_gates} gates"
            f"{', dual' if variant & _DUAL else ''}); a Hopper block has "
            f"{SMEM_LIMIT}")
    return need


def tf32_smem_bytes(n_gates: int, L: int, A: int, K: int, H: int,
                    variant: int = 0, E: int = None) -> int:
    """The TF32 body's shared memory in bytes for ``variant`` (K = E + F):
    the rows' f32 buffers (x, h double-buffered, c, W h, scores; row
    strides of 4 mod 32 words over whole k8 steps), the reductions, the
    cluster's exchange of (key, index) and each warp's ring of 4 slots (3
    for an LSTM) of n_gates 512-byte tiles. Under ``dual`` (E needed): 16
    rows, x only from the embedding's last whole k8 step on, one h, no c,
    and 3 slots (2 for an LSTM). Mirrors ``Tf32Smem`` in
    ``csrc/whole_decode_tf32.cuh`` (``recnet_whole_decode_tf32_smem`` for
    production, ``recnet_whole_decode_tf32_variant_smem`` of the probes'
    library for any variant)."""
    dual = bool(variant & _DUAL)
    if dual and E is None:
        raise ValueError("the TF32 body's dual layout depends on E")
    rows = 2 * ROWS_PER_BLOCK if dual else ROWS_PER_BLOCK
    slots = (2 if n_gates == 4 else 3) if dual else (
        3 if n_gates == 4 else 4)
    x0 = E // 8 * 8 if dual else 0
    ld = lambda n: -(-(-(-n // 8) * 8) // 32) * 32 + 4
    align16 = lambda n: -(-n // 16) * 16
    o = 0
    for nbytes in (4 * rows * ld(K - x0),           # x = [emb, ctx] from x0
                   4 * (1 if dual else 2) * rows * ld(H),   # h
                   0 if dual else 4 * rows * H,     # c
                   4 * rows * A,                    # W h
                   4 * 2 * A,                       # attn w, b
                   4 * rows * L,                    # scores
                   4 * 2 * _TC_WARPS * rows,        # argmax
                   4 * 2 * MAX_CLUSTER * rows,      # cluster's best
                   4 * rows):                       # tokens
        o = align16(o + nbytes)
    return o + 4 * _TC_WARPS * slots * n_gates * 128


def check_tf32_fits(n_gates: int, L: int, A: int, K: int, H: int,
                    variant: int = 0, E: int = None) -> int:
    """The TF32 body's shared memory for these shapes and ``variant``;
    raises ``ValueError`` where a block cannot have it."""
    need = tf32_smem_bytes(n_gates, L, A, K, H, variant, E)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"the TF32 body needs {need} bytes of shared memory at L={L}, "
            f"A={A}, E+F={K}, H={H} ({n_gates} gates"
            f"{', dual' if variant & _DUAL else ''}); a Hopper block has "
            f"{SMEM_LIMIT}")
    return need


def cluster_size(B: int, H: int, n_sms: int,
                 rows: int = ROWS_PER_BLOCK) -> int:
    """Blocks of the TF32 body's cluster that share one tile of ``rows``
    rows (8, or 16 under ``dual``): the largest C of 8, 4, 2 with
    ceil(B / rows) C blocks at most the card's SM count and C at most the
    H / 16 unit tiles; else 1. At the flagship (H = 512) on 132 SMs, 8-row
    tiles: 8 up to B = 128 (the eval batch B = 100: 13 tiles, 104 blocks),
    4 up to 264, 2 up to 528, 1 beyond (B = 1024); 16-row tiles: 8 up to
    256 (B = 100: 7 tiles, 56 blocks), 4 up to 528, 2 up to 1056 (B =
    1024: 64 tiles, 128 blocks), 1 beyond (B = 2048)."""
    tiles = -(-B // rows)
    for C in (8, 4, 2):
        if C <= MAX_CLUSTER and C <= H // 16 and tiles * C <= n_sms:
            return C
    return 1


def _variant_name(early_exit: bool, dual: bool, ablate: str,
                  cuda_cores: bool = False, body: str = TENSOR_CORES) -> str:
    """The key of ``variant_launches``: "early_exit", "dual" or
    "ablate=<part>", followed by "[cuda_cores]" where it ran on the
    CUDA-core body and "[tf32]" on the TF32 body; "cuda_cores" for the
    production step asked for on that body; "" is the production kernel."""
    name = ("early_exit" if early_exit else "dual" if dual
            else f"ablate={ablate}" if _variant(False, False, ablate)
            else "")
    if not name:
        return "cuda_cores" if cuda_cores else ""
    return {CUDA_CORES: f"{name}[cuda_cores]",
            TF32: f"{name}[tf32]"}.get(body, name)


def _check_options(early_exit: bool, dual: bool, ablate: str) -> None:
    if dual and (early_exit or ablate):
        raise ValueError("dual=True does not support early_exit or ablate")


_COUNT_LOCK = threading.Lock()


def _library(name: str = "whole_decode") -> ctypes.CDLL:
    """The built library ``name``: "whole_decode" (production, the early
    exit, the CUDA-core probes), "whole_decode_probes" (the tensor-core
    probes), "whole_decode_tf32" (the TF32 body's production and early
    exit) or "whole_decode_tf32_probes" (its probes), bound at first
    use."""
    lib = build.load(name)
    if getattr(lib, "_recnet_bound", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    args = [i, i, i] + [p] * 18 + [i] * 8 + [ctypes.c_float, p]
    if name.startswith("whole_decode_tf32"):
        entry = (lib.recnet_whole_decode_tf32_probe
                 if name == "whole_decode_tf32_probes"
                 else lib.recnet_whole_decode_tf32)
        entry.argtypes = [i, i, i] + [p] * 17 + [i] * 8 + [ctypes.c_float, p]
        entry.restype = i
        lib.recnet_tf32_error_string.argtypes = [i]
        lib.recnet_tf32_error_string.restype = ctypes.c_char_p
        if name == "whole_decode_tf32_probes":
            smem = lib.recnet_whole_decode_tf32_variant_smem
            smem.argtypes, smem.restype = [i] * 7, ctypes.c_longlong
            lib._recnet_bound = True
            return lib
        lib.recnet_whole_decode_tf32_smem.argtypes = [i] * 5
        lib.recnet_whole_decode_tf32_smem.restype = ctypes.c_longlong
        lib.recnet_whole_decode_tf32_out_group.argtypes = []
        lib.recnet_whole_decode_tf32_out_group.restype = i
        if lib.recnet_whole_decode_tf32_out_group() != layout.PROJ_GROUP:
            raise RuntimeError(
                f"the TF32 body's out_w column group "
                f"{lib.recnet_whole_decode_tf32_out_group()} != "
                f"layout.PROJ_GROUP {layout.PROJ_GROUP}")
        lib._recnet_bound = True
        return lib
    if name == "whole_decode_probes":
        lib.recnet_whole_decode_probe.argtypes = args
        lib.recnet_whole_decode_probe.restype = i
        lib._recnet_bound = True
        return lib
    lib.recnet_whole_decode.argtypes = args
    lib.recnet_whole_decode.restype = i
    lib.recnet_whole_decode_out_group.argtypes = []
    lib.recnet_whole_decode_out_group.restype = i
    lib.recnet_whole_decode_tc_smem.argtypes = [i] * 6
    lib.recnet_whole_decode_tc_smem.restype = ctypes.c_longlong
    lib.recnet_cuda_error_string.argtypes = [i]
    lib.recnet_cuda_error_string.restype = ctypes.c_char_p
    if lib.recnet_whole_decode_out_group() != layout.PROJ_GROUP:
        raise RuntimeError(
            f"the kernel's out_w column group "
            f"{lib.recnet_whole_decode_out_group()} != layout.PROJ_GROUP "
            f"{layout.PROJ_GROUP}")
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


@functools.lru_cache(maxsize=None)
def _capability(device: torch.device) -> Tuple[int, int]:
    return torch.cuda.get_device_capability(device)


def check_sm90(device: torch.device, what: str) -> None:
    major, minor = _capability(device)
    if major != 9:
        raise RuntimeError(
            f"the {what} kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is sm_{major}{minor}")


def _launch(params, enc, uv, bias2, h, c, token, *, emb_size: int,
            n_steps: int, cell_type: str, emb_scale: float, route: Route,
            cluster: int = None):
    """Run the CUDA kernel for ``n_steps`` steps on ``route``; returns
    (tokens (B, n_steps), h, c, token (B, 1)). Token columns a block never
    reached (early exit) read 0. ``cluster``: the TF32 body's blocks a
    tile (``cluster_size`` when None)."""
    device, dtype = enc.device, enc.dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {dtype}")
    if cell_type not in _N_GATES:
        raise ValueError(f"the kernel takes a GRU or LSTM, not {cell_type!r}")
    check_sm90(device, "whole-decode")
    emb, W, w, b, w_ih, w_hh, out_w, out_b = _weights(params)
    _check_cuda(dict(enc=enc, uv=uv, embedding=emb, attn_W=W, attn_w=w,
                     attn_b=b, w_ih=w_ih, w_hh=w_hh, bias2=bias2,
                     out_w=out_w, out_b=out_b, h=h, c=c, token=token),
                dtype, device)
    B, L, F = enc.shape
    V, E = emb.shape
    H, A = W.shape
    n_gates = _N_GATES[cell_type]
    G = n_gates * H
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
    if route.body == TF32:
        return _launch_tf32(params, enc, uv, bias2, h, c, token, route,
                            n_gates, E, n_steps, emb_scale, cluster)
    lib = _library()
    entry = lib.recnet_whole_decode
    if route.body == TENSOR_CORES:
        check_tc_fits(n_gates, route.variant, L, A, E + F, H)
        if route.library != "whole_decode":
            entry = _library(route.library).recnet_whole_decode_probe
        # the body reads weight tiles: the parameter set's, made where it
        # was built, or made for this call
        tiles = params.get("layouts") or {}
        if "gates" not in tiles:
            tiles = layout.decode_tiles(params)
        w_ih, W, out_w = tiles["gates"], tiles["attn_W"], tiles["out_w"]

    tokens = torch.zeros((B, n_steps), dtype=torch.int32, device=device)
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    tok_out = torch.empty((B, 1), dtype=torch.int32, device=device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(
            _DTYPE_CODES[dtype], n_gates, route.variant, ptr(enc),
            ptr(uv), ptr(emb), ptr(W), ptr(w), ptr(b), ptr(w_ih), ptr(w_hh),
            ptr(bias2), ptr(out_w), ptr(out_b), ptr(h), ptr(c), ptr(token),
            ptr(tokens), ptr(h_out), ptr(c_out), ptr(tok_out), B, L, F, A,
            E, H, V, n_steps, ctypes.c_float(emb_scale),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"whole-decode kernel launch failed ({route.body} body): "
            f"{lib.recnet_cuda_error_string(err).decode()} ({err})")
    return tokens, h_out, c_out, tok_out


def _launch_tf32(params, enc, uv, bias2, h, c, token, route: Route,
                 n_gates: int, E: int, n_steps: int, emb_scale: float,
                 cluster: int = None):
    """``_launch`` on the TF32 body, its operands checked there: the f32
    tiles (the parameter set's, or made for this call) and the cluster."""
    device = enc.device
    B, L, F = enc.shape
    H, A = params["attention"]["W"].shape
    V = params["out_w"].shape[1]
    check_tf32_fits(n_gates, L, A, E + F, H, route.variant, E)
    if cluster is None:
        cluster = cluster_size(B, H, torch.cuda.get_device_properties(
            device).multi_processor_count, 2 * ROWS_PER_BLOCK
            if route.variant & _DUAL else ROWS_PER_BLOCK)
    if cluster not in (1, 2, 4, 8) or cluster > H // 16:
        raise ValueError(f"cluster {cluster}: the TF32 body takes 1, 2, 4 or "
                         f"8 blocks a tile, at most H / 16 = {H // 16}")
    tiles = params.get("layouts") or {}
    if "gates" not in tiles or tiles["gates"].dtype != torch.float32:
        tiles = layout.decode_tiles(params)
    for name, t in (("gates", tiles["gates"]), ("attn_W", tiles["attn_W"]),
                    ("out_w", tiles["out_w"])):
        if (t.dtype != torch.float32 or t.device != device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"the TF32 body's {name} tiles must be "
                             f"contiguous f32 on {device}, 16-byte aligned")
    lib = _library(route.library)
    entry = (lib.recnet_whole_decode_tf32_probe
             if route.library == "whole_decode_tf32_probes"
             else lib.recnet_whole_decode_tf32)
    tokens = torch.zeros((B, n_steps), dtype=torch.int32, device=device)
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    tok_out = torch.empty((B, 1), dtype=torch.int32, device=device)
    a = params["attention"]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(
            n_gates, route.variant, cluster, ptr(enc), ptr(uv),
            ptr(params["embedding"]), ptr(tiles["attn_W"]), ptr(a["w"]),
            ptr(a["b"]), ptr(tiles["gates"]), ptr(bias2),
            ptr(tiles["out_w"]), ptr(params["out_b"]), ptr(h), ptr(c),
            ptr(token), ptr(tokens), ptr(h_out), ptr(c_out), ptr(tok_out),
            B, L, F, A, E, H, V, n_steps, ctypes.c_float(emb_scale),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"whole-decode kernel launch failed (tf32 body, cluster "
            f"{cluster}): {lib.recnet_tf32_error_string(err).decode()} "
            f"({err})")
    return tokens, h_out, c_out, tok_out


def _operand_route(params: Dict, enc: torch.Tensor, emb_size: int,
                   cell_type: str, early_exit: bool = False,
                   dual: bool = False, ablate: str = "",
                   cuda_cores: bool = False) -> Route:
    """``kernel_route`` for these operands: whether the TF32 body's buffers
    fit a block, for the variant asked for, is read from their shapes."""
    H, A = params["attention"]["W"].shape
    L, F = enc.shape[1], enc.shape[2]
    _check_options(early_exit, dual, ablate)
    fits = (tf32_smem_bytes(_N_GATES.get(cell_type, 4), L, A, emb_size + F,
                            H, _variant(early_exit, dual, ablate), emb_size)
            <= SMEM_LIMIT)
    return kernel_route(enc.dtype, H, early_exit=early_exit, dual=dual,
                        ablate=ablate, cuda_cores=cuda_cores, tf32_fits=fits)


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: the low
    13 mantissa bits to nearest, ties away from zero (finite values)."""
    bits = x.float().contiguous().view(torch.int32).long()
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32).view(x.shape)


def matmul_3xtf32_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A plain model of the TF32 body's products: each f32 operand split as
    hi = tf32(x), lo = tf32(x - hi), and a @ b as a_lo b_hi + a_hi b_lo +
    a_hi b_hi (the products of TF32 values are exact in f32; the sums
    here are f32, in matmul's order). For tests and chip_smoke.py."""
    a, b = a.float(), b.float()
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _embedding_rows(emb: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Rows of ``emb`` for token (B, 1); a token outside [0, V) gives a
    zero row, as the Pallas one-hot product does."""
    tk = token[:, 0].long()
    ok = (tk >= 0) & (tk < emb.shape[0])
    rows = emb[tk.clamp(0, emb.shape[0] - 1)]
    return torch.where(ok[:, None], rows, torch.zeros_like(rows))


def _live_tiles(token: torch.Tensor) -> torch.Tensor:
    """(B, 1): whether the row's tile of ``ROWS_PER_BLOCK`` rows (the
    kernel's block) still holds a token other than 0."""
    B, R = token.shape[0], ROWS_PER_BLOCK
    nonzero = torch.zeros(-(-B // R) * R, dtype=torch.bool,
                          device=token.device)
    nonzero[:B] = token[:, 0] != 0
    return nonzero.view(-1, R).any(dim=1).repeat_interleave(R)[:B, None]


def _decode_reference(params, enc, uv, bias2, h, c, token, *, emb_size: int,
                      n_steps: int, cell_type: str, emb_scale: float,
                      ablate: str = "", early_exit: bool = False,
                      matmul=torch.matmul):
    """``n_steps`` greedy steps in plain PyTorch with the casts of the
    Pallas step (``_make_step``): dtype operands, f32 accumulation (a
    product of dtype values widened to f32), ctx cast to dtype before its
    gate product, h and c computed in f32 and stored in dtype. ``ablate``
    stubs parts as ``_make_step`` does. With ``early_exit`` a tile of
    ``ROWS_PER_BLOCK`` rows stops once all its tokens are 0 (the token
    freezes, so its later columns read 0), and the loop ends when every
    tile has stopped. ``matmul`` computes the products with the weights (W
    h, the gates, the logits): a model of a kernel's products in tests,
    ``matmul_3xtf32_reference`` for the TF32 body's."""
    f32 = torch.float32
    dtype = enc.dtype
    emb, W, w, b, w_ih, w_hh, out_w, out_b = _weights(params)
    E, H, L = emb_size, W.shape[0], enc.shape[1]
    W, w, b = W.to(f32), w.to(f32), b.to(f32)
    w_emb, w_ctx = w_ih[:E].to(f32), w_ih[E:].to(f32)
    w_hh, out_w, out_b = w_hh.to(f32), out_w.to(f32), out_b.to(f32)
    b_ih, b_hh = bias2[0].to(f32), bias2[1].to(f32)
    enc_f, uv_f = enc.to(f32), uv.to(f32)
    no_emb, attn, proj = _ablated(ablate)

    toks = torch.zeros((enc.shape[0], n_steps), dtype=torch.int32,
                       device=enc.device)
    for t in range(n_steps):
        if early_exit:
            live = _live_tiles(token)
            if not bool(live.any()):
                break
        if no_emb:
            e = torch.zeros((enc.shape[0], E), dtype=f32, device=enc.device)
        else:
            e = (_embedding_rows(emb, token).to(f32)
                 * emb_scale).to(dtype).to(f32)
        h32 = h.to(f32)
        ctx = torch.zeros_like(enc_f[:, 0])
        if attn != 1:
            act = torch.tanh(matmul(h32, W)[:, None, :] + uv_f + b)
            score = act[:, :, :1] if attn == 2 else act @ w      # (B, L, 1)
            if attn == 3:
                acc = torch.zeros_like(score[:, 0])
                for f in range(L):
                    acc = acc + score[:, f]
                ctx = ctx + acc
            else:
                for f in range(L):
                    ctx = ctx + score[:, f] * enc_f[:, f]
                ctx = ctx / L
        ctx = ctx.to(dtype).to(f32)
        gi = matmul(e, w_emb) + matmul(ctx, w_ctx) + b_ih
        gh = matmul(h32, w_hh) + b_hh
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
        new = token
        if proj != 1:
            logits = matmul(h.to(f32), out_w) + out_b
            if proj == 2:      # first max; -0.0 ties +0.0
                new = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
            elif proj == 3:    # int(max logit), often outside [0, V)
                new = logits.max(dim=-1, keepdim=True).values.to(torch.int32)
            else:
                new = _intkey_argmax(logits)
        token = torch.where(live, new, token) if early_exit else new
        toks[:, t] = token[:, 0]
    return toks, h, c, token


def whole_greedy_decode_reference(params: Dict, enc: torch.Tensor,
                                  uv: torch.Tensor, bias2: torch.Tensor, *,
                                  emb_size: int, max_len: int, sos: int = 1,
                                  cell_type: str = "GRU",
                                  emb_scale: float = 1.0,
                                  early_exit: bool = False,
                                  dual: bool = False,
                                  ablate: str = "") -> torch.Tensor:
    """Plain twin of K1 and its K5 variants: tokens (B, max_len + 1) int32.

    ``early_exit`` stops each tile of ``ROWS_PER_BLOCK`` rows (the kernel's
    block; JAX's ``block_b=8``) once all its tokens are 0. ``dual`` computes
    what the production kernel does. ``ablate`` as in JAX."""
    _check_options(early_exit, dual, ablate)
    B, H = enc.shape[0], params["attention"]["W"].shape[0]
    z = torch.zeros((B, H), dtype=enc.dtype, device=enc.device)
    tok = torch.full((B, 1), sos, dtype=torch.int32, device=enc.device)
    return _decode_reference(params, enc, uv, bias2, z, z, tok,
                             emb_size=emb_size, n_steps=max_len + 1,
                             cell_type=cell_type, emb_scale=emb_scale,
                             ablate=ablate, early_exit=early_exit)[0]


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
                        emb_scale: float = 1.0, early_exit: bool = False,
                        dual: bool = False, ablate: str = "",
                        cuda_cores: bool = False,
                        cluster: int = None) -> torch.Tensor:
    """K1: the whole greedy decode in one launch.

    params: decoder params (embedding, attention{W,w,b}, rnn[0], out_w,
    out_b); enc (B, L, F); uv (B, L, A); bias2 (2, nG*H) = [b_ih, b_hh].
    Returns tokens (B, max_len + 1) int32.

    The K5 variants, as in JAX: ``early_exit`` stops a block of 8 rows
    once all its tokens are 0 (the Pallas condition: 0, not the config's
    <PAD>), later columns reading 0; ``dual`` runs each block as two
    row-halves with the production tokens (tensor-core and TF32 bodies:
    two 8-row halves sharing each weight tile, bit-equal to production;
    CUDA-core body: two 4-row halves on their own barriers); ``ablate``
    (profiling) stubs parts of the step:
    "emb", "attn" / "score1" / "fma", "proj" / "nativeargmax" / "argmax",
    one part at a time on the card (the twin takes any comma-joined set).
    ``dual`` with ``early_exit`` or ``ablate`` raises ``ValueError``.

    The body (``kernel_route``): bf16 with H % 16 == 0 runs every variant
    on the tensor-core body; f32 with H % 16 == 0 every variant whose
    buffers fit a block on the TF32 body; the rest on the CUDA-core body;
    ``cuda_cores`` asks for the CUDA-core body for any variant (the first
    design, kept as the redesigns' baseline: the same tokens up to the sum
    order). The tensor-core and TF32 bodies read the tiles in
    ``params["layouts"]`` (see ``layout.kernel_layouts``), or make them
    for the call where they are missing; a launch whose shared memory a
    block cannot have raises ``ValueError``. ``cluster`` sets the TF32
    body's blocks a tile (``cluster_size`` of its 8 or, under ``dual``, 16
    rows when None)."""
    _check_options(early_exit, dual, ablate)
    kw = dict(emb_size=emb_size, cell_type=cell_type, emb_scale=emb_scale)
    if _device_route(enc) == "cpu":
        return whole_greedy_decode_reference(
            params, enc, uv, bias2, max_len=max_len, sos=sos,
            early_exit=early_exit, dual=dual, ablate=ablate, **kw)
    B, H = enc.shape[0], params["attention"]["W"].shape[0]
    route = _operand_route(params, enc, emb_size, cell_type,
                           early_exit=early_exit, dual=dual, ablate=ablate,
                           cuda_cores=cuda_cores)
    V = params["embedding"].shape[0]
    if not 0 <= sos < V:
        raise ValueError(f"sos token {sos} outside the vocab of {V}")
    z = torch.zeros((B, H), dtype=enc.dtype, device=enc.device)
    tok = torch.full((B, 1), sos, dtype=torch.int32, device=enc.device)
    tokens = _launch(params, enc, uv, bias2, z, z, tok,
                     n_steps=max_len + 1, route=route, cluster=cluster,
                     **kw)[0]
    name = _variant_name(early_exit, dual, ablate, cuda_cores, route.body)
    with _COUNT_LOCK:         # a mesh Captioner's shards launch from threads
        if name:
            whole_greedy_decode.variant_launches[name] += 1
        else:
            whole_greedy_decode.n_launches += 1
        whole_greedy_decode.body_launches[route.body] += 1
    return tokens


whole_greedy_decode.n_launches = 0
whole_greedy_decode.variant_launches = collections.Counter()
whole_greedy_decode.body_launches = collections.Counter()


def whole_greedy_decode_segment(
        params: Dict, enc: torch.Tensor, uv: torch.Tensor,
        bias2: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
        token: torch.Tensor, *, emb_size: int, seg_len: int,
        cell_type: str = "GRU", emb_scale: float = 1.0,
        cuda_cores: bool = False, cluster: int = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: ``seg_len`` greedy steps from (h, c, token (B, 1) int32).
    Returns (tokens (B, seg_len), h, c, token). The body as K1's
    production step's (``cuda_cores``, ``cluster`` as there)."""
    kw = dict(emb_size=emb_size, cell_type=cell_type, emb_scale=emb_scale)
    if _device_route(enc) == "cpu":
        return whole_greedy_decode_segment_reference(
            params, enc, uv, bias2, h, c, token, seg_len=seg_len, **kw)
    route = _operand_route(params, enc, emb_size, cell_type,
                           cuda_cores=cuda_cores)
    out = _launch(params, enc, uv, bias2, h, c, token, n_steps=seg_len,
                  route=route, cluster=cluster, **kw)
    with _COUNT_LOCK:
        whole_greedy_decode_segment.n_launches += 1
        whole_greedy_decode_segment.body_launches[route.body] += 1
    return out


whole_greedy_decode_segment.n_launches = 0
whole_greedy_decode_segment.body_launches = collections.Counter()
