"""The embedding gather's backward on Hopper: the wrapper of
``csrc/embedding_backward.cu`` and its plain-PyTorch twin.

For ``rows = table[tokens]`` with tokens (N,) and the rows' cotangent
d_rows (N, E), ``embedding_backward(tokens, d_rows, V)`` returns the
table's gradient (V, E): row v the sum of the rows d_rows[i] with
tokens[i] == v (a negative token counts from the end, as the gather reads
it), zeros where no token reads v. ``parallel.vocab.embed`` sends the
backward of its gather here on a CUDA float32 table that requires grad;
ATen's route (``index_put_`` with accumulate) sums a run of equal tokens on
one warp, row after row, and a caption batch's ``<PAD>`` run is most of it.

The kernel sorts the positions by token (stable), cuts the sorted order
into tiles of ``tile_rows`` positions whatever the runs, sums each run of a
tile in position order, and adds the pieces of a run that crosses tile
edges in tile order: no atomics, the same bits on every call, and no
buffer sized from a count read back from the card. The twin,
``embedding_backward_reference``, sums in the same order, so the two agree
bit for bit.

The wrapper launches the kernel for CUDA tensors (tokens int32 or int64,
d_rows float32 and contiguous, one device, an sm_90 card) and raises on
anything else; for CPU tensors it runs the twin, which counts nothing. It
counts its calls that launch in ``n_launches``: one a call, three kernels
of its own and CUB's sort passes.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from recnet_tpu_torch.ops.cuda import build

TILE_ROWS = 64         # positions a tile: R of csrc/embedding_backward.cu
MAX_TILE_ROWS = 4096   # the tile's keys and positions in shared memory
_TOKEN_DTYPES = (torch.int32, torch.int64)
_COUNT_LOCK = threading.Lock()


def _library() -> ctypes.CDLL:
    lib = build.load("embedding_backward")
    if getattr(lib, "_recnet_bound", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.recnet_embedding_backward_workspace.argtypes = [
        i, i, i, i, ctypes.POINTER(ctypes.c_size_t)]
    lib.recnet_embedding_backward.argtypes = [p, i, p, p, i, i, i, i, p,
                                              ctypes.c_size_t, p]
    for fn in (lib.recnet_embedding_backward_workspace,
               lib.recnet_embedding_backward):
        fn.restype = i
    lib.recnet_embedding_error_string.argtypes = [i]
    lib.recnet_embedding_error_string.restype = ctypes.c_char_p
    lib._recnet_bound = True
    return lib


def _check(tokens: torch.Tensor, d_rows: torch.Tensor, V: int,
           tile_rows: int) -> None:
    """Shapes, types and sizes, for both routes."""
    if tokens.dim() != 1 or d_rows.dim() != 2:
        raise ValueError(f"tokens (N,) and d_rows (N, E) expected; got "
                         f"{tuple(tokens.shape)} and {tuple(d_rows.shape)}")
    if tokens.shape[0] != d_rows.shape[0]:
        raise ValueError(f"{tokens.shape[0]} tokens for "
                         f"{d_rows.shape[0]} rows")
    if tokens.dtype not in _TOKEN_DTYPES:
        raise ValueError(f"tokens are {tokens.dtype}; int32 or int64 "
                         "expected")
    if d_rows.shape[1] < 1 or V < 1:
        raise ValueError(f"empty table: V={V}, E={d_rows.shape[1]}")
    if not 1 <= tile_rows <= MAX_TILE_ROWS:
        raise ValueError(f"tile_rows={tile_rows} outside 1..{MAX_TILE_ROWS}")
    if tokens.device != d_rows.device:
        raise ValueError(f"tokens on {tokens.device}, d_rows on "
                         f"{d_rows.device}")


def _fold(rows: torch.Tensor, starts: torch.Tensor,
          lengths: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """For each segment (starts, lengths) of ``rows``: ``first`` plus its
    rows added one after another, in order."""
    acc = first.clone()
    for j in range(int(lengths.max()) if lengths.numel() else 0):
        live = lengths > j
        acc[live] = acc[live] + rows[starts[live] + j]
    return acc


def embedding_backward_reference(tokens: torch.Tensor, d_rows: torch.Tensor,
                                 V: int, *,
                                 tile_rows: int = TILE_ROWS) -> torch.Tensor:
    """Plain twin of ``embedding_backward``, the kernel's order: positions
    stably sorted by token, cut into tiles of ``tile_rows``; a piece (a run
    of one token inside a tile) summed from zero in position order; a run's
    pieces added in tile order. d_rows float32 or float64, summed in its
    dtype. Raises IndexError on a token outside [-V, V)."""
    _check(tokens, d_rows, V, tile_rows)
    N, E = d_rows.shape
    out = d_rows.new_zeros((V, E))
    if N == 0:
        return out
    tok = tokens.long()
    tok = torch.where(tok < 0, tok + V, tok)
    if bool((tok < 0).any()) or bool((tok >= V).any()):
        raise IndexError(f"a token outside [-{V}, {V})")
    order = torch.sort(tok, stable=True).indices
    key = tok[order]
    rows = d_rows[order]
    at = torch.arange(N, device=tok.device)
    new_key = torch.ones(N, dtype=torch.bool, device=tok.device)
    new_key[1:] = key[1:] != key[:-1]
    piece_start = torch.nonzero(new_key | (at % tile_rows == 0))[:, 0]
    piece_len = torch.diff(piece_start, append=piece_start.new_tensor([N]))
    pieces = _fold(rows, piece_start, piece_len,
                   d_rows.new_zeros((piece_start.numel(), E)))
    run_start = torch.nonzero(new_key[piece_start])[:, 0]   # piece indices
    run_len = torch.diff(run_start,
                         append=run_start.new_tensor([piece_start.numel()]))
    runs = _fold(pieces, run_start + 1, run_len - 1, pieces[run_start])
    out[key[piece_start[run_start]]] = runs
    return out


def embedding_backward(tokens: torch.Tensor, d_rows: torch.Tensor, V: int,
                       *, tile_rows: int = TILE_ROWS) -> torch.Tensor:
    """The gradient (V, E) of ``table[tokens]`` for the rows' cotangent
    ``d_rows`` (N, E): the kernel for CUDA tensors, the twin for CPU
    tensors. A token outside [-V, V) adds nothing on the card (the gather
    has refused it already)."""
    _check(tokens, d_rows, V, tile_rows)
    if d_rows.device.type == "cpu":
        return embedding_backward_reference(tokens, d_rows, V,
                                            tile_rows=tile_rows)
    if d_rows.device.type != "cuda":
        raise ValueError(f"no embedding backward route for {d_rows.device}")
    if d_rows.dtype != torch.float32:
        raise ValueError(f"d_rows is {d_rows.dtype}; the kernel takes "
                         "float32")
    for name, t in (("tokens", tokens), ("d_rows", d_rows)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    major, minor = torch.cuda.get_device_capability(d_rows.device)
    if major != 9:
        raise RuntimeError(
            f"the embedding backward kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(d_rows.device)} is "
            f"sm_{major}{minor}")
    N, E = d_rows.shape
    out = torch.empty((V, E), dtype=torch.float32, device=d_rows.device)
    if N == 0:
        return out.zero_()
    lib = _library()
    nbytes = ctypes.c_size_t(0)
    with torch.cuda.device(d_rows.device):
        err = lib.recnet_embedding_backward_workspace(
            N, E, V, tile_rows, ctypes.byref(nbytes))
        if err == 0:
            work = torch.empty(nbytes.value, dtype=torch.uint8,
                               device=d_rows.device)
            stream = torch.cuda.current_stream(d_rows.device).cuda_stream
            err = lib.recnet_embedding_backward(
                ctypes.c_void_p(tokens.data_ptr()),
                int(tokens.dtype == torch.int64),
                ctypes.c_void_p(d_rows.data_ptr()),
                ctypes.c_void_p(out.data_ptr()), N, E, V, tile_rows,
                ctypes.c_void_p(work.data_ptr()), nbytes,
                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"embedding backward kernel launch failed: "
            f"{lib.recnet_embedding_error_string(err).decode()} ({err})")
    with _COUNT_LOCK:
        embedding_backward.n_launches += 1
    return out


embedding_backward.n_launches = 0
