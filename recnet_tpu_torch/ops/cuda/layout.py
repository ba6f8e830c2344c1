"""One-time relayouts of the weights for the tensor-core kernels' copies.

``kernel_layouts`` makes them once per parameter set, where the set is
built: ``weights.params_from_jax`` keeps them as ``params["layouts"]``
(16.5 MB at the flagship width in bf16, 24.4 MB in f32). They are copies
of the weights at that time, so a caller that changes a weight makes
them again. A kernel wrapper given params without them makes them for
that one call.

* ``padded_columns``: the projection + top-k kernel (K3) copies out_w's
  rows in 16-byte pieces (cp.async), which needs every row to start
  16-byte aligned; out_w (H, V) at the flagship V = 4188 has rows of 8376
  bytes, so it gets zero columns up to 4192 (4.3 MB at the flagship
  width, bf16). The kernel masks the columns past V.
* ``gate_tiles`` and ``column_tiles``: the whole-decode kernel's
  tensor-core body (K1/K2) streams 16 x 16 weight tiles, and in the JAX
  input-major layout a tile's rows lie a weight row apart; these copies
  put each tile, and each k16 step of a unit tile's gates, in one
  contiguous block (7.8 MB for w_ih and w_hh, 4.3 MB for out_w, 0.1 MB
  for the attention's W at the flagship width, bf16). The fused step's
  tensor-core route (K4) reads the same gate tiles.
* For f32 params the same keys hold K1/K2's TF32 body's tiles
  (``gate_tiles_f32``, ``column_tiles_f32``: 16 units x 8 inputs a tile, in
  the m16n8k8 A fragment's order; 15.5 MB for w_ih and w_hh, 8.7 MB for
  out_w, 0.3 MB for W at the flagship width) and K3's split route reads
  out_w itself as ``out_w_padded`` (4188 f32 columns are whole 16-byte
  rows).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

_ALIGN_BYTES = 16
# out_w columns that one projection item of K1/K2's tensor-core body reads
# (csrc/whole_decode.cu: 16 * PT); the wrapper checks it against the kernel
PROJ_GROUP = 48


def padded_columns(t: torch.Tensor) -> torch.Tensor:
    """``t`` (rows, cols) with zero columns appended until a row is a
    multiple of 16 bytes; ``t`` itself when it already is."""
    per = _ALIGN_BYTES // t.element_size()
    cols = t.shape[1]
    if cols % per == 0:
        return t
    return torch.nn.functional.pad(t, (0, -cols % per)).contiguous()


def gate_tiles(w_ih: torch.Tensor, w_hh: torch.Tensor,
               n_gates: int) -> torch.Tensor:
    """The gate weights as the whole-decode kernel's tensor-core body reads
    them: w_ih (K, G) with its rows zero-padded to a multiple of 16, then
    w_hh (H, G), cut into 16 x 16 tiles and laid out [H / 16 unit tiles]
    [k16 steps][gate][16 inputs][16 units], so that one k16 step of one
    unit tile's gates is one contiguous block."""
    K, G = w_ih.shape
    H = G // n_gates
    steps = -(-K // 16) + H // 16
    w = torch.zeros((steps * 16, G), dtype=w_ih.dtype, device=w_ih.device)
    w[:K] = w_ih
    w[steps * 16 - H:] = w_hh
    return (w.view(steps, 16, n_gates, H // 16, 16)
            .permute(3, 0, 2, 1, 4).contiguous())


def column_tiles(out_w: torch.Tensor, group: int) -> torch.Tensor:
    """out_w (H, V) with its columns zero-padded to a multiple of
    ``group``, cut into 16 x 16 tiles and laid out [V / group column
    groups][H / 16 k16 steps][group / 16 tiles][16 inputs][16 units], for
    the whole-decode kernel's projection (and, with groups of 16, its
    W h)."""
    H, V = out_w.shape
    n_groups = -(-V // group)
    w = torch.nn.functional.pad(out_w, (0, n_groups * group - V))
    return (w.view(H // 16, 16, n_groups, group // 16, 16)
            .permute(2, 0, 3, 1, 4).contiguous())


def _fragment_order(w: torch.Tensor) -> torch.Tensor:
    """(..., 8 inputs, n, 16 units) -> (..., n, 32 lanes, 4): each 16 x 8
    tile in the order of the mma.sync m16n8k8 A fragment, lane g * 4 + t
    holding (unit g, input t), (g + 8, t), (g, t + 4), (g + 8, t + 4)."""
    lead = w.shape[:-3]
    n = w.shape[-2]
    v = w.reshape(*lead, 2, 4, n, 2, 8)   # e_hi, t, n, e_lo, g
    d = len(lead)
    order = (*range(d), d + 2, d + 4, d + 1, d + 0, d + 3)
    return v.permute(order).reshape(*lead, n, 32, 4)


def _fragment_rows(tiles: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_fragment_order``: (..., n, 32 lanes, 4) -> (..., 8
    inputs, n, 16 units)."""
    lead = tiles.shape[:-2]
    n, d = tiles.shape[-3], len(tiles.shape) - 3
    v = tiles.reshape(*lead[:-1], n, 8, 4, 2, 2)   # n, g, t, e_hi, e_lo
    order = (*range(d), d + 3, d + 2, d + 0, d + 4, d + 1)
    return v.permute(order).reshape(*lead[:-1], 8, n, 16)


def gate_tiles_f32(w_ih: torch.Tensor, w_hh: torch.Tensor,
                   n_gates: int) -> torch.Tensor:
    """The gate weights as K1/K2's TF32 body reads them: w_ih (K, G) with
    its rows zero-padded to a multiple of 8, then w_hh (H, G), cut into
    tiles of 16 units x 8 inputs and laid out [H / 16 unit tiles][k8
    steps][gate][32 lanes][4] in the A fragment's order, so that one k8
    step of one unit tile's gates is one contiguous block and each lane's
    16 bytes are its fragment."""
    K, G = w_ih.shape
    H = G // n_gates
    steps = -(-K // 8) + H // 8
    w = torch.zeros((steps * 8, G), dtype=w_ih.dtype, device=w_ih.device)
    w[:K] = w_ih
    w[steps * 8 - H:] = w_hh
    tiles = _fragment_order(w.view(steps, 8, n_gates * H // 16, 16))
    return (tiles.view(steps, n_gates, H // 16, 32, 4)
            .permute(2, 0, 1, 3, 4).contiguous())


def gate_rows_f32(tiles: torch.Tensor) -> torch.Tensor:
    """The weight rows that ``gate_tiles_f32`` tiles hold, (8 k8 steps,
    G): w_ih's rows, zeros up to a multiple of 8, then w_hh's. Its
    inverse, for the plain versions of the kernels that read the tiles."""
    n_ut, steps, n_gates = tiles.shape[:3]
    w = _fragment_rows(tiles.permute(1, 2, 0, 3, 4).reshape(
        steps, n_gates * n_ut, 32, 4))
    return w.reshape(steps * 8, n_gates * n_ut * 16)


def column_tiles_f32(w: torch.Tensor, group: int) -> torch.Tensor:
    """w (H, V) with its columns zero-padded to a multiple of ``group``,
    cut into tiles of 16 columns x 8 inputs and laid out [V / group column
    groups][H / 8 k8 steps][group / 16 tiles][32 lanes][4] in the A
    fragment's order, for the TF32 body's projection (and, with groups of
    16, its W h)."""
    H, V = w.shape
    n_groups = -(-V // group)
    w = torch.nn.functional.pad(w, (0, n_groups * group - V))
    tiles = _fragment_order(w.view(H // 8, 8, n_groups * group // 16, 16))
    return (tiles.view(H // 8, n_groups, group // 16, 32, 4)
            .permute(1, 0, 2, 3, 4).contiguous())


def decode_tiles(params: Dict) -> Dict[str, torch.Tensor]:
    """The tiles K1/K2's tensor-core body (bf16) or TF32 body (f32) reads,
    from the first RNN layer: "gates", "attn_W" (the attention's W) and
    "out_w"."""
    r = params["rnn"][0]
    n_gates = r["w_hh"].shape[1] // r["w_hh"].shape[0]
    if params["out_w"].dtype == torch.float32:
        return {"gates": gate_tiles_f32(r["w_ih"], r["w_hh"], n_gates),
                "attn_W": column_tiles_f32(params["attention"]["W"], 16),
                "out_w": column_tiles_f32(params["out_w"], PROJ_GROUP)}
    return {"gates": gate_tiles(r["w_ih"], r["w_hh"], n_gates),
            "attn_W": column_tiles(params["attention"]["W"], 16),
            "out_w": column_tiles(params["out_w"], PROJ_GROUP)}


def kernel_layouts(params: Dict) -> Optional[Dict[str, torch.Tensor]]:
    """The relayouts that the kernels read, for params in bf16 or f32:
    "out_w_padded" for K3's split route and, for a one-layer decoder in
    16-unit tiles, ``decode_tiles`` (bf16: the tensor-core body's tiles,
    f32: the TF32 body's). None for other types."""
    out_w = params["out_w"]
    if out_w.dtype not in (torch.bfloat16, torch.float32):
        return None
    layouts = {"out_w_padded": padded_columns(out_w)}
    H = params["attention"]["W"].shape[0]
    if len(params["rnn"]) == 1 and H % 16 == 0:
        layouts.update(decode_tiles(params))
    return layouts
