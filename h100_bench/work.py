"""The yardstick: the work a cell's inputs need, and the card's peaks.

Every count is of the work the inputs need, whatever the implementation
does: the row-steps the inputs ask for, each input byte read once and each
output byte written once. A kernel that does the same work another way is
read against the same numbers. The formulas are those of the port's smoke
script (``train_work``, ``decode_work``, ``bound_f32``), taken over on
configuration dicts (the keys of ``configs/<config>.json``).

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit. The
port's f32 routes compute f32-exact products as three TF32 tensor-core
terms, so the f32 peak of a share (``*_mfu``, ``*_roofline``) is the TF32
peak over three: a faithful f32 route cannot read over 100% of it.
"""

from __future__ import annotations

TF32_FLOPS = 494.7e12           # TF32 tensor cores
TF32_TERMS = 3                  # an f32-exact product as three TF32 terms
F32_EXACT_FLOPS = TF32_FLOPS / TF32_TERMS     # 164.9 TFLOP/s
HBM_BYTES_PER_S = 3.35e12


def _gates(cell: str, hidden: int) -> int:
    return (3 if cell == "GRU" else 4) * hidden


def train_step_work(c: dict, vocab: int, batch: int):
    """(flops, bytes) of one train step of ``batch`` videos: the forward's
    multiply-adds x 2 x 3 (the backward takes two products for each
    product of the forward); bytes: the batch's feature rows (bf16 cache)
    and captions read, every parameter and Adam moment read and written
    once."""
    T, L = c["caption_max_len"] + 1, c["encoder_output_len"]
    E, F = c["embedding_size"], c["encoder_output_size"]
    H, A, V = c["decoder_hidden_size"], c["decoder_attn_size"], vocab
    G = _gates(c["decoder_model"], H)
    dec = H * A + L * A + L * F + (E + F + H) * G + H * V    # a row-step
    macs = batch * (T * dec + L * F * A)                      # + U v
    Hr, Ar = c["reconstructor_hidden_size"], c["reconstructor_attn_size"]
    Gr = _gates(c["reconstructor_model"], Hr)
    local = c["reconstructor_type"] == "local"
    if local:
        rec_steps = L
        rec = Hr * Ar + T * Ar + T * H + (H + Hr) * Gr + Hr * Hr
        macs += batch * T * H * Ar                            # its U v
    else:
        rec_steps, rec = T, (2 * H + Hr) * Gr + Hr * Hr
    macs += batch * rec_steps * rec
    n_dec = (V * E + (H + F) * A + 2 * A + (E + F + H) * G + 2 * G
             + H * V + V)
    n_rec = (H if local else 2 * H) * Gr + Hr * Gr + 2 * Gr + Hr * Hr + Hr
    if local:
        n_rec += (Hr + H) * Ar + 2 * Ar
    moments = ((3 if c["decoder_use_amsgrad"] else 2) * n_dec
               + (3 if c["reconstructor_use_amsgrad"] else 2) * n_rec)
    nbytes = 2 * 4 * (n_dec + n_rec + moments) + 2 * batch * L * F \
        + 4 * T * batch
    return 6 * macs, nbytes


def decode_row_step_macs(c: dict, vocab: int) -> int:
    """Multiply-adds of one decode step of one row (one beam): W h, the
    scores, the context, the gates and the vocabulary projection."""
    L, E, F = (c["encoder_output_len"], c["embedding_size"],
               c["encoder_output_size"])
    H, A = c["decoder_hidden_size"], c["decoder_attn_size"]
    G = _gates(c["decoder_model"], H)
    return H * A + L * A + L * F + (E + F + H) * G + H * vocab


def uv_macs(c: dict, videos: int) -> int:
    """Multiply-adds of U v, once a video."""
    return (videos * c["encoder_output_len"] * c["encoder_output_size"]
            * c["decoder_attn_size"])


def decode_kernel_bytes(c: dict, vocab: int, batch: int, steps: int) -> int:
    """Bytes of a whole f32 greedy decode of ``batch`` rows over ``steps``
    steps: the weights, enc and U v read once, the tokens written once."""
    L, E, F = (c["encoder_output_len"], c["embedding_size"],
               c["encoder_output_size"])
    H, A = c["decoder_hidden_size"], c["decoder_attn_size"]
    G, K = _gates(c["decoder_model"], H), E + F
    weights = (vocab * E + K * G + H * G + 2 * G + H * A + 2 * A
               + H * vocab + vocab)
    acts = batch * L * F + batch * L * A
    return 4 * (weights + acts + batch * steps)


def topk_work(rows: int, hidden: int, vocab: int, k: int):
    """(flops, bytes) of one projection + top-K call in f32: ``rows`` x
    hidden x vocab multiply-adds; out rows, out_w and out_b read once, k
    values and indices a row written once."""
    return (2 * rows * hidden * vocab,
            4 * (rows * hidden + hidden * vocab + vocab) + 8 * rows * k)


def rollout_work(cell: str, batch: int, steps: int, hidden: int):
    """(flops, bytes) of one direction of a whole cell rollout in f32: the
    recurrent product h W_hh (forward) or dgates W_hh^T (backward) a step;
    W_hh and the bias read once, the gates read and the activations, h and
    c of every step written once (the backward reads and writes as much)."""
    G = _gates(cell, hidden)
    return (2 * batch * steps * hidden * G,
            4 * (hidden * G + G + steps * batch * (2 * G + 2 * hidden)))


def bound_f32_s(flops: float, nbytes: float) -> float:
    """The least time of f32-exact work: its products as three TF32 terms
    at the TF32 peak, or its bytes at the device-memory rate, whichever is
    longer (seconds)."""
    return max(flops / F32_EXACT_FLOPS, nbytes / HBM_BYTES_PER_S)
