"""LSTM/GRU cells with PyTorch's gate semantics, their initialiser, and a
rollout over precomputed input gates.

Port of ``recnet_tpu.ops.rnn``:

* LSTM gate order i, f, g, o;  c' = f*c + i*g;  h' = o * tanh(c')
* GRU  gate order r, z, n;     n = tanh(i_n + r * (W_hn h + b_hn));
                               h' = (1-z)*n + z*h

Weights are input-major, as in the JAX package: ``w_ih (input, nG*H)``,
``w_hh (H, nG*H)``.

``rnn_rollout_pre`` rolls one layer over precomputed input gates through
``lstm_rollout_pre`` / ``gru_rollout_pre``, ``torch.autograd.Function``s
with the JAX package's custom-VJP construction (``recnet_tpu/ops/rnn.py``
:207-293): the forward keeps each step's gate activations, the backward
loop carries only (dh, dc), and ``dw_hh`` and ``db_hh`` are one product and
one sum over all T B rows after it. Each step's elementwise work is one
kernel of ``ops/cuda/rollout.py`` on the card (its plain version on the
CPU), launched through its ``*_steps`` launcher (checked once a rollout),
each product one cuBLAS call. ``rollout_cell_fwd`` /
``rollout_cell_bwd`` are one such step and its cotangents, with the JAX
functions' signatures and returns. ``rnn_rollout_pre_reference`` is the
plain loop over T whose gradient autograd gives.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from recnet_tpu_torch.ops.cuda import rollout

Params = Dict[str, torch.Tensor]
State = Tuple[torch.Tensor, torch.Tensor]


def init_rnn_params(generator: torch.Generator, cell_type: str,
                    input_size: int, hidden_size: int,
                    dtype=torch.float32) -> Params:
    """PyTorch's default RNN init, U(-1/sqrt(H), 1/sqrt(H)) for every weight
    and bias, drawn from ``generator`` on its device."""
    n_gates = 4 if cell_type == "LSTM" else 3
    bound = 1.0 / hidden_size ** 0.5
    G = n_gates * hidden_size

    def u(*shape):
        return torch.empty(shape, dtype=dtype,
                           device=generator.device).uniform_(
                               -bound, bound, generator=generator)
    return {"w_ih": u(input_size, G), "w_hh": u(hidden_size, G),
            "b_ih": u(G), "b_hh": u(G)}


def lstm_cell_pre(params: Params, gi: torch.Tensor, state: State) -> State:
    """LSTM step with the input-side term ``gi = x @ w_ih + b_ih`` given."""
    h, c = state
    gates = gi + h @ params["w_hh"] + params["b_hh"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def gru_cell_pre(params: Params, gi: torch.Tensor,
                 h: torch.Tensor) -> torch.Tensor:
    """GRU step with ``gi = x @ w_ih + b_ih`` given. Returns h'."""
    gh = h @ params["w_hh"] + params["b_hh"]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def lstm_cell(params: Params, x: torch.Tensor, state: State) -> State:
    """One LSTM step. x (B, in), state (h, c) each (B, H)."""
    return lstm_cell_pre(params, x @ params["w_ih"] + params["b_ih"], state)


def gru_cell(params: Params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step with PyTorch's reset-gate placement. Returns h'."""
    return gru_cell_pre(params, x @ params["w_ih"] + params["b_ih"], h)


def rnn_step_pre(cell_type: str, params: Params, gi: torch.Tensor,
                 state: State) -> State:
    """``rnn_step`` with the input-side gate term precomputed."""
    if cell_type == "LSTM":
        return lstm_cell_pre(params, gi, state)
    if cell_type == "GRU":
        return gru_cell_pre(params, gi, state[0]), state[1]
    raise ValueError(f"Unknown cell type: {cell_type}")


def rnn_step(cell_type: str, params: Params, x: torch.Tensor,
             state: State) -> State:
    """Uniform interface: the state is always (h, c); GRU echoes c."""
    if cell_type == "LSTM":
        return lstm_cell(params, x, state)
    if cell_type == "GRU":
        return gru_cell(params, x, state[0]), state[1]
    raise ValueError(f"Unknown cell type: {cell_type}")


def zero_state(batch_size: int, hidden_size: int, dtype=torch.float32,
               device="cpu") -> State:
    """Zero (h, c) carry."""
    z = torch.zeros((batch_size, hidden_size), dtype=dtype, device=device)
    return z, z


def rnn_rollout_pre_reference(cell_type: str, params: Params,
                              gi_all: torch.Tensor, h0: torch.Tensor,
                              c0: torch.Tensor) -> torch.Tensor:
    """``rnn_rollout_pre`` as a plain loop over T (autograd records every
    op of every step)."""
    state, hs = (h0, c0), []
    for gi in gi_all:
        state = rnn_step_pre(cell_type, params, gi, state)
        hs.append(state[0])
    return torch.stack(hs)


def rollout_cell_fwd(cell_type: str, gi: torch.Tensor, h: torch.Tensor,
                     c: torch.Tensor, w_hh: torch.Tensor,
                     b_hh: torch.Tensor):
    """One recurrent step from precomputed input gates ``gi`` (B, nG*H).
    Returns (h', c', acts): acts (B, 4H) holds [i, f, g, o] for LSTM and
    [r, z, n, h_n] for GRU (h_n includes b_hh's n part); GRU echoes c."""
    if cell_type == "LSTM":
        return rollout.cell_forward(cell_type, torch.addmm(gi, h, w_hh),
                                    None, b_hh, h, c)
    return rollout.cell_forward(cell_type, gi, h @ w_hh, b_hh, h, c)


def rollout_cell_bwd(cell_type: str, dh: torch.Tensor, dc_next, act,
                     h_pv, c_pv, c_t, w_hh: torch.Tensor):
    """Cotangents of one ``rollout_cell_fwd`` step; ``dh`` already sums the
    recurrent and output cotangents into h'. Returns (dgi, dgh, dh_prev,
    dc_prev); for LSTM dgi is dgh."""
    dgi, dgh, dh_cell, dc_prev = rollout.cell_backward(
        cell_type, dh, None, dc_next, act, h_pv, c_pv, c_t)
    dh_prev = dgh @ w_hh.t()
    return dgi, dgh, dh_prev if dh_cell is None else dh_prev + dh_cell, \
        dc_prev


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a rollout Function computes in: autocast's where it is on
    for ``x``'s device, else ``x``'s."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


def cast_operands(dtype: torch.dtype, *xs: torch.Tensor):
    """``xs`` in ``dtype``, contiguous (the kernels' operands)."""
    return [x.to(dtype).contiguous() for x in xs]


class _LstmRolloutPre(torch.autograd.Function):
    """``lstm_rollout_pre``: forward and backward of the LSTM rollout."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, w_hh, b_hh, gi_all, h0, c0):
        ctx.dtypes = [x.dtype for x in (w_hh, b_hh, gi_all, h0, c0)]
        dt = compute_dtype(gi_all)
        w_hh, b_hh, h0, c0 = cast_operands(dt, w_hh, b_hh, h0, c0)
        gates = gi_all.to(dt, copy=True).contiguous()   # gains h w_hh
        T, B, G = gates.shape
        hs = gates.new_empty((T, B, G // 4))
        cs = torch.empty_like(hs)
        acts = torch.empty_like(gates)
        cell = rollout.cell_forward_steps("LSTM", gates, None, b_hh, h0, c0,
                                          hs, cs, acts)
        h_prev = (h0,) + hs.unbind(0)[:-1]
        for t, g in enumerate(gates.unbind(0)):
            g.addmm_(h_prev[t], w_hh)
            cell(t)
        ctx.save_for_backward(w_hh, hs, cs, acts, h0, c0)
        return hs

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dhs):
        w_hh, hs, cs, acts, h0, c0 = ctx.saved_tensors
        dhs = dhs.to(hs.dtype).contiguous()
        T, B, H = hs.shape
        h_prev = torch.cat([h0[None], hs[:-1]])
        c_prev = torch.cat([c0[None], cs[:-1]])
        dgates = torch.empty_like(acts)
        dh, dc = torch.zeros_like(h0), torch.zeros_like(c0)
        cell = rollout.cell_backward_steps("LSTM", dh, dhs, dc, acts, None,
                                           c_prev, cs, dgates, None)
        w_t, dg = w_hh.t(), dgates.unbind(0)
        for t in reversed(range(T)):
            cell(t)
            torch.mm(dg[t], w_t, out=dh)
        d_w_hh = h_prev.reshape(T * B, H).t() @ dgates.reshape(T * B, 4 * H)
        grads = (d_w_hh, dgates.sum((0, 1)), dgates, dh, dc)
        return tuple(g.to(d) for g, d in zip(grads, ctx.dtypes))


class _GruRolloutPre(torch.autograd.Function):
    """``gru_rollout_pre``: forward and backward of the GRU rollout."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, w_hh, b_hh, gi_all, h0):
        ctx.dtypes = [x.dtype for x in (w_hh, b_hh, gi_all, h0)]
        dt = compute_dtype(gi_all)
        w_hh, b_hh, gi_all, h0 = cast_operands(dt, w_hh, b_hh, gi_all, h0)
        T, B, G = gi_all.shape
        hs = gi_all.new_empty((T, B, G // 3))
        acts = gi_all.new_empty((T, B, 4 * (G // 3)))
        gh = gi_all.new_empty((B, G))                   # h w_hh, a step
        cell = rollout.cell_forward_steps("GRU", gi_all, gh.expand(T, B, G),
                                          b_hh, h0, None, hs, None, acts)
        h_prev = (h0,) + hs.unbind(0)[:-1]
        for t in range(T):
            torch.mm(h_prev[t], w_hh, out=gh)
            cell(t)
        ctx.save_for_backward(w_hh, hs, acts, h0)
        return hs

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dhs):
        w_hh, hs, acts, h0 = ctx.saved_tensors
        dhs = dhs.to(hs.dtype).contiguous()
        T, B, H = hs.shape
        h_prev = torch.cat([h0[None], hs[:-1]])
        dgi = hs.new_empty((T, B, 3 * H))
        dgh = torch.empty_like(dgi)
        dh = torch.zeros_like(h0)
        cell = rollout.cell_backward_steps("GRU", dh, dhs, None, acts,
                                           h_prev, None, None, dgi, dgh)
        w_t, dg = w_hh.t(), dgh.unbind(0)
        for t in reversed(range(T)):
            cell(t)                             # dh = dh z
            dh.addmm_(dg[t], w_t)
        d_w_hh = h_prev.reshape(T * B, H).t() @ dgh.reshape(T * B, 3 * H)
        grads = (d_w_hh, dgh.sum((0, 1)), dgi, dh)
        return tuple(g.to(d) for g, d in zip(grads, ctx.dtypes))


def lstm_rollout_pre(w_hh: torch.Tensor, b_hh: torch.Tensor,
                     gi_all: torch.Tensor, h0: torch.Tensor,
                     c0: torch.Tensor) -> torch.Tensor:
    """Roll an LSTM over precomputed input gates gi_all (T, B, 4H);
    returns the hidden states (T, B, H)."""
    return _LstmRolloutPre.apply(w_hh, b_hh, gi_all, h0, c0)


def gru_rollout_pre(w_hh: torch.Tensor, b_hh: torch.Tensor,
                    gi_all: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Roll a GRU over precomputed input gates gi_all (T, B, 3H); returns
    the hidden states (T, B, H)."""
    return _GruRolloutPre.apply(w_hh, b_hh, gi_all, h0)


def rnn_rollout_pre(cell_type: str, params: Params, gi_all: torch.Tensor,
                    h0: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """Roll one layer over precomputed input gates ``gi_all (T, B, nG*H)``
    from (h0, c0); returns the hidden states (T, B, H)."""
    if cell_type == "LSTM":
        return lstm_rollout_pre(params["w_hh"], params["b_hh"], gi_all, h0,
                                c0)
    if cell_type == "GRU":
        return gru_rollout_pre(params["w_hh"], params["b_hh"], gi_all, h0)
    raise ValueError(f"Unknown cell type: {cell_type}")
