"""Single-step LSTM/GRU cells with PyTorch's gate semantics.

Port of the eval-mode cells of ``recnet_tpu.ops.rnn``:

* LSTM gate order i, f, g, o;  c' = f*c + i*g;  h' = o * tanh(c')
* GRU  gate order r, z, n;     n = tanh(i_n + r * (W_hn h + b_hn));
                               h' = (1-z)*n + z*h

Weights are input-major, as in the JAX package: ``w_ih (input, nG*H)``,
``w_hh (H, nG*H)``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]
State = Tuple[torch.Tensor, torch.Tensor]


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
