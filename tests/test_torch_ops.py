"""recnet_tpu_torch.ops (attention, RNN cells) against their JAX twins, f32.

Inputs are made with numpy from a seed and fed to both packages. Tolerance
rtol 1e-5, atol 1e-6: the same f32 math, summed in another order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recnet_tpu.ops import attention as j_attn
from recnet_tpu.ops import rnn as j_rnn
from recnet_tpu_torch.ops import attention as t_attn
from recnet_tpu_torch.ops import rnn as t_rnn

B, L, F, H, A, IN = 5, 7, 24, 16, 8, 20
TOL = dict(rtol=1e-5, atol=1e-6)


def _arrays(seed, **shapes):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
            for k, s in shapes.items()}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _attention(seed):
    p = _arrays(seed, W=(H, A), U=(F, A), w=(A, 1))
    p["b"] = np.ones((A,), np.float32)
    x = _arrays(seed + 100, q=(B, H), v=(B, L, F))
    return _both(p), _both(x)


def test_attention_matches_jax():
    (jp, tp), (jx, tx) = _attention(0)
    j_uv = j_attn.precompute_uv(jp, jx["v"])
    t_uv = t_attn.precompute_uv(tp, tx["v"])
    _close(t_uv, j_uv)
    _close(t_attn.attention_scores(tp, tx["q"], t_uv),
           j_attn.attention_scores(jp, jx["q"], j_uv))
    _close(t_attn.attend_mean(tp, tx["q"], tx["v"], t_uv),
           j_attn.attend_mean(jp, jx["q"], jx["v"], j_uv))


def test_attend_mean_mask_and_denom_match_jax():
    (jp, tp), (jx, tx) = _attention(1)
    mask = (np.arange(L) < 4).astype(np.float32)[None].repeat(B, 0)
    j_uv = j_attn.precompute_uv(jp, jx["v"])
    t_uv = t_attn.precompute_uv(tp, tx["v"])
    _close(t_attn.attend_mean(tp, tx["q"], tx["v"], t_uv,
                              mask=torch.from_numpy(mask),
                              denom=torch.tensor(4.0)),
           j_attn.attend_mean(jp, jx["q"], jx["v"], j_uv,
                              mask=jnp.asarray(mask), denom=jnp.asarray(4.0)))


def _cell_inputs(cell, seed):
    G = (4 if cell == "LSTM" else 3) * H
    p = _arrays(seed, w_ih=(IN, G), w_hh=(H, G), b_ih=(G,), b_hh=(G,))
    x = _arrays(seed + 1, x=(B, IN), h=(B, H), c=(B, H), gi=(B, G))
    return _both(p), _both(x)


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_rnn_step_matches_jax(cell):
    (jp, tp), (jx, tx) = _cell_inputs(cell, 2)
    jh, jc = j_rnn.rnn_step(cell, jp, jx["x"], (jx["h"], jx["c"]))
    th, tc = t_rnn.rnn_step(cell, tp, tx["x"], (tx["h"], tx["c"]))
    _close(th, jh)
    _close(tc, jc)


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_rnn_step_pre_matches_jax(cell):
    (jp, tp), (jx, tx) = _cell_inputs(cell, 3)
    jh, jc = j_rnn.rnn_step_pre(cell, jp, jx["gi"], (jx["h"], jx["c"]))
    th, tc = t_rnn.rnn_step_pre(cell, tp, tx["gi"], (tx["h"], tx["c"]))
    _close(th, jh)
    _close(tc, jc)


def test_bare_cells_match_jax():
    (jp, tp), (jx, tx) = _cell_inputs("GRU", 4)
    _close(t_rnn.gru_cell(tp, tx["x"], tx["h"]),
           j_rnn.gru_cell(jp, jx["x"], jx["h"]))
    _close(t_rnn.gru_cell_pre(tp, tx["gi"], tx["h"]),
           j_rnn.gru_cell_pre(jp, jx["gi"], jx["h"]))
    (jp, tp), (jx, tx) = _cell_inputs("LSTM", 5)
    for got, want in zip(t_rnn.lstm_cell(tp, tx["x"], (tx["h"], tx["c"])),
                         j_rnn.lstm_cell(jp, jx["x"], (jx["h"], jx["c"]))):
        _close(got, want)
    for got, want in zip(
            t_rnn.lstm_cell_pre(tp, tx["gi"], (tx["h"], tx["c"])),
            j_rnn.lstm_cell_pre(jp, jx["gi"], (jx["h"], jx["c"]))):
        _close(got, want)


def test_zero_state_and_unknown_cell():
    h, c = t_rnn.zero_state(3, H)
    jh, jc = j_rnn.zero_state(3, H)
    _close(h, jh)
    _close(c, jc)
    (_, tp), (_, tx) = _cell_inputs("GRU", 6)
    with pytest.raises(ValueError, match="Unknown cell"):
        t_rnn.rnn_step("RNN", tp, tx["x"], (tx["h"], tx["c"]))
