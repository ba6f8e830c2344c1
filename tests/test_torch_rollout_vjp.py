"""The port's custom-backward rollouts (``torch.autograd.Function``s) on the
CPU: ``ops.rnn.lstm_rollout_pre`` / ``gru_rollout_pre`` and
``models.decoder.tf_attn_rollout`` against ``jax.vjp`` of the JAX
package's custom VJPs and against autograd over the port's plain loops,
``gradcheck`` in float64, the per-step plain versions against JAX's, the
route the training path takes, the forward under ``no_grad``, and the
step launchers (``ops/cuda/rollout.py`` ``*_steps``) against their
wrappers.

Inputs and cotangents come from numpy seeds, at B = 5, T = 6, H <= 16,
F = 4. Tolerance, f32 against JAX and against the plain loops (the same
arithmetic in another summation order): rtol 1e-5 / atol 1e-6, the JAX
package's own rollout bound (tests/test_ops_rnn.py). Measured on a CPU:
the largest difference 9.5e-7, at most 0.22 of its bound (atol + rtol
|want|; the GRU rollout's d b_hh against JAX).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recnet_tpu.models import decoder as j_dec
from recnet_tpu.ops import rnn as j_rnn
from recnet_tpu_torch.models import decoder as t_dec
from recnet_tpu_torch.models import reconstructors as t_rec
from recnet_tpu_torch.ops import rnn as t_rnn
from recnet_tpu_torch.ops.cuda import rollout

torch.backends.cuda.matmul.allow_tf32 = False
T, B, F, E, A = 6, 5, 4, 12, 7
RTOL, ATOL = 1e-5, 1e-6


def _arrays(rng, shapes, scale=0.5):
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype).requires_grad_(True)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _rnn_inputs(cell, H, seed):
    n = 4 if cell == "LSTM" else 3
    rng = np.random.default_rng(seed)
    names = ["w_hh", "b_hh", "gi_all", "h0"] + (["c0"] if cell == "LSTM"
                                                else [])
    shapes = [(H, n * H), (n * H,), (T, B, n * H), (B, H), (B, H)]
    arrays = _arrays(rng, shapes[:len(names)])
    return names, arrays, (rng.standard_normal((T, B, H))).astype(np.float32)


def _port_rnn(cell):
    return t_rnn.lstm_rollout_pre if cell == "LSTM" else t_rnn.gru_rollout_pre


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_rnn_rollout_matches_jax_vjp(cell):
    names, arrays, dhs = _rnn_inputs(cell, 16, 0)
    jfn = j_rnn.lstm_rollout_pre if cell == "LSTM" else j_rnn.gru_rollout_pre
    want, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    want_grads = vjp(jnp.asarray(dhs))
    ins = [_t(x) for x in arrays]
    got = _port_rnn(cell)(*ins)
    got.backward(torch.from_numpy(dhs))
    _close(got.detach(), want, "hs")
    for name, x, g in zip(names, ins, want_grads):
        _close(x.grad, g, name)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_rnn_rollout_matches_the_plain_loop(cell):
    names, arrays, dhs = _rnn_inputs(cell, 16, 1)
    runs = []
    for fn in (t_rnn.rnn_rollout_pre, t_rnn.rnn_rollout_pre_reference):
        ins = [_t(x) for x in arrays]
        p = {"w_hh": ins[0], "b_hh": ins[1]}
        c0 = ins[4] if cell == "LSTM" else torch.zeros(B, 16)
        hs = fn(cell, p, ins[2], ins[3], c0)
        hs.backward(torch.from_numpy(dhs))
        runs.append((hs.detach(), [x.grad for x in ins]))
    (got, got_g), (want, want_g) = runs
    _close(got, want, "hs")
    for name, g, w in zip(names, got_g, want_g):
        _close(g, w, name)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_rnn_rollout_gradcheck(cell):
    _, arrays, _ = _rnn_inputs(cell, 3, 2)
    ins = [_t(x[:3] if x.ndim == 3 else x, torch.float64) for x in arrays]
    assert torch.autograd.gradcheck(_port_rnn(cell), ins)


def _dec_inputs(cell, seed, H=8):
    G = (4 if cell == "LSTM" else 3) * H
    rng = np.random.default_rng(seed)
    att = dict(zip(("W", "U", "b", "w"),
                   _arrays(rng, [(H, A), (E, A), (A,), (A, 1)])))
    rest = _arrays(rng, [(E, G), (H, G), (G,), (B, F, E), (T, B, G)])
    return att, rest, (rng.standard_normal((T, B, H))).astype(np.float32)


def _port_dec(fn, cell, att, rest):
    """hs of ``fn`` on leaf tensors (uv made from U by autograd, as in the
    decoder), and the leaves: W, U, b, w, w_enc, w_hh, b_hh, enc,
    gi_emb."""
    att_t = {k: _t(v) for k, v in att.items()}
    w_enc, w_hh, b_hh, enc, gi_emb = (_t(x) for x in rest)
    uv = enc @ att_t["U"]
    hs = fn(cell, att_t, w_enc, w_hh, b_hh, enc, uv, gi_emb)
    return hs, [att_t["W"], att_t["U"], att_t["b"], att_t["w"], w_enc, w_hh,
                b_hh, enc, gi_emb]


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_decoder_rollout_matches_jax_vjp(cell):
    """Every cotangent of JAX's _tf_attn_rollout (d_att's U is zeros
    there: U's gradient flows through uv), d_uv taken through the
    port's precompute_uv product."""
    att, rest, dhs = _dec_inputs(cell, 3)
    enc = jnp.asarray(rest[3])

    def jfn(att, w_enc, w_hh, b_hh, enc, gi_emb):
        uv = enc @ att["U"]
        return j_dec._tf_attn_rollout(cell, att, w_enc, w_hh, b_hh, enc,
                                      uv, gi_emb)

    jatt = {k: jnp.asarray(v) for k, v in att.items()}
    jrest = [jnp.asarray(x) for x in rest]
    want, vjp = jax.vjp(jfn, jatt, jrest[0], jrest[1], jrest[2], enc,
                        jrest[4])
    d_att, d_w_enc, d_w_hh, d_b_hh, d_enc, d_gi = vjp(jnp.asarray(dhs))
    hs, leaves = _port_dec(t_dec.tf_attn_rollout, cell, att, rest)
    hs.backward(torch.from_numpy(dhs))
    _close(hs.detach(), want, "hs")
    wants = [d_att["W"], d_att["U"], d_att["b"], d_att["w"], d_w_enc,
             d_w_hh, d_b_hh, d_enc, d_gi]
    names = ["W", "U", "b", "w", "w_enc", "w_hh", "b_hh", "enc", "gi_emb"]
    for name, x, g in zip(names, leaves, wants):
        _close(x.grad, g, name)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_decoder_rollout_matches_the_plain_loop(cell):
    att, rest, dhs = _dec_inputs(cell, 4)
    runs = []
    for fn in (t_dec.tf_attn_rollout, t_dec.tf_attn_rollout_reference):
        hs, leaves = _port_dec(fn, cell, att, rest)
        hs.backward(torch.from_numpy(dhs))
        runs.append((hs.detach(), [x.grad for x in leaves]))
    (got, got_g), (want, want_g) = runs
    _close(got, want, "hs")
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        _close(g, w, f"leaf {i}")


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_decoder_rollout_gradcheck(cell):
    """float64, U and uv apart (the Function takes uv; U's gradient is
    None)."""
    att, rest, _ = _dec_inputs(cell, 5, H=3)
    f64 = torch.float64
    W, U, b, w = (_t(att[k], f64) for k in ("W", "U", "b", "w"))
    w_enc, w_hh, b_hh, enc, gi_emb = (_t(x, f64) for x in rest)
    uv = _t(enc.detach() @ U.detach(), f64)
    gi_emb = _t(gi_emb.detach()[:3], f64)

    def fn(W, b, w, w_enc, w_hh, b_hh, enc, uv, gi_emb):
        return t_dec.tf_attn_rollout(cell, {"W": W, "U": U, "b": b, "w": w},
                                     w_enc, w_hh, b_hh, enc, uv, gi_emb)
    assert torch.autograd.gradcheck(
        fn, (W, b, w, w_enc, w_hh, b_hh, enc, uv, gi_emb))


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_one_step_matches_jax_rollout_cell(cell):
    """rollout_cell_fwd / rollout_cell_bwd (the plain versions on the
    CPU) against JAX's: outputs, the activations' layout ([i, f, g, o] /
    [r, z, n, h_n]) and (dgi, dgh, dh_prev, dc_prev)."""
    H = 16
    n = 4 if cell == "LSTM" else 3
    rng = np.random.default_rng(6)
    gi, h, c, w_hh, b_hh, dh, dc = _arrays(
        rng, [(B, n * H), (B, H), (B, H), (H, n * H), (n * H,), (B, H),
              (B, H)])
    want = j_rnn.rollout_cell_fwd(cell, *map(jnp.asarray,
                                             (gi, h, c, w_hh, b_hh)))
    got = t_rnn.rollout_cell_fwd(cell, *map(torch.from_numpy,
                                            (gi, h, c, w_hh, b_hh)))
    for g, w in zip(got, want):
        _close(g, w)
    act, c_t = want[2], want[1]
    wantb = j_rnn.rollout_cell_bwd(cell, jnp.asarray(dh), jnp.asarray(dc),
                                   act, jnp.asarray(h), jnp.asarray(c), c_t,
                                   jnp.asarray(w_hh))
    gotb = t_rnn.rollout_cell_bwd(
        cell, torch.from_numpy(dh), torch.from_numpy(dc),
        torch.from_numpy(np.array(act)), torch.from_numpy(h),
        torch.from_numpy(c), torch.from_numpy(np.array(c_t)),
        torch.from_numpy(w_hh))
    for g, w in zip(gotb, wantb):
        _close(g, w)
    if cell == "LSTM":
        assert gotb[0] is gotb[1]


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spied(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, spied)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_training_path_takes_the_functions_at_one_layer(monkeypatch,
                                                        n_layers):
    """teacher_forced_rollout_fast and global_reconstruct call the
    Functions at one layer, and at two their plain loops over
    _multilayer_rnn (as the JAX package scans there), never a Function."""
    calls = []
    for module, name in ((t_dec, "tf_attn_rollout"),
                         (t_dec, "tf_attn_rollout_reference"),
                         (t_rnn, "lstm_rollout_pre"),
                         (t_rnn, "rnn_rollout_pre_reference"),
                         (t_dec, "_multilayer_rnn"),
                         (t_rec, "_multilayer_rnn")):
        _spy(monkeypatch, module, name, calls)
    g = torch.Generator().manual_seed(0)
    dcfg = t_dec.DecoderConfig(cell_type="GRU", n_layers=n_layers,
                               vocab_size=11, embedding_size=6,
                               encoder_size=E, hidden_size=8, attn_size=A)
    rcfg = t_rec.ReconstructorConfig(n_layers=n_layers,
                                     decoder_hidden_size=8, hidden_size=10)
    dp = t_dec.init_decoder_params(g, dcfg)
    rp = t_rec.init_reconstructor_params(g, rcfg)
    enc = torch.randn((B, F, E), generator=g)
    caps = torch.randint(3, 11, (T, B), generator=g)
    out = t_dec.teacher_forced_rollout_fast(dp, dcfg, enc, caps)
    mask = torch.ones(T)
    t_rec.global_reconstruct(rp, rcfg, out.hiddens, mask, mask.sum())
    assert calls == (["tf_attn_rollout", "lstm_rollout_pre"]
                     if n_layers == 1 else ["_multilayer_rnn"] * 2 * T)


def test_functions_under_no_grad_equal_the_forward_with_grad():
    for cell in ("LSTM", "GRU"):
        att, rest, _ = _dec_inputs(cell, 7)
        with_grad, _ = _port_dec(t_dec.tf_attn_rollout, cell, att, rest)
        with torch.no_grad():
            no_grad, _ = _port_dec(t_dec.tf_attn_rollout, cell, att, rest)
        assert not no_grad.requires_grad
        assert torch.equal(no_grad, with_grad.detach())
        _, arrays, _ = _rnn_inputs(cell, 16, 8)
        ins = [_t(x) for x in arrays]
        with_grad = _port_rnn(cell)(*ins)
        with torch.no_grad():
            no_grad = _port_rnn(cell)(*ins)
        assert torch.equal(no_grad, with_grad.detach())


def test_wrappers_on_the_cpu_run_the_plain_versions_and_count_nothing():
    rollout.reset_counts()
    _, arrays, dhs = _rnn_inputs("LSTM", 8, 9)
    t_rnn.lstm_rollout_pre(*(_t(x) for x in arrays)).backward(
        torch.from_numpy(dhs))
    att, rest, dhs = _dec_inputs("GRU", 9)
    hs, _ = _port_dec(t_dec.tf_attn_rollout, "GRU", att, rest)
    hs.backward(torch.from_numpy(dhs))
    assert [fn.n_launches for fn in rollout.KERNELS] == [0, 0, 0, 0]
    assert not rollout.cell_forward.cell_launches


def test_wrappers_reject_bad_shapes_and_cells():
    h = torch.zeros(B, 4)
    with pytest.raises(ValueError, match="gx"):
        rollout.cell_forward("LSTM", torch.zeros(B, 12), None,
                             torch.zeros(16), h, h)
    with pytest.raises(ValueError, match="Unknown cell"):
        rollout.cell_forward("RNN", torch.zeros(B, 16), None,
                             torch.zeros(16), h, h)
    with pytest.raises(ValueError, match="gh must be given"):
        rollout.cell_forward("GRU", torch.zeros(B, 12), None,
                             torch.zeros(12), h, None)
    with pytest.raises(ValueError, match="acts"):
        rollout.cell_backward("GRU", h, None, None, torch.zeros(B, 12), h,
                              None, None)
    enc = torch.zeros(B, F, E)
    with pytest.raises(ValueError, match="uv"):
        rollout.attention_forward(torch.zeros(B, A), torch.zeros(B, F, 3),
                                  torch.zeros(A), torch.zeros(A, 1), enc)
    with pytest.raises(ValueError, match="w is"):
        rollout.attention_backward(torch.zeros(B, E), enc,
                                   torch.zeros(B, F, A), torch.zeros(A, 2))


def _step_buffers(cell, H, seed):
    """A rollout's (T, B, .) inputs for the step launchers, from a seed."""
    n = 4 if cell == "LSTM" else 3
    rng = np.random.default_rng(seed)
    gx, gh, bias, h0, c0, dhs, att_h = map(torch.from_numpy, _arrays(
        rng, [(T, B, n * H), (B, n * H), (n * H,), (B, H), (B, H),
              (T, B, H), (T, B, H)]))
    return gx, gh, bias, h0, c0, dhs, att_h


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_step_launchers_equal_the_wrappers_step_by_step(cell):
    """Each ``*_steps`` launcher on CPU tensors writes what a loop of its
    wrapper's calls gives, step by step, in place where it says so; GRU's
    gh is one buffer for every step, its dgh rows lie beside other
    columns."""
    H, lstm = 6, cell == "LSTM"
    gx, gh, bias, h0, c0, dhs, _ = _step_buffers(cell, H, 10)
    hs, cs = torch.empty(T, B, H), torch.empty(T, B, H) if lstm else None
    acts = torch.empty(T, B, 4 * H)
    launch = rollout.cell_forward_steps(cell, gx, None if lstm else
                                        gh.expand(T, B, -1), bias, h0,
                                        c0 if lstm else None, hs, cs, acts)
    h, c = h0, c0
    for t in range(T):
        launch(t)
        h, c, a = rollout.cell_forward(cell, gx[t], None if lstm else gh,
                                       bias, h, c if lstm else None)
        assert torch.equal(hs[t], h) and torch.equal(acts[t], a)
        if lstm:
            assert torch.equal(cs[t], c)
    h_prev = torch.cat([h0[None], hs[:-1]])
    c_prev = torch.cat([c0[None], cs[:-1]]) if lstm else None
    G = gx.shape[-1]
    dgi, dgh = torch.empty(T, B, G), torch.empty(T, B, G + 3)[..., :G]
    dh, dc = torch.zeros(B, H), torch.zeros(B, H) if lstm else None
    launch = rollout.cell_backward_steps(cell, dh, dhs, dc, acts, h_prev,
                                         c_prev, cs, dgi, dgh)
    want_dh, want_dc = torch.zeros(B, H), torch.zeros(B, H)
    for t in reversed(range(T)):
        launch(t)
        wgi, wgh, wdh, wdc = rollout.cell_backward(
            cell, want_dh, dhs[t], want_dc if lstm else None, acts[t],
            h_prev[t], c_prev[t] if lstm else None, cs[t] if lstm else None)
        assert torch.equal(dgi[t], wgi)
        if lstm:
            assert torch.equal(dc, wdc)
            want_dc = wdc
        else:
            assert torch.equal(dgh[t], wgh) and torch.equal(dh, wdh)
        # the caller's product (LSTM: dh = dgi w_hh^T; GRU: dh += dgh
        # w_hh^T), here a stand-in
        product = dgi[t][:, :H] * 0.5
        dh.copy_(product) if lstm else dh.add_(product)
        want_dh = dh.clone()


def test_attention_step_launchers_equal_the_wrappers_step_by_step():
    """wh and dwh rows laid beside a product's G other columns, as the
    rollout lays them."""
    G = 6
    rng = np.random.default_rng(11)
    gw, uv, b, w, enc, dctx, act = map(torch.from_numpy, _arrays(
        rng, [(T, B, G + A), (B, F, A), (A,), (A, 1), (B, F, E), (T, B, E),
              (T, B, F, A)]))
    whs = gw[..., G:]
    scores, ctxs = torch.empty(T, B, F), torch.empty(T, B, E)
    launch = rollout.attention_forward_steps(whs, uv, b, w, enc, scores,
                                             ctxs)
    for t in range(T):
        launch(t)
        want = rollout.attention_forward(whs[t], uv, b, w, enc)
        assert torch.equal(scores[t], want[0])
        assert torch.equal(ctxs[t], want[1])
    dsc, dgw = torch.empty(T, B, F), torch.zeros(T, B, G + A)
    launch = rollout.attention_backward_steps(dctx, enc, act, w, dsc,
                                              dgw[..., G:])
    for t in reversed(range(T)):
        launch(t)
        want = rollout.attention_backward(dctx[t], enc, act[t], w)
        assert torch.equal(dsc[t], want[0])
        assert torch.equal(dgw[t][:, G:], want[1])
    assert not dgw[..., :G].any()


def test_step_launchers_reject_bad_buffers():
    H = 4
    gx, gh, bias, h0, c0, dhs, _ = _step_buffers("LSTM", H, 12)
    acts = torch.empty(T, B, 4 * H)
    with pytest.raises(ValueError, match="hs"):
        rollout.cell_forward_steps("LSTM", gx, None, bias, h0, c0,
                                   torch.empty(T - 1, B, H),
                                   torch.empty(T, B, H), acts)
    with pytest.raises(ValueError, match="LSTM takes c0 and cs"):
        rollout.cell_forward_steps("LSTM", gx, None, bias, h0, c0,
                                   torch.empty(T, B, H), None, acts)
    with pytest.raises(ValueError, match="h_prev and dgh"):
        rollout.cell_backward_steps("GRU", h0, dhs, None, acts, None, None,
                                    None, torch.empty(T, B, 3 * H), None)
    with pytest.raises(ValueError, match="dscores"):
        rollout.attention_backward_steps(
            torch.zeros(T, B, E), torch.zeros(B, F, E),
            torch.zeros(T, B, F, A), torch.zeros(A, 1),
            torch.zeros(T, B, F + 1), torch.zeros(T, B, A))


@pytest.mark.parametrize("kind,probe", [("forward", "scores"),
                                        ("forward", "ctx"),
                                        ("backward", "dscores"),
                                        ("backward", "dwh")])
def test_attention_probes_on_the_cpu_are_their_plain_parts(kind, probe):
    """A split probe drops one part of its kernel's work: its outputs are
    the kernel's with that part's values (and what is made from them)
    zero."""
    rng = np.random.default_rng(13)
    wh, uv, b, w, enc, dctx, act = map(torch.from_numpy, _arrays(
        rng, [(B, A), (B, F, A), (A,), (A, 1), (B, F, E), (B, E),
              (B, F, A)]))
    operands = ((wh, uv, b, w, enc) if kind == "forward" else
                (dctx, enc, act, w))
    full = (rollout.attention_forward(*operands) if kind == "forward" else
            rollout.attention_backward(*operands))
    got = rollout.attention_probe(kind, probe, *operands)
    dropped_first = probe in ("scores", "dscores")
    assert torch.equal(got[0], torch.zeros_like(full[0]) if dropped_first
                       else full[0])
    assert torch.equal(got[1], torch.zeros_like(full[1]))
    with pytest.raises(ValueError, match="no forward probe"):
        rollout.attention_probe("forward", "dwh", wh, uv, b, w, enc)
