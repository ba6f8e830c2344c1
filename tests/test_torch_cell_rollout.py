"""The whole-rollout cell wrappers (``ops/cuda/rollout.py``
``cell_rollout_forward`` / ``cell_rollout_backward``) on the CPU, where
they run their plain versions: the plain versions against the JAX
package's custom-VJP rollouts (``_lstm_rollout_fwd`` / ``_gru_rollout_fwd``
residuals, and ``jax.vjp`` of ``lstm_rollout_pre`` / ``gru_rollout_pre``),
against the per-step route (``ops.rnn.steps_forward`` /
``steps_backward``), the wrappers' counts, ``out`` buffers and refusals,
the launch shapes (``rollout_shape``) and the route rule of ``ops.rnn``.

Inputs from numpy seeds at B = 3 and 7, T = 5, H = 5 and 16 (odd widths,
as the card tests take). f32 tolerance rtol 1e-5 / atol 1e-6, the JAX
package's own rollout bound (tests/test_ops_rnn.py): the same arithmetic
in another summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recnet_tpu.ops import rnn as j_rnn
from recnet_tpu_torch.ops import rnn as t_rnn
from recnet_tpu_torch.ops.cuda import rollout

T = 5
RTOL, ATOL = 1e-5, 1e-6
WIDTHS = [(3, 16), (7, 5)]


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _inputs(cell, B, H, seed):
    """w_hh, b_hh, gi_all, h0, c0 (None for GRU) and the output cotangents
    dhs, float32 numpy."""
    n = 4 if cell == "LSTM" else 3
    rng = np.random.default_rng(seed)
    arr = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    c0 = arr(B, H)
    return (arr(H, n * H), arr(n * H), arr(T, B, n * H), arr(B, H),
            c0 if cell == "LSTM" else None, arr(T, B, H))


def _torch(*xs):
    return [None if x is None else torch.from_numpy(np.array(x))
            for x in xs]


@pytest.mark.parametrize("B,H", WIDTHS)
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_forward_reference_matches_jax_residuals(cell, B, H):
    """hs, cs and acts ([i, f, g, o] / [r, z, n, h_n]) against the JAX
    forward's residuals."""
    w, b, gi, h0, c0, _ = _inputs(cell, B, H, 0)
    if cell == "LSTM":
        _, (_, hs, cs, acts, _, _) = j_rnn._lstm_rollout_fwd(
            *map(jnp.asarray, (w, b, gi, h0, c0)))
    else:
        _, (_, hs, acts, _) = j_rnn._gru_rollout_fwd(
            *map(jnp.asarray, (w, b, gi, h0)))
        cs = None
    got = rollout.cell_rollout_forward_reference(cell, *_torch(gi, w, b, h0,
                                                               c0))
    for name, g, x in zip(("hs", "cs", "acts"), got, (hs, cs, acts)):
        if x is None:
            assert g is None
        else:
            _close(g, x, name)


@pytest.mark.parametrize("B,H", WIDTHS)
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_backward_reference_matches_jax_vjp(cell, B, H):
    """The plain backward's d gi_all (dgates / dgi), dh0 and dc0 against
    ``jax.vjp`` of the JAX custom VJP; d w_hh and d b_hh made from its
    dgates (dgh) as the Function makes them."""
    w, b, gi, h0, c0, dhs = _inputs(cell, B, H, 1)
    lstm = cell == "LSTM"
    args = (w, b, gi, h0, c0) if lstm else (w, b, gi, h0)
    jfn = j_rnn.lstm_rollout_pre if lstm else j_rnn.gru_rollout_pre
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dhs))
    tw, tb, tgi, th0, tc0, tdhs = _torch(w, b, gi, h0, c0, dhs)
    hs, cs, acts = rollout.cell_rollout_forward_reference(cell, tgi, tw, tb,
                                                          th0, tc0)
    dgi, dgh, dh0, dc0 = rollout.cell_rollout_backward_reference(
        cell, tdhs, acts, tw, th0, hs, tc0, cs)
    h_prev = torch.cat([th0[None], hs[:-1]]).reshape(T * B, H)
    d_w = h_prev.t() @ dgh.reshape(T * B, -1)
    _close(d_w, want[0], "w_hh")
    _close(dgh.sum((0, 1)), want[1], "b_hh")
    _close(dgi, want[2], "gi_all")
    _close(dh0, want[3], "h0")
    if lstm:
        assert dgi is dgh
        _close(dc0, want[4], "c0")
    else:
        assert dc0 is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", WIDTHS)
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_plain_versions_equal_the_per_step_route(cell, B, H, dtype):
    """The per-step route (a cell step and a product a step) gives the
    plain versions' values: the same rounding, the products' sums in
    another order (f32: RTOL/ATOL; bf16: one bf16 ulp of the largest
    value)."""
    w, b, gi, h0, c0, dhs = (None if x is None else x.to(dtype)
                             for x in _torch(*_inputs(cell, B, H, 2)))
    want = rollout.cell_rollout_forward_reference(cell, gi, w, b, h0, c0)
    got = t_rnn.steps_forward(cell, gi, w, b, h0, c0)
    hs, cs, acts = want
    want_b = rollout.cell_rollout_backward_reference(cell, dhs, acts, w, h0,
                                                     hs, c0, cs)
    got_b = t_rnn.steps_backward(cell, dhs, acts, w, h0, hs, c0, cs)
    for g, x in zip(got + got_b, want + want_b):
        if x is None:
            assert g is None
            continue
        g, x = g.float().numpy(), x.float().numpy()
        if dtype == torch.float32:
            _close(g, x)
        else:
            np.testing.assert_allclose(g, x, rtol=2.0 ** -7,
                                       atol=2.0 ** -7 * np.abs(x).max())


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_wrappers_on_the_cpu_run_the_plain_versions_and_count_nothing(cell):
    """On CPU tensors the wrappers return the plain versions' outputs, fill
    ``out`` buffers where given, and count no launch."""
    w, b, gi, h0, c0, dhs = _torch(*_inputs(cell, 3, 16, 3))
    lstm = cell == "LSTM"
    rollout.reset_counts()
    want = rollout.cell_rollout_forward_reference(cell, gi, w, b, h0, c0)
    hs_buf = torch.empty(T, 3, 16)
    got = rollout.cell_rollout_forward(cell, gi, w, b, h0, c0,
                                       out=(hs_buf, None, None))
    assert got[0] is hs_buf
    for g, x in zip(got, want):
        assert (g is None and x is None) or torch.equal(g, x)
    hs, cs, acts = want
    want_b = rollout.cell_rollout_backward_reference(cell, dhs, acts, w, h0,
                                                     hs, c0, cs)
    got_b = rollout.cell_rollout_backward(cell, dhs, acts, w, h0, hs, c0, cs)
    for g, x in zip(got_b, want_b):
        assert (g is None and x is None) or torch.equal(g, x)
    if lstm:
        assert got_b[0] is got_b[1]
    assert [fn.n_launches for fn in rollout.KERNELS] == [0] * 6
    assert not rollout.cell_rollout_forward.cell_launches
    assert not rollout.cell_rollout_backward.cell_launches


def test_wrappers_refuse_bad_shapes_and_cells():
    w, b, gi, h0, c0, dhs = _torch(*_inputs("LSTM", 3, 4, 4))
    with pytest.raises(ValueError, match="Unknown cell"):
        rollout.cell_rollout_forward("RNN", gi, w, b, h0, c0)
    with pytest.raises(ValueError, match="gi_all"):
        rollout.cell_rollout_forward("LSTM", gi[..., :-1], w, b, h0, c0)
    with pytest.raises(ValueError, match="w_hh"):
        rollout.cell_rollout_forward("LSTM", gi, w[:-1], b, h0, c0)
    with pytest.raises(ValueError, match="LSTM takes c0"):
        rollout.cell_rollout_forward("LSTM", gi, w, b, h0, None)
    with pytest.raises(ValueError, match="LSTM takes c0"):
        rollout.cell_rollout_forward("GRU", gi[..., :12], w[:, :12], b[:12],
                                     h0, c0)
    with pytest.raises(ValueError, match="empty rollout"):
        rollout.cell_rollout_forward("LSTM", gi[:0], w, b, h0, c0)
    hs, cs, acts = rollout.cell_rollout_forward("LSTM", gi, w, b, h0, c0)
    with pytest.raises(ValueError, match="c0 and cs needed"):
        rollout.cell_rollout_backward("LSTM", dhs, acts, w, h0, hs, None,
                                      None)
    with pytest.raises(ValueError, match="hs needed"):
        rollout.cell_rollout_backward("GRU", dhs, acts, w[:, :12], h0, None,
                                      None, None)
    with pytest.raises(ValueError, match="acts"):
        rollout.cell_rollout_backward("LSTM", dhs, acts[..., :-1], w, h0, hs,
                                      c0, cs)
    with pytest.raises(ValueError, match="dh0_out"):
        rollout.cell_rollout_backward("LSTM", dhs, acts, w, h0, hs, c0, cs,
                                      out=(None, None, torch.empty(3, 5),
                                           None))
    with pytest.raises(ValueError, match="operands on"):
        rollout.cell_rollout_forward("LSTM", gi, w, b, h0,
                                     c0.to("meta"))


@pytest.mark.parametrize("kind,probe", [("forward", "product"),
                                        ("forward", "exchange"),
                                        ("backward", "product"),
                                        ("backward", "exchange")])
def test_probes_run_on_the_card_only(kind, probe):
    w, b, gi, h0, c0, dhs = _torch(*_inputs("LSTM", 3, 4, 5))
    if kind == "forward":
        operands = ("LSTM", gi, w, b, h0, c0)
    else:
        hs, cs, acts = rollout.cell_rollout_forward("LSTM", gi, w, b, h0, c0)
        operands = ("LSTM", dhs, acts, w, h0, hs, c0, cs)
    with pytest.raises(ValueError, match="on the card only"):
        rollout.cell_rollout_probe(kind, probe, *operands)
    with pytest.raises(ValueError, match="no forward probe"):
        rollout.cell_rollout_probe("forward", "ctx", *operands)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_plain_versions_take_their_products_from_matmul(cell):
    """``matmul`` computes every recurrent product of the plain versions, T
    a direction (the f32 kernel's three TF32 terms are modelled through
    it, tests/test_torch_tf32.py), and defaults to ``torch.matmul``: the
    same values bit for bit."""
    w, b, gi, h0, c0, dhs = _torch(*_inputs(cell, 3, 16, 5))
    calls = []

    def counted(x, y):
        calls.append((tuple(x.shape), tuple(y.shape)))
        return torch.matmul(x, y)

    fwd = rollout.cell_rollout_forward_reference(cell, gi, w, b, h0, c0)
    got = rollout.cell_rollout_forward_reference(cell, gi, w, b, h0, c0,
                                                 matmul=counted)
    G = w.shape[1]
    assert calls == [((3, 16), (16, G))] * T
    hs, cs, acts = fwd
    bwd = rollout.cell_rollout_backward_reference(cell, dhs, acts, w, h0, hs,
                                                  c0, cs)
    got_b = rollout.cell_rollout_backward_reference(
        cell, dhs, acts, w, h0, hs, c0, cs, matmul=counted)
    assert calls[T:] == [((3, G), (G, 16))] * T
    for g, x in zip(tuple(got) + tuple(got_b), tuple(fwd) + tuple(bwd)):
        assert (g is None and x is None) or torch.equal(g, x)


def test_route_rule_is_by_dtype(monkeypatch):
    """On CPU tensors float32 and bfloat16 take the whole-rollout wrappers
    (ops.rnn.whole_rollout: the plain versions hold any width); where the
    rule gives the per-step route, float32 takes it, to the same
    gradients."""
    calls = []
    for module, name in ((rollout, "cell_rollout_forward"),
                         (rollout, "cell_rollout_backward"),
                         (t_rnn, "steps_forward"), (t_rnn, "steps_backward")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))

    def run(dtype):
        w, b, gi, h0, c0, dhs = (x.to(dtype) for x in
                                 _torch(*_inputs("LSTM", 3, 16, 6)))
        for x in (w, b, gi, h0, c0):
            x.requires_grad_()
        t_rnn.lstm_rollout_pre(w, b, gi, h0, c0).backward(dhs)
        return [x.grad for x in (w, b, gi, h0, c0)]

    for dtype in (torch.float32, torch.bfloat16):
        assert t_rnn.whole_rollout("LSTM", dtype, 3, 16, torch.device("cpu"))
    want = run(torch.float32)
    assert calls == ["cell_rollout_forward", "cell_rollout_backward"]
    run(torch.bfloat16)
    assert calls[2:] == ["cell_rollout_forward", "cell_rollout_backward"]
    monkeypatch.setattr(t_rnn, "whole_rollout", lambda *a: False)
    for g, x in zip(run(torch.float32), want):
        _close(g, x)
    assert calls[4:] == ["steps_forward", "steps_backward"]


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_stepwise_references_from_their_own_run_repeat_it(cell):
    """The plain versions run from another run's states (forward) or
    carries (backward) give that run back when it is their own; the
    carries into each step (``steps_out``) start at zero at T - 1, and the
    wrapper on CPU tensors fills them as the plain version does."""
    w, b, gi, h0, c0, dhs = _torch(*_inputs(cell, 7, 5, 7))
    lstm = cell == "LSTM"
    hs, cs, acts = rollout.cell_rollout_forward_reference(cell, gi, w, b,
                                                          h0, c0)
    again = rollout.cell_rollout_forward_reference(cell, gi, w, b, h0, c0,
                                                   states=(hs, cs))
    for g, x in zip(again, (hs, cs, acts)):
        assert (g is None and x is None) or torch.equal(g, x)
    steps = (torch.empty(T, 7, 5), torch.empty(T, 7, 5) if lstm else None)
    want = rollout.cell_rollout_backward_reference(
        cell, dhs, acts, w, h0, hs, c0, cs, steps_out=steps)
    assert not steps[0][-1].any() and steps[0][0].any()
    again_steps = (torch.empty(T, 7, 5),
                   torch.empty(T, 7, 5) if lstm else None)
    again = rollout.cell_rollout_backward_reference(
        cell, dhs, acts, w, h0, hs, c0, cs, steps_out=again_steps,
        carries=steps)
    for g, x in zip(tuple(again) + again_steps, tuple(want) + steps):
        assert (g is None and x is None) or torch.equal(g, x)
    wrapped = (torch.empty(T, 7, 5), torch.empty(T, 7, 5) if lstm else None)
    rollout.cell_rollout_backward(cell, dhs, acts, w, h0, hs, c0, cs,
                                  steps_out=wrapped)
    for g, x in zip(wrapped, steps):
        assert (g is None and x is None) or torch.equal(g, x)
    with pytest.raises(ValueError, match="steps_out"):
        rollout.cell_rollout_backward(cell, dhs, acts, w, h0, hs, c0, cs,
                                      steps_out=(steps[0], None if lstm
                                                 else steps[0]))


# the H100 80GB HBM3 the card tests run on: SMs, shared memory a block, and
# the clusters it holds at once at the flagship's widths (forward clusters
# of 2, backward of 8; chip_smoke.py [train] (d) prints them)
H100 = dict(sms=132, smem_limit=232448)
H100_CAP = {True: 66, False: 15}


def _shape_holds(cell, forward, dtype, B, H, shape, limit):
    """The invariants a launch shape keeps: every unit has a block, the
    smem budget fits, the rows are a built wgmma width, the pass takes
    whole 8-row groups and at most its pairs, the partials fit over the
    activations' ring, and the shared memory is the sum of the body's
    parts (f32: cell_rollout_tf32_kernel's layout)."""
    C = shape["cluster"]
    assert C == (2 if forward else 8)
    assert shape["clusters"] * C * shape["units"] >= H
    assert shape["smem"] <= limit
    assert shape["k_slice"] % 64 == 0
    n_g = 4 if cell == "LSTM" else 3
    K = H if forward else n_g * H
    assert shape["k_slice"] * C >= K            # the slices cover k
    assert shape["k_slice"] - 64 < -(-K // C)   # by whole chunks, no more
    Bp = shape["pass_rows"]
    assert Bp % 8 == 0 and 8 <= Bp
    rows = (n_g if forward else 1) * C * shape["units"]
    NW, ub, S = shape["rows"], shape["units"], shape["stages"]
    assert NW in rollout.ROLLOUT_WIDTHS
    assert NW >= rows
    assert Bp <= rollout.ROLLOUT_PASS_ROWS
    assert ub * Bp <= rollout.ROLLOUT_MAX_PAIRS
    partials = min(B, Bp) * -(-NW // 32) * 32 * 4
    if dtype == torch.bfloat16:
        lo, hi = rollout.ROLLOUT_STAGES
        assert lo <= S <= hi
        assert partials <= S * Bp * 128
    else:
        assert S == rollout.ROLLOUT_F32_SLOTS
        rows_bytes = Bp * 36 * 4                # rows of 36 floats
        assert partials <= S * rows_bytes
        # alignment, the slots (a hi and a lo tile of NW rows of 128 bytes,
        # the rows, an mbarrier), the readiness bytes, b_hh; the weight's
        # tile images in device memory, two tiles a 32-k chunk a block
        assert shape["smem"] == (1024 + S * (2 * NW * 128 + rows_bytes + 8)
                                 + 128 + ub * 16)
        assert shape["images"] == (shape["clusters"] * C
                                   * shape["k_slice"] // 32 * 2 * NW * 128)


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_rollout_shape_at_the_flagship_fits_the_h100(cell, forward):
    """The reconstructor's widths (B = 100, H = 1536) on the H100, first at
    sms / cluster clusters and then at the clusters the card holds (the
    backward's 15 clusters of 8 give 13 units a block, 104 rows): one pass,
    the largest wgmma widths, within 227 KB; the f32 body within it too."""
    bf16 = torch.bfloat16
    first = rollout.rollout_shape(cell, forward, bf16, 100, 1536, **H100)
    assert first["clusters"] == (64 if forward else 16)
    shape = rollout.rollout_shape(cell, forward, bf16, 100, 1536, **H100,
                                  cap=H100_CAP[forward])
    _shape_holds(cell, forward, bf16, 100, 1536, shape, H100["smem_limit"])
    assert shape["pass_rows"] == 104
    assert shape["rows"] == (96 if forward else 104)
    assert shape["clusters"] == (64 if forward else 15)
    assert shape["stages"] >= 5
    f32 = rollout.rollout_shape(cell, forward, torch.float32, 100, 1536,
                                **H100, cap=H100_CAP[forward])
    _shape_holds(cell, forward, torch.float32, 100, 1536, f32,
                 H100["smem_limit"])
    # the f32 body's launch: the bf16 body's grid, 5 slots; the LSTM's tile
    # images 75.5 MB forward (128 blocks of 24 chunks) and 76.7 MB backward
    for key in ("clusters", "units", "rows", "k_slice", "pass_rows"):
        assert f32[key] == shape[key]
    assert f32["stages"] == 5
    assert f32["smem"] == (199144 if forward else 209400)
    if cell == "LSTM":
        assert f32["images"] == (128 * 24 * 2 * 96 * 128 if forward
                                 else 120 * 24 * 2 * 104 * 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(100, 37), (7, 37), (7, 200), (130, 64),
                                 (100, 512), (100, 1024)])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_rollout_shape_at_odd_widths(cell, forward, B, H, dtype):
    """The card tests' odd widths (H not a multiple of 16, B = 7, B = 130 in
    two passes) and the widths between: the same invariants."""
    shape = rollout.rollout_shape(cell, forward, dtype, B, H, **H100)
    _shape_holds(cell, forward, dtype, B, H, shape, H100["smem_limit"])
    if B > 104:
        assert shape["pass_rows"] == 104      # two passes


def test_rollout_shape_of_widths_no_block_holds():
    """Widths past both bodies': more product rows than 104 (rollout_plan
    refuses them by name); bf16's held slice beyond the card's memory; a k
    slice past the readiness scan's 4096 columns. The f32 body holds no
    slice of W_hh: at that depth it fits."""
    bf16, f32 = torch.bfloat16, torch.float32
    for dtype in (bf16, f32):
        wide = rollout.rollout_shape("LSTM", True, dtype, 100, 4096, **H100)
        assert wide["rows"] > rollout.ROLLOUT_WIDTHS[-1]
    deep = rollout.rollout_shape("LSTM", True, bf16, 100, 8192, **H100,
                                 clusters=4096)
    assert deep["rows"] == 32 and deep["smem"] > H100["smem_limit"]
    deep = rollout.rollout_shape("LSTM", True, f32, 100, 8192, **H100,
                                 clusters=4096)
    assert deep["rows"] == 32 and deep["smem"] <= H100["smem_limit"]
    long = rollout.rollout_shape("LSTM", True, f32, 100, 16384, **H100,
                                 clusters=8192)
    assert long["k_slice"] > 32 * rollout._READY


def _h100(monkeypatch):
    """rollout_plan's card queries answered as the H100 answers them (132
    SMs, 232,448 bytes a block, 1024 readiness words; H100_CAP clusters at
    once of a shape a block holds, none of one it does not)."""
    monkeypatch.setattr(rollout, "_plans", {})
    monkeypatch.setattr(rollout, "_device_info",
                        lambda device: (H100["sms"], H100["smem_limit"], 1024))

    def capacity(plan, cell, forward, dtype, device):
        fits = plan["smem"] <= plan["smem_limit"] and \
            plan["rows"] in rollout.ROLLOUT_WIDTHS
        return H100_CAP[forward] if fits else 0
    monkeypatch.setattr(rollout, "_capacity", capacity)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,whole", [(1536, True), (1560, True),
                                     (1568, False), (2048, False)])
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_route_rule_by_shape_on_the_h100(monkeypatch, cell, H, whole,
                                         dtype):
    """ops.rnn.whole_rollout on the H100's answers, before any launch: the
    flagship's reconstructor (B = 100, H = 1536) and widths up to the
    backward's 15 clusters x 8 x 13 units = 1560 run whole; from 1568 (14
    units a block, 112 product rows) and at the ResNet features' 2048 the
    rule takes the per-step route, where rollout_plan would raise the
    ValueError rollout_refusal names."""
    _h100(monkeypatch)
    cuda = torch.device("cuda", 0)
    assert rollout.rollout_holds(cell, dtype, 100, H, cuda) == whole
    assert t_rnn.whole_rollout(cell, dtype, 100, H, cuda) == whole
    back = rollout._plan(cell, False, dtype, 100, H, cuda, 0)[0]
    err = rollout.rollout_refusal(back)
    if whole:
        assert err is None and back["rows"] <= 104
        assert rollout.rollout_plan(cell, False, dtype, 100, H,
                                    cuda)[0] is back
    else:
        assert isinstance(err, ValueError) and "product rows" in str(err)
        with pytest.raises(ValueError, match="product rows"):
            rollout.rollout_plan(cell, False, dtype, 100, H, cuda)


def test_rollout_refusal_names_each_limit():
    """rollout_refusal on plans past each of rollout_plan's limits: the
    rows, the pairs a pass, the k slice, the shared memory (ValueError) and
    the clusters the card holds at once (RuntimeError); None on the
    flagship's plan."""
    plan = rollout.rollout_shape("LSTM", False, torch.float32, 100, 1536,
                                 **H100, cap=H100_CAP[False])
    plan.update(smem_limit=H100["smem_limit"], capacity=H100_CAP[False],
                words=1024)
    assert rollout.rollout_refusal(plan) is None
    for change, kind, words in (
            (dict(rows=112), ValueError, "product rows"),
            (dict(units=16), ValueError, "pairs"),
            (dict(k_slice=8192), ValueError, "k slice"),
            (dict(smem=H100["smem_limit"] + 1), ValueError, "shared memory"),
            (dict(capacity=14), RuntimeError, "co-resident"),
            (dict(words=64), ValueError, "blocks")):
        err = rollout.rollout_refusal({**plan, **change})
        assert type(err) is kind and words in str(err)
