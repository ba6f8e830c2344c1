"""The port's ``beam_decode`` against JAX ``beam_decode``, f32 on the CPU.

Mirrors the beam cases of tests/test_decoding.py (the same peaky fixtures:
out_w x 8, so EOS/PAD get emitted and candidate margins are clear) and
tests/test_pallas_topk.py (the kernel route). Tokens and n_steps must be
equal. Scores within rtol 1e-5: the port's attention sums and
``logsigmoid`` may differ from XLA's in the last ulp, and the cumulative
score carries that through the steps. And within atol 1e-30: at the
saturation clamp (logit 87.34) ``logsigmoid`` gives -1.5e-38 in PyTorch,
where XLA on the CPU flushes it to 0. On the CPU the kernel route
(``use_pallas_topk=True``) runs K3's plain twin, which pins the loop the
card runs around the kernel."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recnet_tpu import decoding as j_decoding
from recnet_tpu.models import decoder as j_dec
from recnet_tpu_torch import decoding as t_decoding
from recnet_tpu_torch.models import decoder as t_dec
from recnet_tpu_torch.weights import params_from_jax

B, F, ENC, V, E, H, A = 4, 6, 18, 23, 8, 12, 7
MAX_LEN = 9
PAD, SOS, EOS = 0, 1, 2
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-30


def _cfgs(cell_type, n_layers=1, vocab=V, enc=ENC, emb=E, hidden=H,
          attn=A):
    kw = dict(cell_type=cell_type, n_layers=n_layers, vocab_size=vocab,
              embedding_size=emb, embedding_scale=1.0, encoder_size=enc,
              hidden_size=hidden, attn_size=attn, embedding_dropout=0.0,
              dropout=0.0, out_dropout=0.0, sos_token=SOS, pad_token=PAD,
              eos_token=EOS)
    return j_dec.DecoderConfig(**kw), t_dec.DecoderConfig(**kw)


def _setup(cell_type, seed, peaky=True, n_layers=1):
    """tests/test_decoding.py's fixture, and its copy for the port."""
    jcfg, tcfg = _cfgs(cell_type, n_layers)
    params = j_dec.init_decoder_params(jax.random.PRNGKey(seed), jcfg)
    if peaky:
        params = dict(params, out_w=params["out_w"] * 8.0)
    enc = np.random.default_rng(seed).standard_normal(
        (B, F, ENC)).astype(np.float32)
    return jcfg, tcfg, params, enc


def _to_port(params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _run(jcfg, tcfg, params, enc, K, max_len=MAX_LEN, **kw):
    """(JAX result, port result) on the same weights and features."""
    j_kw = dict(kw)
    if j_kw.pop("use_pallas_topk", False):
        j_kw.update(use_pallas_topk=True, interpret=True)
    want = j_decoding.beam_decode(params, jcfg, jnp.asarray(enc), K, max_len,
                                  **j_kw)
    got = t_decoding.beam_decode(_to_port(params), tcfg,
                                 torch.from_numpy(enc), K, max_len, **kw)
    return want, got


def _assert_equal(want, got, scores=True):
    assert got.n_steps == int(want.n_steps)
    assert got.tokens.dtype == torch.int32
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    if scores:
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), rtol=SCORE_RTOL,
                                   atol=SCORE_ATOL)


def _sentences(res):
    idx2word = {i: f"w{i}" for i in range(V)}
    tokens = np.asarray(res.tokens)[:, : int(res.n_steps)].T
    return j_decoding.tokens_to_sentences(tokens, idx2word, EOS)


@pytest.mark.parametrize("cell_type", ["GRU", "LSTM"])
@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_decode_matches_jax(cell_type, K, seed):
    jcfg, tcfg, params, enc = _setup(cell_type, seed)
    want, got = _run(jcfg, tcfg, params, enc, K)
    assert got.tokens.shape == (B, MAX_LEN + 1)
    assert got.scores.shape == (B, K)
    _assert_equal(want, got)


@pytest.mark.parametrize("cell_type", ["GRU", "LSTM"])
def test_beam_decode_two_layers_matches_jax(cell_type):
    jcfg, tcfg, params, enc = _setup(cell_type, 3, n_layers=2)
    want, got = _run(jcfg, tcfg, params, enc, 3)
    _assert_equal(want, got)


@pytest.mark.parametrize("cell_type,K", [("GRU", 5), ("LSTM", 3)])
def test_beam_early_exit_matches_scan(cell_type, K):
    """early_exit stops at the all-<PAD> step with the scan's output, in
    the port and against JAX's while-loop."""
    jcfg, tcfg, params, enc = _setup(cell_type, 2)
    want, got = _run(jcfg, tcfg, params, enc, K, early_exit=True)
    _assert_equal(want, got)
    scan = t_decoding.beam_decode(_to_port(params), tcfg,
                                  torch.from_numpy(enc), K, MAX_LEN)
    assert scan.n_steps == got.n_steps
    np.testing.assert_array_equal(scan.tokens.numpy(), got.tokens.numpy())


def test_beam_early_exit_stops_on_all_pad():
    """A model that prefers <PAD> stops once every beam's word is <PAD>
    (step 2: at step 1 the K slots hold beam 0's K best words); the rest
    of the history stays <PAD>."""
    jcfg, tcfg, params, enc = _setup("GRU", 4)
    params = dict(params, out_b=params["out_b"].at[PAD].set(50.0))
    want, got = _run(jcfg, tcfg, params, enc, 3, early_exit=True)
    assert got.n_steps == 2
    assert (got.tokens[:, 2:] == PAD).all()
    _assert_equal(want, got)


@pytest.mark.parametrize("cell_type,K,seed", [("GRU", 5, 0), ("GRU", 3, 1),
                                              ("LSTM", 3, 2)])
def test_beam_length_cutoff_matches_jax(cell_type, K, seed):
    """length_cutoff_margin: the port stops where JAX stops, with JAX's
    sentences, which are the full scan's."""
    jcfg, tcfg, params, enc = _setup(cell_type, seed)
    want, got = _run(jcfg, tcfg, params, enc, K, length_cutoff_margin=2)
    _assert_equal(want, got)
    full = t_decoding.beam_decode(_to_port(params), tcfg,
                                  torch.from_numpy(enc), K, MAX_LEN)
    assert _sentences(got) == _sentences(full) == _sentences(want)
    assert got.n_steps <= full.n_steps


def test_beam_length_cutoff_engages_on_eos_repeater():
    """Beams that emit <EOS> every step: the cutoff keys on the first
    <EOS> and stops after first_eos + 1 + margin, as JAX does."""
    jcfg, tcfg, params, enc = _setup("GRU", 0, peaky=False)
    out_b = np.zeros(V, np.float32)
    out_b[EOS], out_b[5] = 10.0, 8.0
    params = dict(params, out_w=params["out_w"] * 0.0,
                  out_b=jnp.asarray(out_b))
    want, got = _run(jcfg, tcfg, params, enc, 3, length_cutoff_margin=2)
    _assert_equal(want, got)
    full = t_decoding.beam_decode(_to_port(params), tcfg,
                                  torch.from_numpy(enc), 3, MAX_LEN)
    assert got.n_steps <= 4 < full.n_steps
    assert _sentences(got) == _sentences(full)


@pytest.mark.parametrize("cell_type", ["GRU", "LSTM"])
def test_beam_saturated_logits_tie_break_by_word_index(cell_type):
    """Two distinct saturated logits (110 < 111) clamp to one value before
    ranking, so the plain route ranks them by word, as JAX does; the CPU
    keeps subnormals, unlike a TPU, and the clamp still decides."""
    jcfg, tcfg, params, enc = _setup(cell_type, 0, peaky=False)
    out_b = np.zeros(V, np.float32)
    out_b[5], out_b[9] = 110.0, 111.0
    params = dict(params, out_w=params["out_w"] * 0.0,
                  out_b=jnp.asarray(out_b))
    want, got = _run(jcfg, tcfg, params, enc, 3)
    assert got.tokens[:, 0].tolist() == [5] * B
    _assert_equal(want, got)


@pytest.mark.parametrize("cell_type", ["GRU", "LSTM"])
def test_beam_saturated_logits_kernel_route_matches_jax(cell_type):
    """The kernel route ranks raw logits and clamps what it returns, like
    JAX's Pallas route: 111 outranks 110 there."""
    jcfg, tcfg, params, enc = _setup(cell_type, 0, peaky=False)
    out_b = np.zeros(V, np.float32)
    out_b[5], out_b[9] = 110.0, 111.0
    params = dict(params, out_w=params["out_w"] * 0.0,
                  out_b=jnp.asarray(out_b))
    want, got = _run(jcfg, tcfg, params, enc, 3, use_pallas_topk=True)
    assert got.tokens[:, 0].tolist() == [9] * B
    _assert_equal(want, got)


@pytest.mark.parametrize("cell_type,n_layers", [("GRU", 1), ("LSTM", 1),
                                                ("GRU", 2)])
def test_beam_kernel_route_matches_jax_interpret(cell_type, n_layers):
    """use_pallas_topk (K3's twin on the CPU) against JAX's Pallas route in
    interpret mode, and against the port's plain route, token for token;
    the shapes of tests/test_pallas_topk.py:56-72."""
    jcfg, tcfg = _cfgs(cell_type, n_layers, vocab=40, enc=16, emb=8,
                       hidden=12, attn=6)
    params = j_dec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    params = dict(params, out_w=params["out_w"] * 8.0)
    enc = np.random.default_rng(3).standard_normal(
        (6, 5, 16)).astype(np.float32)
    want, got = _run(jcfg, tcfg, params, enc, 5, max_len=12,
                     use_pallas_topk=True)
    _assert_equal(want, got)
    plain = t_decoding.beam_decode(_to_port(params), tcfg,
                                   torch.from_numpy(enc), 5, 12)
    assert plain.n_steps == got.n_steps
    np.testing.assert_array_equal(plain.tokens.numpy(), got.tokens.numpy())


def test_beam_decode_keeps_the_encoder_dtype():
    """bf16 features: cum_prob and the state stay bf16, tokens int32."""
    _, tcfg, params, enc = _setup("GRU", 0)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         dtype=torch.bfloat16)
    for route in (False, True):
        res = t_decoding.beam_decode(tp, tcfg,
                                     torch.from_numpy(enc).bfloat16(), 3,
                                     MAX_LEN, use_pallas_topk=route)
        assert res.scores.dtype == torch.bfloat16
        assert res.tokens.dtype == torch.int32
        assert torch.isfinite(res.scores.float()).all()
