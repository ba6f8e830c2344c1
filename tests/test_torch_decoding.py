"""The port's greedy decodes against JAX ``greedy_decode``, f32 on the CPU.

Mirrors tests/test_decoding.py (early exit) and tests/test_pallas_fused.py
(whole and segmented decodes): tokens and n_steps equal; with ``eos_stop``
the sentences are equal. On the CPU the kernel decodes run the kernels'
plain twins, so these tests pin the decode loops the card runs."""

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

B, L, F, E, H, A, V = 16, 7, 24, 12, 16, 8, 40
MAX_LEN = 9


def _setup(cell, seed=9, n_layers=1, scale=1.0, eos_bias=None):
    kw = dict(cell_type=cell, n_layers=n_layers, vocab_size=V,
              embedding_size=E, embedding_scale=scale, encoder_size=F,
              hidden_size=H, attn_size=A)
    jcfg, tcfg = j_dec.DecoderConfig(**kw), t_dec.DecoderConfig(**kw)
    params = j_dec.init_decoder_params(jax.random.PRNGKey(seed), jcfg)
    params = dict(params, out_w=params["out_w"] * 8.0)  # EOS/PAD emission
    if eos_bias is not None:
        params["out_b"] = params["out_b"].at[jcfg.eos_token].set(eos_bias)
    enc = np.random.default_rng(seed).standard_normal(
        (B, L, F)).astype(np.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jcfg, tcfg, params, tp, enc


def _jax_greedy(jcfg, params, enc, **kw):
    res = j_decoding.greedy_decode(params, jcfg, jnp.asarray(enc), MAX_LEN,
                                   **kw)
    return np.asarray(res.tokens), int(res.n_steps)


def _assert_same_prefix(got, want_tokens, want_n):
    assert got.n_steps == want_n
    np.testing.assert_array_equal(got.tokens.numpy()[:want_n],
                                  want_tokens[:want_n])


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
@pytest.mark.parametrize("early_exit", [False, True])
def test_greedy_decode_matches_jax(cell, early_exit):
    jcfg, tcfg, params, tp, enc = _setup(cell, seed=1)
    want, n = _jax_greedy(jcfg, params, enc, early_exit=early_exit)
    got = t_decoding.greedy_decode(tp, tcfg, torch.from_numpy(enc), MAX_LEN,
                                   early_exit=early_exit)
    assert got.tokens.shape == (MAX_LEN + 1, B)
    assert got.n_steps == n
    np.testing.assert_array_equal(got.tokens.numpy(), want)


def test_greedy_decode_two_layers_matches_jax():
    jcfg, tcfg, params, tp, enc = _setup("GRU", seed=2, n_layers=2)
    want, n = _jax_greedy(jcfg, params, enc)
    got = t_decoding.greedy_decode(tp, tcfg, torch.from_numpy(enc), MAX_LEN)
    assert got.n_steps == n
    np.testing.assert_array_equal(got.tokens.numpy(), want)


def test_greedy_decode_stops_on_all_pad():
    """A model that emits <PAD> at once: n_steps 1 and a <PAD> tail."""
    jcfg, tcfg, params, tp, enc = _setup("GRU", seed=3)
    params = dict(params, out_b=params["out_b"].at[0].set(50.0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    want, n = _jax_greedy(jcfg, params, enc, early_exit=True)
    got = t_decoding.greedy_decode(tp, tcfg, torch.from_numpy(enc), MAX_LEN,
                                   early_exit=True)
    assert n == got.n_steps == 1
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    seg = t_decoding.greedy_decode_whole_segmented(
        tp, tcfg, torch.from_numpy(enc), MAX_LEN, segment=4)
    _assert_same_prefix(seg, want, 1)


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_greedy_decode_whole_matches_jax(cell):
    jcfg, tcfg, params, tp, enc = _setup(cell, seed=9)
    want, n = _jax_greedy(jcfg, params, enc)
    got = t_decoding.greedy_decode_whole(tp, tcfg, torch.from_numpy(enc),
                                         MAX_LEN)
    _assert_same_prefix(got, want, n)


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
@pytest.mark.parametrize("pad_bias", [None, 4.0])
def test_greedy_decode_whole_early_exit_matches_jax(cell, pad_bias):
    """early_exit (K5) against JAX ``greedy_decode_whole(block_b=8,
    early_exit=True)`` on two tiles: tokens and n_steps exact."""
    jcfg, tcfg, params, tp, enc = _setup(cell, seed=9)
    if pad_bias is not None:
        params = dict(params, out_b=params["out_b"].at[0].add(pad_bias))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    want = j_decoding.greedy_decode_whole(params, jcfg, jnp.asarray(enc),
                                          MAX_LEN, block_b=8,
                                          early_exit=True, interpret=True)
    got = t_decoding.greedy_decode_whole(tp, tcfg, torch.from_numpy(enc),
                                         MAX_LEN, early_exit=True)
    assert got.n_steps == int(want.n_steps)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
@pytest.mark.parametrize("segment", [1, 3, 4, 8, 12])
def test_greedy_decode_whole_segmented_matches_jax(cell, segment):
    jcfg, tcfg, params, tp, enc = _setup(cell, seed=9)
    want, n = _jax_greedy(jcfg, params, enc)
    got = t_decoding.greedy_decode_whole_segmented(
        tp, tcfg, torch.from_numpy(enc), MAX_LEN, segment=segment)
    _assert_same_prefix(got, want, n)


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_eos_stop_is_sentence_exact(cell):
    """eos_stop stops once every row has an <EOS>: the tokens past the
    stop are <PAD>, the sentences equal JAX's."""
    jcfg, tcfg, params, tp, enc = _setup(cell, seed=9, eos_bias=6.0)
    want, n = _jax_greedy(jcfg, params, enc)
    got = t_decoding.greedy_decode_whole_segmented(
        tp, tcfg, torch.from_numpy(enc), MAX_LEN, segment=3, eos_stop=True)
    idx2word = {i: f"w{i}" for i in range(V)}
    assert (t_decoding.tokens_to_sentences(
        got.tokens.numpy()[:got.n_steps], idx2word, jcfg.eos_token)
        == j_decoding.tokens_to_sentences(want[:n], idx2word,
                                          jcfg.eos_token))
    assert got.n_steps <= n
    # the stop engaged: at least the last segment was never run
    assert (got.tokens.numpy()[-1] == jcfg.pad_token).all()


@pytest.mark.parametrize("route", ["greedy", "whole", "segmented"])
def test_embedding_scale_half_matches_jax_greedy(route):
    """The port applies embedding_scale in the kernel decodes as well
    (the JAX kernel path leaves it out; ROADMAP Queue 3)."""
    jcfg, tcfg, params, tp, enc = _setup("GRU", seed=4, scale=0.5)
    want, n = _jax_greedy(jcfg, params, enc)
    t_enc = torch.from_numpy(enc)
    if route == "greedy":
        got = t_decoding.greedy_decode(tp, tcfg, t_enc, MAX_LEN)
    elif route == "whole":
        got = t_decoding.greedy_decode_whole(tp, tcfg, t_enc, MAX_LEN)
    else:
        got = t_decoding.greedy_decode_whole_segmented(tp, tcfg, t_enc,
                                                       MAX_LEN, segment=4)
    _assert_same_prefix(got, want, n)


def test_kernels_supported_decides_by_config():
    def cfg(cell, layers=1):
        return t_dec.DecoderConfig(cell_type=cell, n_layers=layers)
    assert t_decoding.kernels_supported(cfg("GRU"), "greedy_whole")
    assert t_decoding.kernels_supported(cfg("LSTM"), "greedy_whole")
    assert not t_decoding.kernels_supported(cfg("GRU", 2), "greedy_whole")
    for cell, layers in (("GRU", 1), ("LSTM", 1), ("GRU", 2), ("LSTM", 3)):
        assert t_decoding.kernels_supported(cfg(cell, layers), "beam_topk")
    with pytest.raises(ValueError, match="no ported kernel"):
        t_decoding.kernels_supported(cfg("GRU"), "fused_step")
    _, tcfg2, _, tp2, enc = _setup("GRU", n_layers=2)
    with pytest.raises(ValueError, match="1-layer"):
        t_decoding.greedy_decode_whole(tp2, tcfg2, torch.from_numpy(enc), 3)


def test_tokens_to_sentences_matches_jax():
    idx2word = {0: "<PAD>", 1: "<SOS>", 2: "<EOS>", 3: "cat", 4: "runs"}
    idxs = np.array([[3, 3], [4, 2], [2, 4]])
    assert (t_decoding.tokens_to_sentences(idxs, idx2word, 2)
            == j_decoding.tokens_to_sentences(idxs, idx2word, 2)
            == ["cat runs", "cat"])
