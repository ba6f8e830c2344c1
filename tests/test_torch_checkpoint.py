"""The port reads checkpoints that recnet_tpu.checkpoint writes, and the
slice as a whole: the port's Captioner.from_checkpoint (use_pallas,
greedy_segment=4, f32, CPU) captions like the JAX Captioner.

On the CPU the port runs greedy_decode_whole_segmented with the plain twin
of K2; JAX runs its XLA greedy_decode(early_exit=True), because
pallas_supported is False off the TPU. Equal sentences tie the port's
kernel-path decode loop to the JAX reference semantics."""

import dataclasses
import os

import numpy as np
import pytest

import jax

from recnet_tpu import checkpoint as j_ckpt
from recnet_tpu.data import Corpus
from recnet_tpu.serving import Captioner as JaxCaptioner
from recnet_tpu.training.step import init_train_state
from recnet_tpu_torch import checkpoint as t_ckpt
from recnet_tpu_torch.serving import Captioner as TorchCaptioner

from fixtures import make_msvd_fixture, tiny_train_config


def _save(tmp_path_factory, cell, eos_bias=None, **overrides):
    root = str(tmp_path_factory.mktemp(f"msvd_{cell}"))
    make_msvd_fixture(root)
    tc = tiny_train_config(root, decoder_model=cell, **overrides)
    vocab = Corpus(tc).vocab
    state, _, _ = init_train_state(jax.random.PRNGKey(0), tc, vocab.n_vocabs)
    if eos_bias is not None:
        dec = dict(state.dec_params)
        dec["out_w"] = dec["out_w"] * 8.0
        dec["out_b"] = dec["out_b"].at[2].set(eos_bias)
        state = state._replace(dec_params=dec)
    d = j_ckpt.save_checkpoint(str(tmp_path_factory.mktemp("ck")), 1, state,
                               tc, vocab)
    return d, tc, vocab, state


@pytest.mark.parametrize("cell,n_layers", [("GRU", 1), ("LSTM", 2)])
def test_load_decoder_params_is_bit_equal(tmp_path_factory, cell, n_layers):
    d, tc, vocab, state = _save(tmp_path_factory, cell,
                                decoder_n_layers=n_layers)
    got = t_ckpt.load_decoder_params(d, tc, vocab.n_vocabs)
    want = jax.tree_util.tree_map(np.asarray, state.dec_params)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    tc2, vocab2 = t_ckpt.load_config_and_vocab(d)
    # the port's own TrainConfig: equal field by field, and the same id
    assert dataclasses.asdict(tc2) == dataclasses.asdict(tc)
    assert tc2.id == tc.id and vocab2.word2idx == vocab.word2idx


def test_load_decoder_params_rejects_mismatch_and_orbax(tmp_path_factory):
    d, tc, vocab, _ = _save(tmp_path_factory, "GRU")
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.load_decoder_params(d, tc.replace(decoder_hidden_size=17),
                                   vocab.n_vocabs)
    os.makedirs(os.path.join(d, "state_orbax"))
    with pytest.raises(ValueError, match="orbax"):
        t_ckpt.load_decoder_params(d, tc, vocab.n_vocabs)


@pytest.mark.parametrize("cell,eos_bias", [("GRU", None), ("GRU", 4.0),
                                           ("LSTM", 4.0)])
def test_slice_captions_equal_jax(tmp_path_factory, cell, eos_bias):
    d, tc, _, _ = _save(tmp_path_factory, cell, eos_bias=eos_bias)
    kw = dict(dtype="float32", batch_size=8, use_pallas=True,
              greedy_segment=4)
    jax_cap = JaxCaptioner.from_checkpoint(d, **kw)
    port = TorchCaptioner.from_checkpoint(d, device="cpu", **kw)
    rng = np.random.default_rng(11)
    feats = [rng.standard_normal((n, 32)).astype(np.float32)
             for n in (3, 6, 9, 14, 20, 31, 45, 5, 8, 12, 60)]
    want = jax_cap.caption(feats)
    got = port.caption(feats)
    assert len(got) == len(feats)
    assert got == want
    if eos_bias is not None:          # the EOS stop made some captions short
        assert min(len(s.split()) for s in got) < tc.caption_max_len
