"""Shared set-up of the training parity tests (tests/test_torch_train*.py):
the same tiny config in both packages, batches from numpy seeds, and JAX
state carried into the port. Sizes are those of tests/test_train_step.py."""

from __future__ import annotations

import numpy as np
import torch

import jax

from recnet_tpu.config import TrainConfig as JaxTrainConfig
from recnet_tpu.training import step as j_step
from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.weights import train_state_from_jax

TINY = dict(
    caption_max_len=8, batch_size=4, embedding_size=12,
    encoder_output_size=20, encoder_output_len=6,
    decoder_hidden_size=16, decoder_attn_size=8,
    reconstructor_hidden_size=20, reconstructor_attn_size=8,
    decoder_learning_rate=1e-2, reconstructor_learning_rate=1e-3,
)
NO_DROPOUT = dict(embedding_dropout=0.0, decoder_dropout=0.0,
                  decoder_out_dropout=0.0, reconstructor_dropout=0.0,
                  reconstructor_decoder_dropout=0.0)
VOCAB = 25


def configs(recon=None, **overrides):
    """(JAX TrainConfig, port TrainConfig) with the same fields."""
    kw = dict(TINY, use_recon=recon is not None,
              reconstructor_type=recon or "global")
    kw.update(overrides)
    return JaxTrainConfig(**kw), TrainConfig(**kw)


def batch(rng, tc, vocab_size=VOCAB):
    """numpy videos (B, L, F) float32 and captions (T, B) int32: words,
    one <EOS>, then <PAD>; the longest caption ends before T, so the last
    step has an all-zero mask."""
    T = tc.caption_max_len + 1
    videos = rng.standard_normal(
        (tc.batch_size, tc.encoder_output_len, tc.encoder_output_size)
    ).astype(np.float32)
    captions = np.zeros((T, tc.batch_size), np.int32)
    for b in range(tc.batch_size):
        n = int(rng.integers(2, T))
        captions[: n - 1, b] = rng.integers(3, vocab_size, n - 1)
        captions[n - 1, b] = 2
    return videos, captions


def both_states(jtc, ttc, seed=0, vocab_size=VOCAB):
    """JAX's init_train_state and the same state in the port (CPU)."""
    jstate, jdcfg, jrcfg = j_step.init_train_state(
        jax.random.PRNGKey(seed), jtc, vocab_size)
    return jstate, jdcfg, jrcfg, train_state_from_jax(jstate, ttc, "cpu")


def t(x):
    return torch.from_numpy(np.asarray(x))


def assert_trees_close(port_leaves, jax_leaves, rtol, atol, what=""):
    assert len(port_leaves) == len(jax_leaves), what
    for i, (a, b) in enumerate(zip(port_leaves, jax_leaves)):
        a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=f"{what} leaf {i}")
