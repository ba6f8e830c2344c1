"""Long-horizon training parity of the port (slow tier): the mirrors of
tests/test_trajectory.py and tests/test_convergence.py.

The port's composed train step, iterated from the JAX package's initial
state (carried over by ``weights.train_state_from_jax``), against the same
iterations of the torch transcription of the reference recipe
(``torch_train_oracle.TorchTrainer``) and of JAX's ``build_train_step``:
same batches, teacher forcing at 1.0, dropout off, 150 iterations for each
of no reconstructor, global and local, and 600 for global. At one layer
the decoder and the global reconstructor run through the port's
custom-backward Functions (``tf_attn_rollout``, ``rnn_rollout_pre``), so
this is also their long-horizon check. Tolerances are the JAX tests'.
Then the whole stack learns: a tiny corpus overfit in float32 and in
bfloat16 until the port's greedy decode gives back its captions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recnet_tpu.config import TrainConfig as JaxTrainConfig
from recnet_tpu.training import step as j_step
from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.decoding import greedy_decode, tokens_to_sentences
from recnet_tpu_torch.metrics import Bleu
from recnet_tpu_torch.models import decoder as t_dec
from recnet_tpu_torch.models import reconstructors as t_rec
from recnet_tpu_torch.training import step as t_step
from recnet_tpu_torch.utils.misc import tree_leaves
from recnet_tpu_torch.weights import train_state_from_jax

from test_trajectory import B, N_BATCHES, T_MAX, V, _batches
from torch_train_oracle import TorchTrainer

pytestmark = pytest.mark.slow

torch.backends.cuda.matmul.allow_tf32 = False


def _configs(recon_kind):
    """(JAX TrainConfig, port TrainConfig) of tests/test_trajectory.py."""
    kw = dict(
        caption_max_len=T_MAX, batch_size=B, embedding_size=12,
        encoder_output_size=20, encoder_output_len=6,
        decoder_hidden_size=16, decoder_attn_size=8,
        reconstructor_hidden_size=20, reconstructor_attn_size=8,
        use_recon=recon_kind is not None,
        reconstructor_type=recon_kind or "global",
        decoder_model="GRU", reconstructor_model="LSTM",
        embedding_dropout=0.0, decoder_dropout=0.0, decoder_out_dropout=0.0,
        reconstructor_dropout=0.0, reconstructor_decoder_dropout=0.0,
        decoder_teacher_forcing_ratio=1.0)
    return JaxTrainConfig(**kw), TrainConfig(**kw)


def _trajectories(recon_kind, n_iters, batch_seed, key_seed):
    """(losses of JAX, the port and the oracle over ``n_iters``
    iterations, the final decoder leaves of each), from one JAX init."""
    jtc, ttc = _configs(recon_kind)
    jstate, dcfg, rcfg = j_step.init_train_state(jax.random.PRNGKey(0), jtc,
                                                 V)
    tstate = train_state_from_jax(jstate, ttc, "cpu")
    trainer = TorchTrainer(
        jax.tree_util.tree_map(np.asarray, jstate.dec_params),
        (jax.tree_util.tree_map(np.asarray, jstate.rec_params)
         if recon_kind else None),
        cell_type="GRU", rec_cell_type="LSTM", caption_max_len=T_MAX,
        dec_lr=jtc.decoder_learning_rate,
        rec_lr=jtc.reconstructor_learning_rate,
        wd=jtc.decoder_weight_decay, grad_clip=jtc.gradient_clip,
        rec_kind=recon_kind or "global", n_rec_steps=jtc.encoder_output_len)
    j_fn = j_step.build_train_step(jtc, dcfg, rcfg)
    t_fn = t_step.build_train_step(
        ttc, t_dec.config_from_train(ttc, V),
        t_rec.config_from_train(ttc) if recon_kind else None)
    batches = _batches(np.random.default_rng(batch_seed))
    key = jax.random.PRNGKey(key_seed)
    losses = {"jax": [], "port": [], "oracle": []}
    for i in range(n_iters):
        videos, caps = batches[i % N_BATCHES]
        jstate, jm = j_fn(jstate, jnp.asarray(videos), jnp.asarray(caps),
                          key)
        losses["jax"].append(float(jm["loss"]))
        losses["port"].append(float(t_fn(tstate, torch.from_numpy(videos),
                                         torch.from_numpy(caps))["loss"]))
        losses["oracle"].append(trainer.step(videos, caps)[0])
    leaves = {
        "jax": [np.asarray(x) for x in
                jax.tree_util.tree_leaves(jstate.dec_params)],
        "port": [x.detach().numpy() for x in tree_leaves(tstate.dec_params)],
        "oracle": [np.asarray(x) for x in jax.tree_util.tree_leaves(
            trainer.dec_params_jax_layout())]}
    return ({k: np.asarray(v) for k, v in losses.items()}, leaves)


def _assert_tracks(losses, leaves, loss_tol, leaf_tol):
    for other in ("jax", "oracle"):      # the largest differences (-rP)
        d = np.abs(losses["port"] - losses[other])
        worst = max(float(np.abs(p - o).max())
                    for p, o in zip(leaves["port"], leaves[other]))
        print(f"port against {other}: losses max |d| {d.max():.3g} (rel "
              f"{np.max(d / np.abs(losses[other])):.3g}); final decoder "
              f"leaves max |d| {worst:.3g}")
    for other in ("jax", "oracle"):
        np.testing.assert_allclose(losses["port"], losses[other],
                                   rtol=loss_tol[0], atol=loss_tol[1],
                                   err_msg=f"losses against {other}")
        assert len(leaves["port"]) == len(leaves[other])
        for i, (p, o) in enumerate(zip(leaves["port"], leaves[other])):
            np.testing.assert_allclose(p, o, rtol=leaf_tol[0],
                                       atol=leaf_tol[1],
                                       err_msg=f"leaf {i} against {other}")
    assert np.ptp(losses["port"]) > 1e-4


@pytest.mark.parametrize("recon_kind", [None, "global", "local"],
                         ids=["none", "global", "local"])
def test_training_trajectory_matches_jax_and_torch(recon_kind):
    """150 iterations (tests/test_trajectory.py:64): losses within rtol
    5e-4 / atol 5e-5, final decoder leaves within 2e-3 / 2e-6, of JAX's
    and of the oracle's."""
    losses, leaves = _trajectories(recon_kind, 150, 7, 3)
    _assert_tracks(losses, leaves, (5e-4, 5e-5), (2e-3, 2e-6))


def test_training_trajectory_long_horizon_global():
    """600 iterations of the global-reconstructor recipe
    (tests/test_trajectory.py:108): losses within rtol 2e-3 / atol 1e-4,
    final decoder leaves within 5e-3 / 5e-6."""
    losses, leaves = _trajectories("global", 600, 11, 5)
    _assert_tracks(losses, leaves, (2e-3, 1e-4), (5e-3, 5e-6))


def _overfit(rng, precision):
    """tests/test_convergence.py's exercise on the port: 400 steps on 4
    videos with fixed captions from JAX's initial state; returns (last
    loss, decoded sentences, expected sentences)."""
    kw = dict(caption_max_len=6, batch_size=4, embedding_size=16,
              encoder_output_size=24, encoder_output_len=5,
              decoder_hidden_size=32, decoder_attn_size=8, use_recon=False,
              decoder_learning_rate=5e-3, embedding_dropout=0.0,
              decoder_out_dropout=0.0, train_precision=precision)
    jtc, tc = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate, _, _ = j_step.init_train_state(jax.random.PRNGKey(0), jtc, 30)
    state = train_state_from_jax(jstate, tc, "cpu")
    dcfg = t_dec.config_from_train(tc, 30)
    step = t_step.build_train_step(tc, dcfg, None)
    T = tc.caption_max_len + 1
    videos = torch.from_numpy(rng.standard_normal(
        (4, tc.encoder_output_len, tc.encoder_output_size)
    ).astype(np.float32))
    caps = np.zeros((T, 4), np.int32)
    sentences = [[3, 4, 5], [6, 7], [8, 9, 10, 11], [12, 13, 14]]
    for b, words in enumerate(sentences):
        caps[: len(words), b] = words
        caps[len(words), b] = 2
    captions = torch.from_numpy(caps)
    for _ in range(400):
        m = step(state, videos, captions)
    with torch.no_grad():
        res = greedy_decode(state.dec_params, dcfg, videos,
                            tc.caption_max_len)
    tokens = res.tokens.numpy()[: int(res.n_steps)]
    idx2word = {i: f"w{i}" for i in range(30)}
    idx2word.update({0: "<PAD>", 1: "<SOS>", 2: "<EOS>"})
    decoded = tokens_to_sentences(tokens, idx2word, 2)
    expected = [" ".join(f"w{w}" for w in s) for s in sentences]
    return float(m["loss"]), decoded, expected


def test_overfit_tiny_corpus_and_decode(rng):
    """tests/test_convergence.py:18: the loss below 1.0, 3 of 4 captions
    decoded exactly, Bleu-1 above 0.9."""
    loss, decoded, expected = _overfit(rng, "float32")
    assert loss < 1.0
    n_exact = sum(d == e for d, e in zip(decoded, expected))
    assert n_exact >= 3, f"decoded={decoded} expected={expected}"
    gts = {str(i): [e] for i, e in enumerate(expected)}
    hyp = {str(i): [d] for i, d in enumerate(decoded)}
    bleu, _ = Bleu(4).compute_score(gts, hyp)
    assert bleu[0] > 0.9


def test_overfit_tiny_corpus_bf16_training(rng):
    """tests/test_convergence.py:64: train_precision='bfloat16' still
    learns the corpus: the loss below 1.0, 3 of 4 captions exact."""
    loss, decoded, expected = _overfit(rng, "bfloat16")
    assert loss < 1.0
    n_exact = sum(d == e for d, e in zip(decoded, expected))
    assert n_exact >= 3, f"decoded={decoded} expected={expected}"
