"""Checkpoints both ways between the packages: the port writes the JAX
npz layout (leaves in flatten order, the structure hash JAX checks) and
reads the whole JAX training state back for ``--resume``."""

import itertools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from recnet_tpu import checkpoint as j_ckpt
from recnet_tpu.data.vocab import Vocab as JaxVocab
from recnet_tpu.training import step as j_step
from recnet_tpu_torch import checkpoint as t_ckpt
from recnet_tpu_torch.data.vocab import Vocab
from recnet_tpu_torch.models import decoder as t_dec
from recnet_tpu_torch.models import reconstructors as t_rec
from recnet_tpu_torch.training import step as t_step

from torch_train_fixtures import (NO_DROPOUT, VOCAB, assert_trees_close,
                                  batch, configs, t)

VOCAB_JSON = json.dumps({
    "min_count": 1, "max_sentence_len": 8,
    "word2idx": dict({"<PAD>": 0, "<SOS>": 1, "<EOS>": 2},
                     **{f"w{i}": i for i in range(3, VOCAB)})})


@pytest.mark.parametrize(
    "recon,amsgrad,wd",
    list(itertools.product([None, "global", "local"], [True, False],
                           [1e-5, 0.0])))
def test_structure_hash_matches_jax(recon, amsgrad, wd):
    """meta.json's structure, pinned per variant: JAX refuses any other."""
    jtc, ttc = configs(recon, decoder_use_amsgrad=amsgrad,
                       reconstructor_use_amsgrad=not amsgrad,
                       decoder_weight_decay=wd, reconstructor_weight_decay=wd)
    jstate, _, _ = j_step.init_train_state(jax.random.PRNGKey(0), jtc, VOCAB)
    assert t_ckpt.structure_string(ttc, VOCAB) == str(
        jax.tree_util.tree_structure(jstate))
    assert t_ckpt.fingerprint(ttc, VOCAB) == j_ckpt._fingerprint(jstate)


def _port_steps(ttc, n, seed=0):
    state, dcfg, rcfg = t_step.init_train_state(seed, ttc, VOCAB, "cpu")
    fn = t_step.build_train_step(ttc, dcfg, rcfg)
    rng = np.random.default_rng(12)
    for _ in range(n):
        videos, captions = batch(rng, ttc)
        fn(state, t(videos), t(captions))
    return state


@pytest.mark.parametrize("recon", [None, "global", "local"])
def test_port_checkpoint_restores_in_jax(tmp_path, recon):
    jtc, ttc = configs(recon)
    state = _port_steps(ttc, 2)
    step_dir = t_ckpt.save_checkpoint(str(tmp_path), 2, state, ttc,
                                      Vocab.from_json(VOCAB_JSON))
    example, _, _ = j_step.init_train_state(jax.random.PRNGKey(1), jtc,
                                            VOCAB)
    restored, meta = j_ckpt.load_checkpoint(step_dir, example)
    assert meta["step"] == 2 and int(restored.step) == 2
    assert_trees_close(jax.tree_util.tree_leaves(restored),
                       t_ckpt.state_leaves(state), rtol=0, atol=0,
                       what="restored")
    # and back into the port
    again, meta = t_ckpt.load_checkpoint(step_dir, ttc, VOCAB, "cpu")
    for a, b in zip(t_ckpt.state_leaves(again), t_ckpt.state_leaves(state)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("recon", ["global", "local"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, recon):
    """JAX trains two steps and saves; the port resumes from the file and
    its next step equals JAX's next step."""
    jtc, ttc = configs(recon, **NO_DROPOUT)
    jstate, dcfg, rcfg = j_step.init_train_state(jax.random.PRNGKey(2), jtc,
                                                 VOCAB)
    j_fn = j_step.build_train_step(jtc, dcfg, rcfg)
    rng = np.random.default_rng(13)
    key = jax.random.PRNGKey(0)
    batches = [batch(rng, jtc) for _ in range(3)]
    for videos, captions in batches[:2]:
        jstate, _ = j_fn(jstate, jnp.asarray(videos), jnp.asarray(captions),
                         key)
    step_dir = j_ckpt.save_checkpoint(str(tmp_path), 2, jstate, jtc,
                                      JaxVocab.from_json(VOCAB_JSON))
    tstate, meta = t_ckpt.load_checkpoint(step_dir, ttc, VOCAB, "cpu")
    assert tstate.step == 2 and meta["step"] == 2
    videos, captions = batches[2]
    jstate, jm = j_fn(jstate, jnp.asarray(videos), jnp.asarray(captions),
                      key)
    tm = t_step.build_train_step(
        ttc, t_dec.config_from_train(ttc, VOCAB),
        t_rec.config_from_train(ttc))(tstate, t(videos), t(captions))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert_trees_close(t_ckpt.state_leaves(tstate),
                       jax.tree_util.tree_leaves(jstate), rtol=1e-4,
                       atol=1e-6, what="next step")


def test_load_refuses_another_config(tmp_path):
    _, ttc = configs("global")
    state = _port_steps(ttc, 0)
    step_dir = t_ckpt.save_checkpoint(str(tmp_path), 0, state, ttc,
                                      Vocab.from_json(VOCAB_JSON))
    _, other = configs("local")
    with pytest.raises(ValueError, match="structure"):
        t_ckpt.load_checkpoint(step_dir, other, VOCAB, "cpu")


def test_prune_old_and_latest_step(tmp_path):
    for step in (3, 10, 7):
        (tmp_path / str(step)).mkdir()
    (tmp_path / "notastep").mkdir()
    assert t_ckpt.latest_step(str(tmp_path)) == 10
    t_ckpt.prune_old(str(tmp_path), 2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["10", "7",
                                                         "notastep"]
    assert t_ckpt.latest_step(str(tmp_path / "none")) is None
