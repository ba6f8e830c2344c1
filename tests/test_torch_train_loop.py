"""The port's training loop and ``cli.train`` on the CPU: from one JAX
checkpoint both loops take the same iterations to the same losses and
params; the CLI runs its val, test and save cadences; the loop's failure
paths."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from fixtures import make_msvd_fixture, tiny_train_config
from recnet_tpu import checkpoint as j_ckpt
from recnet_tpu.data import Corpus as JaxCorpus
from recnet_tpu.training import loop as j_loop
from recnet_tpu.training import step as j_step
from recnet_tpu_torch import checkpoint as t_ckpt
from recnet_tpu_torch.cli import train as t_cli
from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.training import loop as t_loop
from recnet_tpu_torch.training import step as t_step

from torch_train_fixtures import NO_DROPOUT, assert_trees_close

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("msvd")
    make_msvd_fixture(str(root), feat_dim=32)
    return str(root)


def _scalars(log_dir):
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "value" in rec:
                out[(rec["tag"], rec["step"])] = rec["value"]
    return out


@pytest.mark.parametrize("k,cache", [(1, False), (2, True)],
                         ids=["k1", "k2-bf16-cache"])
def test_loop_resumes_like_jax(fixture_root, tmp_path, k, cache):
    """JAX saves its state at step 0; both loops resume from it for four
    iterations (dropout 0, teacher forcing 1.0) with a val pass halfway and
    at the end: the logged train and val losses and the final state
    agree."""
    jtc = tiny_train_config(
        fixture_root, use_recon=True, reconstructor_type="global",
        n_iterations=4, log_every=2, validate_every=2, test_every=4,
        save_every=4, steps_per_dispatch=k, device_feature_cache=cache,
        feature_cache_dtype="bfloat16" if cache else "float32", **NO_DROPOUT)
    ttc = TrainConfig.from_json(jtc.to_json())
    vocab = JaxCorpus(jtc).vocab
    jstate, _, _ = j_step.init_train_state(jax.random.PRNGKey(5), jtc,
                                           vocab.n_vocabs)
    step0 = j_ckpt.save_checkpoint(str(tmp_path / "start"), 0, jstate, jtc,
                                   vocab)
    j_final = j_loop.train(jtc, loss_only=True, resume_from=step0,
                           log_dir=str(tmp_path / "jlog"),
                           save_dir=str(tmp_path / "jck"))
    t_final = t_loop.train(ttc, loss_only=True, resume_from=step0,
                           log_dir=str(tmp_path / "tlog"),
                           save_dir=str(tmp_path / "tck"), device="cpu")
    assert t_final.step == int(j_final.step) == 4
    assert math.isfinite(t_loop.LAST_SETUP_SECONDS)
    want, got = _scalars(tmp_path / "jlog"), _scalars(tmp_path / "tlog")
    assert set(got) == set(want)
    assert {tag for tag, _ in got} >= {ttc.tx_train_loss, ttc.tx_val_loss}
    for key in want:
        if key[0] != "perf/steps_per_sec":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=str(key))
    assert_trees_close(t_ckpt.state_leaves(t_final),
                       jax.tree_util.tree_leaves(j_final), rtol=1e-4,
                       atol=1e-6, what="final")
    # the port's step-4 checkpoint is the final state
    saved, meta = t_ckpt.load_checkpoint(str(tmp_path / "tck" / "4"), ttc,
                                         vocab.n_vocabs, "cpu")
    assert meta["step"] == 4
    for a, b in zip(t_ckpt.state_leaves(saved),
                    t_ckpt.state_leaves(t_final)):
        np.testing.assert_array_equal(a, b)


def test_cli_runs_val_test_and_save_cadences(fixture_root, tmp_path):
    tc = tiny_train_config(fixture_root, use_recon=True,
                           reconstructor_type="local", n_iterations=6,
                           log_every=2, validate_every=2, test_every=6,
                           save_every=2)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(tc.to_json())
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "recnet_tpu_torch.cli.train", "--config",
         str(cfg), "--device", "cpu", "--keep_last_k", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = proc.stdout
    assert out.count("[Validation]") == 3
    assert "[Test] Iter 6" in out and "beam-5:" in out
    ttc = TrainConfig.from_json(tc.to_json())
    save = tmp_path / ttc.save_dpath
    assert sorted(p.name for p in save.iterdir()) == ["4", "6"]   # pruned
    assert (tmp_path / "predictions.txt").is_file()
    tags = {tag for tag, _ in _scalars(tmp_path / ttc.log_dpath)}
    assert ttc.tx_score("greedy", "CIDEr") in tags
    assert ttc.tx_val_loss_reconstructor in tags


def test_cli_defaults_to_the_card(fixture_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    tc = tiny_train_config(fixture_root)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(tc.to_json())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(["--config", str(cfg)])
    # one process holds one device: a mesh over more needs a process group
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        t_cli.main(["--config", str(cfg), "--device", "cpu",
                    "--mesh_shape", "data=2"])


@pytest.mark.parametrize("flags,error", [
    (["--ckpt_backend", "npz"], None),
    (["--ckpt_backend", "orbax"], "the port reads npz checkpoints only"),
    (["--async_ckpt"], "--async_ckpt requires --ckpt_backend orbax"),
    (["--ckpt_backend", "orbax", "--async_ckpt"],
     "the port reads npz checkpoints only")],
    ids=["npz", "orbax", "async", "orbax-async"])
def test_cli_checkpoint_backend_flags(fixture_root, tmp_path, monkeypatch,
                                      capsys, flags, error):
    """The JAX CLI's checkpoint flags: npz trains, orbax is refused with
    the checkpoint reader's reason, and --async_ckpt as the JAX CLI
    refuses it without orbax, before anything is trained."""
    from recnet_tpu_torch.checkpoint import NPZ_ONLY
    cfg = tmp_path / "tiny.json"
    cfg.write_text(tiny_train_config(fixture_root).to_json())
    calls = []
    monkeypatch.setattr(t_cli, "train", lambda tc, **kw: calls.append(kw))
    argv = ["--config", str(cfg), "--device", "cpu"] + flags
    if error is None:
        t_cli.main(argv)
        assert len(calls) == 1 and calls[0]["device"] == "cpu"
        return
    with pytest.raises(SystemExit) as exc:
        t_cli.main(argv)
    assert exc.value.code == 2 and not calls
    assert error in capsys.readouterr().err
    assert "npz checkpoints only" in NPZ_ONLY


def test_non_finite_loss_saves_an_emergency_checkpoint(fixture_root,
                                                       tmp_path):
    jtc = tiny_train_config(fixture_root, n_iterations=4, log_every=2,
                            validate_every=100, test_every=100,
                            save_every=100)
    ttc = TrainConfig.from_json(jtc.to_json())
    vocab = JaxCorpus(jtc).vocab
    state, _, _ = t_step.init_train_state(0, ttc, vocab.n_vocabs, "cpu")
    with torch.no_grad():
        state.dec_params["out_b"][:] = float("nan")
    start = t_ckpt.save_checkpoint(str(tmp_path / "start"), 0, state, ttc,
                                   vocab)
    with pytest.raises(FloatingPointError, match="emergency checkpoint"):
        t_loop.train(ttc, loss_only=True, resume_from=start,
                     log_dir=str(tmp_path / "log"),
                     save_dir=str(tmp_path / "ck"), device="cpu")
    meta = json.loads((tmp_path / "ck" / "2" / "meta.json").read_text())
    assert meta["emergency"] is True
