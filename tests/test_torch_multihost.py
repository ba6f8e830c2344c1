"""The port over several processes: real gloo groups on the CPU, the mirror
of tests/test_multihost.py (and of the multi-device half of
tests/test_parallel.py).

Each group runs tests/torch_multihost_worker.py (torch and the port only)
in 2 or 4 fresh interpreters, one scenario after another; this process
makes the inputs from numpy seeds, runs the JAX package and the
single-process port on them, and compares:

* the train step at data=2, model=2 and data=2 x model=2 against the JAX
  single-device step and the JAX GSPMD mesh step on the same weights
  (``weights.train_state_from_jax``): loss rtol 1e-5, every leaf after two
  steps rtol 1e-4 / atol 1e-6 (the bounds of tests/test_parallel.py);
  with dropout on, against the single-process port (the masks are the
  same draws);
* the global normalisation of the decoder loss when the ranks hold
  different token counts, against a hand computation;
* ``parallel.vocab``'s lookup, NLL and argmax against the unsharded ones,
  with gradients;
* ``training.loop.train`` over 2 processes against the single-process
  loop (raw corpus, device feature cache, a bundle built by the primary
  alone, a 'model' axis with its checkpoint and a resume from it), with
  the side effects on rank 0 only.

tests/test_multihost.py's ``test_two_process_cooperative_orbax_checkpoint``
has no mirror: the port reads and writes npz checkpoints only and raises on
orbax.
"""

import json
import os
import re
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import make_msvd_fixture, tiny_train_config
from recnet_tpu import checkpoint as j_ckpt
from recnet_tpu.data import Corpus as JaxCorpus
from recnet_tpu.ops import losses as j_losses
from recnet_tpu.parallel import mesh as j_mesh
from recnet_tpu.training import step as j_step
from recnet_tpu_torch import checkpoint as t_ckpt
from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.data.vocab import Vocab
from recnet_tpu_torch.training import loop as t_loop
from recnet_tpu_torch.training import step as t_step
from recnet_tpu_torch.weights import train_state_from_jax

from test_parallel import _batch, _tiny_tc
from torch_train_fixtures import NO_DROPOUT

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_multihost_worker.py"
LOSS_RTOL = 1e-5
LEAF_RTOL, LEAF_ATOL = 1e-4, 1e-6
MESHES = ["data=2", "model=2", "data=2,model=2"]
V = 32          # tests/test_parallel.py's vocabulary, which JAX can shard


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_group(world: int, scenarios, tmp: Path, tag: str):
    """Run ``scenarios`` in one gloo group of ``world`` worker processes;
    returns each rank's (stdout, stderr). A failed rendezvous (the port
    taken between picking and binding it) is retried once."""
    job = tmp / f"{tag}_job.json"
    job.write_text(json.dumps({"scenarios": scenarios}))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE.parent) + os.pathsep + env.get(
        "PYTHONPATH", "")
    for attempt in range(2):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), str(port),
             str(job)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
        results = [p.communicate(timeout=600) for p in procs]
        if all(p.returncode == 0 for p in procs):
            return results
        diag = "\n".join(f"--- rank {r} rc={p.returncode}\n{out[-2000:]}\n"
                         f"{err[-4000:]}" for r, (p, (out, err))
                         in enumerate(zip(procs, results)))
        assert attempt == 0, f"{world}-process group failed:\n{diag}"
        print(f"retrying the {world}-process group:\n{diag}")


def _leaves(npz):
    return [npz[f"leaf_{i}"] for i in range(sum(
        f.startswith("leaf_") for f in npz.files))]


def _assert_leaves(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=LEAF_RTOL,
                                   atol=LEAF_ATOL, err_msg=f"{what} leaf {i}")


# --------------------------------------------------------------------------
# The train step against JAX: 2 ranks (data=2, model=2), 4 ranks (both)
# --------------------------------------------------------------------------

def _vocab(n=V):
    return Vocab({"<PAD>": 0, "<SOS>": 1, "<EOS>": 2}, min_count=1).build(
        [" ".join(f"w{i}" for i in range(n - 3))], str.split)


@pytest.fixture(scope="module")
def step_inputs(tmp_path_factory):
    """tests/test_parallel.py's config and batches: the JAX initial state
    as an npz checkpoint (dropout off with the global and the local
    reconstructor, and the JAX test's own dropout on), two global batches,
    and the JAX results, single-device and on each mesh of the 8 CPU
    devices."""
    tmp = tmp_path_factory.mktemp("steps")
    rng = np.random.default_rng(0)
    jtc = _tiny_tc()
    # every caption length is drawn, so the ranks' token counts differ
    batches = [_batch(rng, jtc, V) for _ in range(2)]
    np.savez(tmp / "batches.npz", videos=np.stack([b[0] for b in batches]),
             captions=np.stack([b[1] for b in batches]))
    out = {"tmp": tmp, "jax": {}, "configs": {}}
    for recon, drop in (("global", False), ("local", False),
                        ("global", True)):
        name = f"{recon}{'-dropout' if drop else ''}"
        jtc = _tiny_tc(reconstructor_type=recon,
                       **({} if drop else NO_DROPOUT))
        ttc = TrainConfig.from_json(jtc.to_json())
        jstate, dcfg, rcfg = j_step.init_train_state(
            jax.random.PRNGKey(0), jtc, V)
        t_ckpt.save_checkpoint(str(tmp / name), 0, train_state_from_jax(
            jstate, ttc, "cpu"), ttc, _vocab())
        (tmp / f"{name}.json").write_text(ttc.to_json())
        out["configs"][name] = ttc
        if drop:
            continue          # JAX's dropout draws cannot be reproduced
        fn = j_step.build_train_step(jtc, dcfg, rcfg)
        for mesh in [None] + MESHES:
            # the JAX step donates its state: a fresh copy for each run
            state = jax.tree_util.tree_map(jnp.copy, jstate)
            videos = [jnp.asarray(b[0]) for b in batches]
            captions = [jnp.asarray(b[1]) for b in batches]
            if mesh is not None:
                # JAX's batch sharding names 'data': model=2 is 1 x 2
                shape = dict((kv.split("=")[0], int(kv.split("=")[1]))
                             for kv in mesh.split(","))
                m = j_mesh.make_mesh((("data", shape.get("data", 1)),
                                      ("model", shape.get("model", 1))))
                state = j_mesh.shard_state(state, m)
                videos = [jax.device_put(v, j_mesh.batch_sharding(m, 0))
                          for v in videos]
                captions = [jax.device_put(c, j_mesh.batch_sharding(m, 1))
                            for c in captions]
            losses = []
            for v, c in zip(videos, captions):
                state, metrics = fn(state, v, c, jax.random.PRNGKey(5))
                losses.append(float(metrics["loss"]))
            out["jax"][(name, mesh)] = (
                losses, [np.asarray(x)
                         for x in jax.tree_util.tree_leaves(state)])
    return out


def _step_scenario(inputs, name, mesh):
    tmp = inputs["tmp"]
    return {"kind": "steps", "name": f"{name} {mesh}", "mesh": mesh,
            "config": str(tmp / f"{name}.json"),
            "ckpt": str(tmp / name / "0"),
            "batches": str(tmp / "batches.npz"), "vocab_size": V,
            "out": str(tmp / f"port {name} {mesh}.npz")}


def _ce_inputs(tmp):
    """Logits (T, B, V) and targets whose mask gives the two halves of the
    batch different token counts at every step."""
    rng = np.random.default_rng(3)
    T, B, V = 6, 4, 9
    mask = np.zeros((T, B), bool)
    for b, n in enumerate((6, 5, 2, 1)):       # rows 0-1 long, 2-3 short
        mask[:n, b] = True
    np.savez(tmp / "ce.npz",
             logits=rng.standard_normal((T, B, V)).astype(np.float32),
             targets=rng.integers(0, V, (T, B)).astype(np.int32), mask=mask)


def _vocab_inputs(tmp):
    rng = np.random.default_rng(4)
    V, E, N = 11, 5, 16          # 11 rows: shards of 6 and 5
    logits = rng.standard_normal((N, V)).astype(np.float32)
    logits[3, [2, 8]] = logits[3].max() + 1.0    # a tie across the shards
    np.savez(tmp / "vocab.npz",
             table=rng.standard_normal((V, E)).astype(np.float32),
             tokens=rng.integers(0, V, N).astype(np.int64), logits=logits,
             targets=rng.integers(0, V, N).astype(np.int64),
             emb_weight=rng.standard_normal((N, E)).astype(np.float32),
             nll_weight=rng.standard_normal(N).astype(np.float32))


@pytest.fixture(scope="module")
def two_ranks(step_inputs):
    """One 2-process group: the steps at data=2 and model=2, with and
    without dropout, both reconstructors; the CE; the vocab pieces."""
    tmp = step_inputs["tmp"]
    _ce_inputs(tmp)
    _vocab_inputs(tmp)
    scenarios = [_step_scenario(step_inputs, name, mesh)
                 for name in ("global", "local", "global-dropout")
                 for mesh in ("data=2", "model=2")]
    scenarios += [
        {"kind": "ce", "name": "ce", "mesh": "data=2",
         "inputs": str(tmp / "ce.npz"), "out": str(tmp / "ce{rank}.npz")},
        {"kind": "vocab", "name": "vocab", "mesh": "model=2",
         "inputs": str(tmp / "vocab.npz"),
         "out": str(tmp / "vocab{rank}.npz")}]
    run_group(2, scenarios, tmp, "two")
    return step_inputs


@pytest.fixture(scope="module")
def four_ranks(step_inputs):
    tmp = step_inputs["tmp"]
    run_group(4, [_step_scenario(step_inputs, name, "data=2,model=2")
                  for name in ("global", "global-dropout")], tmp, "four")
    return step_inputs


def _port_result(inputs, name, mesh):
    with np.load(inputs["tmp"] / f"port {name} {mesh}.npz") as d:
        return d["metrics"], _leaves(d)


@pytest.mark.parametrize("name,mesh", [
    ("global", "data=2"), ("global", "model=2"), ("local", "data=2"),
    ("local", "model=2"), ("global", "data=2,model=2")])
def test_sharded_step_matches_jax(two_ranks, four_ranks, name, mesh):
    """Two steps on the mesh equal JAX's single-device steps and JAX's
    GSPMD steps on the same mesh shape: losses and every leaf."""
    metrics, leaves = _port_result(two_ranks, name, mesh)
    for ref in (None, mesh):
        losses, want = two_ranks["jax"][(name, ref)]
        np.testing.assert_allclose(metrics[:, 0], losses, rtol=LOSS_RTOL)
        _assert_leaves(leaves, want, f"{name} {mesh} against JAX {ref}")


def _port_single(inputs, name):
    """Two steps of the single-process port from the same checkpoint."""
    ttc = inputs["configs"][name]
    state, _ = t_ckpt.load_checkpoint(str(inputs["tmp"] / name / "0"), ttc,
                                      V, "cpu")
    from recnet_tpu_torch.models import decoder as dec_mod
    from recnet_tpu_torch.models import reconstructors as rec_mod
    fn = t_step.build_train_step(ttc, dec_mod.config_from_train(ttc, V),
                                 rec_mod.config_from_train(ttc))
    with np.load(inputs["tmp"] / "batches.npz") as d:
        metrics = [fn(state, torch.from_numpy(v), torch.from_numpy(c))
                   for v, c in zip(d["videos"], d["captions"])]
    return ([float(m["loss"]) for m in metrics],
            t_ckpt.state_leaves(state))


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_step_with_dropout_matches_one_process(two_ranks,
                                                       four_ranks, mesh):
    """Dropout on: each rank cuts its rows (and vocabulary columns) out of
    the global masks drawn from the step's shared generator, so the
    sharded steps equal the single-process port's."""
    losses, want = _port_single(two_ranks, "global-dropout")
    metrics, leaves = _port_result(two_ranks, "global-dropout", mesh)
    np.testing.assert_allclose(metrics[:, 0], losses, rtol=LOSS_RTOL)
    _assert_leaves(leaves, want, f"dropout {mesh}")


def test_global_normalisation_with_uneven_tokens(two_ranks):
    """The decoder loss sum_t (masked sum_t / count_t) / n_tokens with the
    counts of the WHOLE batch: the ranks' shares sum to the hand-computed
    loss and their gradients are the slices of the whole batch's, which
    averaging per-rank means (DDP's rule) does not give here."""
    tmp = two_ranks["tmp"]
    with np.load(tmp / "ce.npz") as d:
        logits, targets, mask = d["logits"], d["targets"], d["mask"]
    shifted = logits - logits.max(-1, keepdims=True)
    nll = (np.log(np.exp(shifted).sum(-1))
           - np.take_along_axis(shifted, targets[..., None], -1)[..., 0])
    per_step = (nll * mask).sum(1) / np.maximum(mask.sum(1), 1)
    want = per_step.sum() / mask.sum()
    jax_loss, _ = j_losses.step_mean_ce(jnp.asarray(logits),
                                        jnp.asarray(targets),
                                        jnp.asarray(mask))
    np.testing.assert_allclose(want, float(jax_loss), rtol=1e-6)
    ranks = [np.load(tmp / f"ce{r}.npz") for r in range(2)]
    for r in ranks:
        np.testing.assert_allclose(float(r["total"]), want, rtol=1e-6)
        assert float(r["n_tokens"]) == mask.sum()
    np.testing.assert_allclose(sum(float(r["share"]) for r in ranks), want,
                               rtol=1e-6)
    full = torch.tensor(logits, requires_grad=True)
    from recnet_tpu_torch.ops.losses import step_mean_ce
    step_mean_ce(full, torch.from_numpy(targets),
                 torch.from_numpy(mask))[0].backward()
    np.testing.assert_allclose(
        np.concatenate([r["grad"] for r in ranks], axis=1),
        full.grad.numpy(), rtol=1e-5, atol=1e-7)
    # each half's own mean, averaged: another number
    halves = [np.s_[:, :2], np.s_[:, 2:]]
    ddp = np.mean([((nll[h] * mask[h]).sum(1)
                    / np.maximum(mask[h].sum(1), 1)).sum() / mask[h].sum()
                   for h in halves])
    assert abs(ddp - want) > 1e-2


def test_vocab_parallel_pieces(two_ranks):
    """The lookup, the NLL and the argmax over a vocabulary split 6 + 5,
    against the unsharded ones, with the gradients of a loss on both."""
    tmp = two_ranks["tmp"]
    d = np.load(tmp / "vocab.npz")
    table = torch.tensor(d["table"], requires_grad=True)
    logits = torch.tensor(d["logits"], requires_grad=True)
    emb = table[torch.from_numpy(d["tokens"])]
    nll = (torch.logsumexp(logits, -1) - logits.gather(
        -1, torch.from_numpy(d["targets"])[:, None])[:, 0])
    ((emb * torch.from_numpy(d["emb_weight"])).sum()
     + (nll * torch.from_numpy(d["nll_weight"])).sum()).backward()
    ranks = [np.load(tmp / f"vocab{r}.npz") for r in range(2)]
    assert [tuple(r["cols"]) for r in ranks] == [(0, 6), (6, 11)]
    for r in ranks:
        np.testing.assert_array_equal(r["emb"], emb.detach().numpy())
        np.testing.assert_allclose(r["nll"], nll.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(r["argmax"],
                                      torch.argmax(logits, -1).numpy())
    assert ranks[0]["argmax"][3] == 2          # the tie goes to column 2
    np.testing.assert_allclose(
        np.concatenate([r["table_grad"] for r in ranks]),
        table.grad.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        np.concatenate([r["logits_grad"] for r in ranks], axis=1),
        logits.grad.numpy(), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# The loop over 2 processes against the single-process loop
# --------------------------------------------------------------------------

LOOP_ITERS = 4


def _loop_config(root, **kw):
    jtc = tiny_train_config(root, batch_size=4, n_iterations=LOOP_ITERS,
                            log_every=2, validate_every=4, test_every=4,
                            save_every=4, **kw)
    return TrainConfig.from_json(jtc.to_json())


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """One 2-process group running the loop five ways, and the
    single-process loop on the same corpora."""
    tmp = tmp_path_factory.mktemp("loops")
    root = tmp / "fixture"
    make_msvd_fixture(str(root), n_videos=12, feat_dim=32)
    pod_root = tmp / "fixture_pod"            # no bundle built there yet
    shutil.copytree(root, pod_root)
    n_vocab = JaxCorpus(tiny_train_config(str(root))).vocab.n_vocabs
    cases = {
        "raw": _loop_config(str(root)),
        "cache": _loop_config(str(root), device_feature_cache=True),
        "bundle": _loop_config(str(pod_root), data_bundle=True,
                               data_bundle_root=str(pod_root / "bundles")),
        "tp": _loop_config(str(root)),
    }
    meshes = {"raw": "data=2", "cache": "data=2", "bundle": "data=2",
              "tp": "model=2"}
    scenarios = []
    for name, tc in cases.items():
        (tmp / f"{name}.json").write_text(tc.to_json())
        scenarios.append({"kind": "loop", "name": name, "mesh": meshes[name],
                          "config": str(tmp / f"{name}.json"),
                          "vocab_size": n_vocab,
                          "out": str(tmp / name / "rank{rank}")})
    tp_ckpt = tmp / "tp" / "rank0" / "ckpt" / str(LOOP_ITERS)
    resume = cases["tp"].replace(n_iterations=LOOP_ITERS + 2, save_every=100)
    (tmp / "resume.json").write_text(resume.to_json())
    scenarios.append({"kind": "loop", "name": "resume", "mesh": "model=2",
                      "config": str(tmp / "resume.json"),
                      "resume": str(tp_ckpt), "vocab_size": n_vocab,
                      "out": str(tmp / "resume" / "rank{rank}")})
    outs = run_group(2, scenarios, tmp, "loop")
    digests = {}
    for rank, (out, _) in enumerate(outs):
        found = re.findall(r"DIGEST \d+ ([0-9.]+)", out)
        assert len(found) == len(scenarios), out[-3000:]
        for sc, d in zip(scenarios, found):
            digests[(sc["name"], rank)] = float(d)
    # the single-process loop on the raw corpus and with the cache
    single = {}
    cwd = os.getcwd()
    for name, tc, resume_from in (("raw", cases["raw"], None),
                                  ("cache", cases["cache"], None),
                                  ("resume", resume, str(tp_ckpt))):
        out = tmp / "single" / name
        out.mkdir(parents=True)
        os.chdir(out)
        try:
            state = t_loop.train(tc, log_dir=str(out / "logs"),
                                 save_dir=str(out / "ckpt"),
                                 resume_from=resume_from, device="cpu")
        finally:
            os.chdir(cwd)
        single[name] = t_ckpt.state_leaves(state)
    return dict(tmp=tmp, outs=outs, digests=digests, single=single,
                cases=cases, n_vocab=n_vocab, tp_ckpt=tp_ckpt,
                pod_root=pod_root)


def _final(loops, name, rank=0):
    with np.load(loops["tmp"] / name / f"rank{rank}" / "final.npz") as d:
        return _leaves(d)


@pytest.mark.parametrize("name", ["raw", "cache"])
def test_two_process_loop_matches_single_process(loops, name):
    """Both ranks end with the same state, that of the single-process
    loop (the device feature cache: the whole cache on every rank, the
    rank's row indices); rank 0 alone logs, saves and writes
    predictions.txt, and rank 1 prints no loss."""
    d0, d1 = (loops["digests"][(name, r)] for r in (0, 1))
    assert d0 == d1
    single = loops["single"][name]
    assert d0 == pytest.approx(sum(float(np.abs(x).sum(dtype=np.float64))
                                   for x in single), rel=1e-6)
    _assert_leaves(_final(loops, name), single, name)
    r0, r1 = (loops["tmp"] / name / f"rank{r}" for r in (0, 1))
    assert os.listdir(r0 / "ckpt") == [str(LOOP_ITERS)]
    assert not (r1 / "ckpt").exists()
    assert (r0 / "predictions.txt").exists()
    assert not (r1 / "predictions.txt").exists()
    assert (r0 / "logs" / "metrics.jsonl").exists()
    assert not (r1 / "logs").exists()
    assert "Iter" in loops["outs"][0][0]
    assert "Iter" not in loops["outs"][1][0]


def test_two_process_bundle_build_is_primary_only(loops):
    """data_bundle with a shared root: one bundle on disk, built by the
    primary while the other rank waits for it, and training from it as
    from the raw corpus."""
    assert len(os.listdir(loops["pod_root"] / "bundles")) == 1
    assert "building" in loops["outs"][0][1]
    assert "building" not in loops["outs"][1][1]
    assert loops["digests"][("bundle", 0)] == loops["digests"][("bundle", 1)]
    _assert_leaves(_final(loops, "bundle"), loops["single"]["raw"], "bundle")


def test_tp_loop_checkpoint_loads_everywhere_and_resumes(loops):
    """A 'model'-axis run saves the JAX npz layout with its shards
    gathered: the single-process port and the JAX package load it (equal
    to the ranks' gathered state), and a resume from it on the mesh
    equals the single-process resume."""
    tmp, step_dir = loops["tmp"], str(loops["tp_ckpt"])
    assert loops["digests"][("tp", 0)] == loops["digests"][("tp", 1)]
    _assert_leaves(_final(loops, "tp"), loops["single"]["raw"], "tp loop")
    tc = loops["cases"]["tp"]
    state, meta = t_ckpt.load_checkpoint(step_dir, tc, loops["n_vocab"],
                                         "cpu")
    assert meta["step"] == LOOP_ITERS
    for a, b in zip(t_ckpt.state_leaves(state), _final(loops, "tp")):
        np.testing.assert_array_equal(a, b)
    jtc, jvocab = j_ckpt.load_config_and_vocab(step_dir)
    example, _, _ = j_step.init_train_state(jax.random.PRNGKey(0), jtc,
                                            jvocab.n_vocabs)
    jstate, _ = j_ckpt.load_checkpoint(step_dir, example)
    for a, b in zip(t_ckpt.state_leaves(state),
                    jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert not (tmp / "tp" / "rank1" / "ckpt").exists()
    assert (loops["digests"][("resume", 0)]
            == loops["digests"][("resume", 1)])
    _assert_leaves(_final(loops, "resume"), loops["single"]["resume"],
                   "resume")


# --------------------------------------------------------------------------
# The mesh Captioner: one process, a 'data' mesh of local devices
# --------------------------------------------------------------------------

def _captioners(data, batch_size=8, **kw):
    """A plain Captioner and one over a mesh of ``data`` CPU entries, on
    the same params, whose <EOS> logit is raised so that the captions end
    at different steps."""
    from fixtures import WORDS
    from recnet_tpu.data.vocab import Vocab as JaxVocab
    from recnet_tpu_torch.models.decoder import config_from_train
    from recnet_tpu_torch.parallel.mesh import make_mesh
    from recnet_tpu_torch.serving import Captioner
    from recnet_tpu_torch.weights import random_params
    tc = tiny_train_config("unused")
    vocab = JaxVocab(tc.init_word2idx_dict).build([" ".join(WORDS)],
                                                  str.split)
    params = random_params(config_from_train(tc, vocab.n_vocabs), seed=3)
    params["out_b"][2] += 0.1
    make = lambda mesh: Captioner(tc, vocab, params, dtype="float32",
                                  device="cpu", batch_size=batch_size,
                                  mesh=mesh, **kw)
    return make(None), make(make_mesh((("data", data),), ["cpu"] * data))


def _features(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(6, 12)), 32)).astype(
        np.float32) for _ in range(n)]


@pytest.mark.parametrize("kw,beam", [
    ({}, None), ({"use_pallas": True}, None),
    ({"use_pallas": True, "greedy_segment": 4}, None),
    ({}, 5), ({"use_pallas": True}, 5)],
    ids=["greedy", "K1", "K2-segments", "beam5", "beam5-K3"])
def test_mesh_captioner_matches_the_plain_one(kw, beam):
    """Each chunk split over two device entries, the shards meeting at
    every batch-wide stop: the captions equal the plain Captioner's
    (13 videos: a full chunk of 8 and a bucket of 8 for the last 5)."""
    plain, meshed = _captioners(2, **kw)
    assert len(meshed.param_sets) == 2
    assert meshed.param_sets[0] is not plain.params
    feats = _features(13)
    want = plain.caption(feats, beam_width=beam)
    assert meshed.caption(feats, beam_width=beam) == want
    assert len(set(want)) > 1


def test_mesh_captioner_buckets_round_to_the_data_axis():
    """A 'data' axis of 3: buckets are rounded up to a multiple of 3 and
    capped at batch_size, so every chunk splits evenly."""
    plain, meshed = _captioners(3, batch_size=12, use_pallas=True,
                                greedy_segment=4)
    assert [meshed._bucket_size(n) for n in (1, 5, 8, 9, 11, 12)] == \
        [9, 9, 9, 12, 12, 12]
    assert [plain._bucket_size(n) for n in (1, 5, 9)] == [8, 8, 12]
    feats = _features(5, seed=1)
    assert meshed.caption(feats) == plain.caption(feats)
    assert meshed.caption(feats, beam_width=5) == plain.caption(
        feats, beam_width=5)


def test_shard_join_reduces_across_threads():
    """Each shard's thread hands in its value and gets the reduction over
    all shards; a failed shard releases the others."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from recnet_tpu_torch.serving import _ShardJoin
    join = _ShardJoin(3)
    values = [torch.tensor([True, False]), torch.tensor([True, True]),
              torch.tensor([True, False])]
    with ThreadPoolExecutor(3) as pool:
        got = list(pool.map(lambda i: (
            join.across(i)(values[i], torch.all),
            join.across(i)(torch.tensor(i), torch.amax)), range(3)))
    for all_, top in got:
        assert all_.tolist() == [True, False] and int(top) == 2
    broken = _ShardJoin(2)
    broken.abort()
    with pytest.raises(threading.BrokenBarrierError):
        broken.across(0)(torch.tensor(True), torch.all)


def test_cli_trains_one_model_under_torchrun_variables(loops, tmp_path):
    """``cli.train --mesh`` in two processes given only torchrun's
    environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
    one model, as the single-process loop trains it; rank 0 alone saves
    and writes predictions.txt."""
    tc = loops["cases"]["raw"]
    cfg = tmp_path / "tiny.json"
    cfg.write_text(tc.to_json())
    port = _free_port()
    procs = []
    for rank in range(2):
        cwd = tmp_path / f"rank{rank}"
        cwd.mkdir()
        env = dict(os.environ, PYTHONPATH=str(HERE.parent), WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "recnet_tpu_torch.cli.train", "--config",
             str(cfg), "--device", "cpu", "--mesh"], cwd=cwd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out[-2000:] + err[-3000:]
    assert "mesh {'data': 2} over the ranks" in outs[0][0]
    assert outs[1][0] == ""
    step_dir = tmp_path / "rank0" / tc.save_dpath / str(LOOP_ITERS)
    state, _ = t_ckpt.load_checkpoint(str(step_dir), tc, loops["n_vocab"],
                                      "cpu")
    _assert_leaves(t_ckpt.state_leaves(state), loops["single"]["raw"], "cli")
    assert (tmp_path / "rank0" / "predictions.txt").exists()
    assert os.listdir(tmp_path / "rank1") == []
