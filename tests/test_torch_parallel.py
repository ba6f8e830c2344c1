"""The port's mesh and bootstrap (recnet_tpu_torch.parallel) in one
process, the mirror of tests/test_parallel.py: ``make_mesh``'s defaults
and errors, the sharding rules path for path and leaf for leaf against
the JAX package's on the same state (data 2 x model 4 on the 8 virtual
CPU devices), a batch actually split, the vocabulary shards, and
``initialize``'s rules on which signals engage a process group.
tests/test_torch_multihost.py runs the steps and the loop over real
process groups."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding

from recnet_tpu.parallel import mesh as j_mesh
from recnet_tpu.training import step as j_step
from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.data.batcher import prefetch_to_device
from recnet_tpu_torch.parallel import distributed as dist
from recnet_tpu_torch.parallel import mesh as t_mesh
from recnet_tpu_torch.utils.misc import tree_leaves
from recnet_tpu_torch.weights import train_state_from_jax

from test_parallel import _batch, _tiny_tc

V = 32


def test_make_mesh_defaults_and_errors():
    devices = ["cpu"] * 4
    for shape in (None, (("data", 1),)):
        mesh = t_mesh.make_mesh(shape, devices)
        assert mesh.axis_names == ("data",) and mesh.shape == {"data": 4}
        assert not mesh.distributed and mesh.device == torch.device("cpu")
    mesh = t_mesh.make_mesh((("data", 2), ("model", 2)), devices)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.size("model") == 2 and mesh.coordinate("data") == 0
    assert mesh.group("data") is None       # no process group
    assert t_mesh.make_mesh((("data", 3),), devices).devices.shape == (3,)
    with pytest.raises(ValueError, match="mesh needs 8 devices, have 4"):
        t_mesh.make_mesh((("data", 4), ("model", 2)), devices)
    # the JAX package's rules on the same shapes
    j_devices = jax.devices()[:4]
    assert dict(j_mesh.make_mesh(None, j_devices).shape) == {"data": 4}
    with pytest.raises(ValueError, match="mesh needs 8 devices, have 4"):
        j_mesh.make_mesh((("data", 4), ("model", 2)), j_devices)


def test_make_mesh_without_devices_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        t_mesh.make_mesh()


@pytest.mark.parametrize("use_tp", [True, False])
def test_spec_for_path_matches_jax_string_for_string(use_tp):
    """Every leaf path of a JAX TrainState, and a few of the
    reconstructor's, get the same spec from both rule functions."""
    tc = _tiny_tc(use_recon=True, reconstructor_type="local")
    state, _, _ = j_step.init_train_state(jax.random.PRNGKey(0), tc, V)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(state)[0]]
    assert any("embedding" in p for p in paths)
    for path in paths + [".rec_params['out_w']", ".dec_opt[0].mu['out_b']"]:
        assert t_mesh._spec_for_path(path, use_tp) == tuple(
            j_mesh._spec_for_path(path, use_tp)), path


def _states(recon, amsgrad, wd):
    jtc = _tiny_tc(use_recon=recon is not None,
                   reconstructor_type=recon or "global",
                   decoder_use_amsgrad=amsgrad, decoder_weight_decay=wd,
                   mesh_shape=(("data", 2), ("model", 4)))
    ttc = TrainConfig.from_json(jtc.to_json())
    jstate, _, _ = j_step.init_train_state(jax.random.PRNGKey(0), jtc, V)
    return jtc, jstate, train_state_from_jax(jstate, ttc, "cpu")


@pytest.mark.parametrize("recon,amsgrad,wd", [
    ("global", True, 1e-5), ("local", False, 0.0), (None, False, 1e-5)])
def test_state_shardings_match_jax_leaf_for_leaf(recon, amsgrad, wd):
    """data 2 x model 4: the port's spec of every TrainState leaf, in the
    JAX flatten order, equals the JAX package's on the same state; the
    params' paths are the same strings."""
    jtc, jstate, tstate = _states(recon, amsgrad, wd)
    jmesh = j_mesh.make_mesh(jtc.mesh_shape)
    want = jax.tree_util.tree_flatten_with_path(
        j_mesh.state_shardings(jstate, jmesh),
        is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    mesh = t_mesh.make_mesh(jtc.mesh_shape, ["cpu"] * 8)
    got = t_mesh.state_shardings(tstate, mesh)
    assert len(got) == len(want)
    for (path, spec), (jpath, jsharding) in zip(got, want):
        assert spec == tuple(jsharding.spec), (path, jpath)
        if "_params" in path or path == ".step":
            assert path == jax.tree_util.keystr(jpath)
    assert ("model", None) in [s for _, s in got]
    # a mesh without a 'model' axis replicates everything
    flat = t_mesh.make_mesh((("data", 8),), ["cpu"] * 8)
    assert {s for _, s in t_mesh.state_shardings(tstate, flat)} == {()}


def test_shard_state_keeps_the_rank_shards():
    """The vocabulary leaves and their Adam moments are cut as
    torch.tensor_split cuts them (a V that does not divide included),
    everything else kept."""
    _, jstate, tstate = _states("global", True, 1e-5)
    mesh = t_mesh.make_mesh((("data", 2), ("model", 3)), ["cpu"] * 6)
    sharded = t_mesh.shard_state(tstate, mesh)
    lo, hi = t_mesh.vocab_range(V, 3, 0)
    assert (lo, hi) == (0, 11)
    assert [t.shape[0] for t in torch.tensor_split(torch.arange(V), 3)] \
        == [11, 11, 10]
    emb = jstate.dec_params["embedding"]
    np.testing.assert_array_equal(
        sharded.dec_params["embedding"].detach().numpy(), emb[lo:hi])
    np.testing.assert_array_equal(
        sharded.dec_params["out_w"].detach().numpy(),
        jstate.dec_params["out_w"][:, lo:hi])
    state = sharded.dec_opt.state[sharded.dec_params["out_b"]]
    assert state["exp_avg"].shape == (hi - lo,)
    assert state["max_exp_avg_sq"].shape == (hi - lo,)
    np.testing.assert_array_equal(
        sharded.dec_params["rnn"][0]["w_ih"].detach().numpy(),
        jstate.dec_params["rnn"][0]["w_ih"])
    assert sharded.rec_params is tstate.rec_params
    assert t_mesh.shard_state(tstate, t_mesh.make_mesh(
        (("data", 2),), ["cpu"] * 2)) is tstate


def test_dp_batch_actually_split():
    """A batch_sharding keeps one rank's equal rows (axis 0 for videos,
    1 for time-major captions); the prefetcher hands the rank its slice;
    a batch that does not divide names both sizes."""
    tc = _tiny_tc()
    videos, captions = _batch(np.random.default_rng(0), tc, V)
    mesh = t_mesh.make_mesh((("data", 4),), ["cpu"] * 4)
    rows = t_mesh.batch_sharding(mesh, 0)
    assert rows.slices(8) == [slice(0, 2), slice(2, 4), slice(4, 6),
                              slice(6, 8)]
    np.testing.assert_array_equal(rows.part(videos), videos[:2])
    cols = t_mesh.batch_sharding(mesh, 1)
    np.testing.assert_array_equal(cols.part(captions), captions[:, :2])
    np.testing.assert_array_equal(t_mesh.replicated(mesh).part(videos),
                                  videos)
    got = next(iter(prefetch_to_device(iter([(videos, captions)]), 1, "cpu",
                                       sharding=(rows, cols))))
    assert got[0].shape == (2,) + videos.shape[1:]
    assert got[1].shape == (captions.shape[0], 2)
    np.testing.assert_array_equal(dist.put_global(videos, rows).numpy(),
                                  videos[:2])
    with pytest.raises(ValueError, match="batch of 6 does not divide over "
                                         "the mesh's 'data' axis of size 4"):
        rows.part(videos[:6])


@pytest.fixture
def no_group_env(monkeypatch):
    """No torchrun variables; init_process_group recorded, not run."""
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(dist, "_DEVICE", None)
    return calls


def test_initialize_engage_noop_and_raise_rules(no_group_env, monkeypatch):
    """Any of a count, a coordinator or a process id engages a group; a
    count of 1 or less is a single-process run; a process id (or a
    coordinator) without a count raises; torchrun's environment alone
    engages it."""
    calls = no_group_env
    dist.initialize(device="cpu")
    dist.initialize(num_processes=1, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    dist.initialize(device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    assert calls == []
    with pytest.raises(ValueError, match="no process count"):
        dist.initialize(process_id=1, device="cpu")
    with pytest.raises(ValueError, match="no process count"):
        dist.initialize(coordinator_address="localhost:1234", device="cpu")
    with pytest.raises(ValueError, match="no process id"):
        dist.initialize(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="no coordinator"):
        dist.initialize(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="only 'gloo'"):
        dist.initialize(num_processes=2, process_id=0,
                        coordinator_address="h:1", cpu_collectives="mpi",
                        device="cpu")
    assert calls == []
    dist.initialize(coordinator_address="localhost:1234", num_processes=2,
                    process_id=1, device="cpu")
    assert calls[-1] == (("gloo",), {"init_method": "tcp://localhost:1234",
                                     "world_size": 2, "rank": 1})
    assert dist.device() == torch.device("cpu")
    for key, value in (("WORLD_SIZE", "4"), ("RANK", "3"),
                       ("LOCAL_RANK", "1"), ("MASTER_ADDR", "10.0.0.2"),
                       ("MASTER_PORT", "29511")):
        monkeypatch.setenv(key, value)
    dist.initialize(device="cpu")
    assert calls[-1] == (("gloo",), {"init_method": "tcp://10.0.0.2:29511",
                                     "world_size": 4, "rank": 3})


def test_initialize_never_falls_back_to_the_cpu(no_group_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist.initialize(coordinator_address="localhost:1234",
                        num_processes=2, process_id=0)
    assert no_group_env == []
    assert not dist.is_multihost() and dist.is_primary()
    assert dist.process_count() == 1


def test_step_shard_off_a_group_is_none():
    """Off a process group one device holds the whole step: no shard, so
    the step is the single-device one."""
    mesh = t_mesh.make_mesh((("data", 1),), ["cpu"])
    assert t_mesh.step_shard(mesh, 4, V) is None
    assert t_mesh.step_shard(None, 4, V) is None
    x = torch.ones(3)
    assert t_mesh.data_sum(x, None) is x
    params = {"embedding": torch.zeros(V, 2), "out_w": torch.zeros(2, V),
              "out_b": torch.zeros(V)}
    assert t_mesh.gather_params(params, mesh, V) is params
    assert len(tree_leaves(params)) == 3


def test_serving_clis_mesh_needs_the_cards(monkeypatch, tmp_path):
    """``--mesh`` of cli.caption and cli.serve spans every visible card;
    without one it raises before anything loads (no CPU fallback)."""
    from recnet_tpu_torch.cli import caption, serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (caption.main, serve.main):
        args = ["--ckpt", str(tmp_path / "none"), "--mesh"]
        if main is caption.main:
            args += ["--features", str(tmp_path / "none.hdf5")]
        with pytest.raises(RuntimeError, match="no card"):
            main(args)
