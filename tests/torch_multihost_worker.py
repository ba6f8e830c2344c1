"""One rank of a multi-process CPU group for tests/test_torch_multihost.py:
the port over ``torch.distributed`` with gloo, imports no JAX.

    python torch_multihost_worker.py <rank> <world> <port> <job.json>

The job is a list of scenarios run in order in this one group (a new mesh
each), every rank writing what the test compares under the scenario's
``out`` ("{rank}" in it becomes the rank):

* ``steps``: train steps from a checkpoint on a mesh, over the global
  batches of an npz; the metrics of every step and the state's leaves
  (gathered over 'model') after the last;
* ``ce``: ``ops.losses.step_mean_ce`` over this rank's rows of a batch
  whose ranks hold different token counts, with its gradient;
* ``vocab``: ``parallel.vocab``'s lookup, token NLL and argmax over this
  rank's vocabulary shard, with gradients;
* ``loop``: ``training.loop.train(use_mesh=True)`` on a fixture corpus,
  in a directory of the rank's own; the final state's digest.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh_shape(text):
    return tuple((kv.split("=")[0], int(kv.split("=")[1]))
                 for kv in text.split(","))


def _config(sc):
    from recnet_tpu_torch.config import TrainConfig
    with open(sc["config"]) as f:
        return TrainConfig.from_json(f.read()).replace(
            mesh_shape=_mesh_shape(sc["mesh"]))


def steps(sc, rank):
    import numpy as np
    import torch
    from recnet_tpu_torch import checkpoint as ckpt
    from recnet_tpu_torch.models import decoder as dec_mod
    from recnet_tpu_torch.models import reconstructors as rec_mod
    from recnet_tpu_torch.parallel import mesh as mesh_lib
    from recnet_tpu_torch.training.step import build_train_step

    tc = _config(sc)
    V = sc["vocab_size"]
    mesh = mesh_lib.make_mesh(tc.mesh_shape)
    state, _ = ckpt.load_checkpoint(sc["ckpt"], tc, V, "cpu", mesh=mesh)
    dcfg = dec_mod.config_from_train(tc, V)
    rcfg = rec_mod.config_from_train(tc) if tc.use_recon else None
    step = build_train_step(tc, dcfg, rcfg, mesh)
    data = np.load(sc["batches"])
    rows = mesh_lib.batch_sharding(mesh, 0)
    cols = mesh_lib.batch_sharding(mesh, 1)
    metrics = []
    for videos, captions in zip(data["videos"], data["captions"]):
        m = step(state, torch.from_numpy(rows.part(videos).copy()),
                 torch.from_numpy(cols.part(captions).copy()))
        metrics.append([float(m[k]) for k in ("loss", "dec_loss",
                                              "rec_loss", "grad_norm",
                                              "n_tokens")])
    leaves = ckpt.state_leaves(state, mesh, V)
    if rank == 0:
        np.savez(sc["out"], metrics=np.asarray(metrics),
                 **{f"leaf_{i}": x for i, x in enumerate(leaves)})


def ce(sc, rank):
    import numpy as np
    import torch
    from recnet_tpu_torch.ops.losses import step_mean_ce
    from recnet_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(_mesh_shape(sc["mesh"]))
    data = np.load(sc["inputs"])
    part = mesh_lib.batch_sharding(mesh, 1).part
    logits = torch.tensor(part(data["logits"]), requires_grad=True)
    shard = mesh_lib.step_shard(mesh, logits.shape[1], logits.shape[2])
    loss, n_tokens = step_mean_ce(logits, torch.from_numpy(
        part(data["targets"]).copy()), torch.from_numpy(
        part(data["mask"]).copy()), shard)
    loss.backward()
    total = mesh_lib.data_sum(loss, shard)
    np.savez(sc["out"].format(rank=rank), share=loss.item(),
             total=total.item(), n_tokens=n_tokens.item(),
             grad=logits.grad.numpy())


def vocab(sc, rank):
    import numpy as np
    import torch
    from recnet_tpu_torch.parallel import mesh as mesh_lib
    from recnet_tpu_torch.parallel import vocab as vocab_par

    mesh = mesh_lib.make_mesh(_mesh_shape(sc["mesh"]))
    data = np.load(sc["inputs"])
    V = data["table"].shape[0]
    shard = mesh_lib.step_shard(mesh, len(data["tokens"]), V)
    lo, hi, _ = shard.cols
    table = torch.tensor(data["table"][lo:hi], requires_grad=True)
    logits = torch.tensor(data["logits"][:, lo:hi], requires_grad=True)
    emb = vocab_par.embed(table, torch.from_numpy(data["tokens"]), shard)
    nll = vocab_par.token_nll(logits, torch.from_numpy(data["targets"]),
                              shard)
    top = vocab_par.argmax(logits, shard)
    ((emb * torch.from_numpy(data["emb_weight"])).sum()
     + (nll * torch.from_numpy(data["nll_weight"])).sum()).backward()
    np.savez(sc["out"].format(rank=rank), cols=np.asarray([lo, hi]),
             emb=emb.detach().numpy(), nll=nll.detach().numpy(),
             argmax=top.numpy(), table_grad=table.grad.numpy(),
             logits_grad=logits.grad.numpy())


def loop(sc, rank):
    import numpy as np
    from recnet_tpu_torch import checkpoint as ckpt
    from recnet_tpu_torch.parallel import mesh as mesh_lib
    from recnet_tpu_torch.training.loop import train

    tc = _config(sc)
    out = sc["out"].format(rank=rank)
    os.makedirs(out, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(out)             # predictions.txt lands here (rank 0 only)
    try:
        state = train(tc, use_mesh=True, log_dir=os.path.join(out, "logs"),
                      save_dir=os.path.join(out, "ckpt"),
                      resume_from=sc.get("resume"), device="cpu")
    finally:
        os.chdir(cwd)
    mesh = mesh_lib.make_mesh(tc.mesh_shape)
    leaves = ckpt.state_leaves(state, mesh, sc["vocab_size"])
    digest = sum(float(np.abs(x).sum(dtype=np.float64)) for x in leaves)
    print(f"DIGEST {rank} {digest:.9f}", flush=True)
    np.savez(os.path.join(out, "final.npz"),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})


def main():
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    with open(sys.argv[4]) as f:
        job = json.load(f)
    sys.path.insert(0, REPO)
    from recnet_tpu_torch.parallel import distributed as dist
    dist.initialize(coordinator_address=f"localhost:{port}",
                    num_processes=world, process_id=rank, device="cpu")
    runners = {"steps": steps, "ce": ce, "vocab": vocab, "loop": loop}
    try:
        for sc in job["scenarios"]:
            runners[sc["kind"]](sc, rank)
            print(f"DONE {sc['name']}", flush=True)
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main()
