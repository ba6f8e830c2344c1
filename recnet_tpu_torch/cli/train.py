"""CLI: python -m recnet_tpu_torch.cli.train [--debug] [--loss_only]
[--config f.json] [--resume <step dir>] [--device cuda|cpu] [--mesh]

The flags of ``recnet_tpu.cli.train`` (reference train.py:200-204, plus
config files, resume, the mesh and multi-process flags and the dispatch
and cache knobs), and ``--device``: the card by default, the CPU only
when asked; without a card ``--device cuda`` raises. Checkpoints are npz:
``--ckpt_backend npz`` is taken, ``orbax`` is refused with the checkpoint
reader's reason, and ``--async_ckpt`` as the JAX CLI refuses it without
orbax.

Several processes, one a card, train one model over a mesh:

    torchrun --nproc_per_node 4 -m recnet_tpu_torch.cli.train \
        --config c.json --mesh_shape data=2,model=2

torchrun's environment is enough; without it, give every process
``--coordinator host:port --num_processes N --process_id i``.
"""

from __future__ import annotations

import argparse

from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.training.loop import train


def main(argv=None):
    a = argparse.ArgumentParser()
    a.add_argument("--debug", "-D", action="store_true")
    a.add_argument("--loss_only", "-L", action="store_true")
    a.add_argument("--config", type=str, default=None,
                   help="TrainConfig JSON file (defaults match the reference)")
    a.add_argument("--resume", type=str, default=None,
                   help="checkpoint step directory to resume from")
    a.add_argument("--mesh", action="store_true",
                   help="shard over the process group's devices (data "
                        "parallel)")
    a.add_argument("--mesh_shape", type=str, default=None,
                   help='e.g. "data=4,model=2" (implies --mesh)')
    a.add_argument("--keep_last_k", type=int, default=0,
                   help="checkpoint retention (0 = keep all)")
    a.add_argument("--profile_dir", type=str, default=None,
                   help="torch.profiler trace directory (traces iters 10-14, "
                   "with the program's spans)")
    a.add_argument("--steps_per_dispatch", type=int, default=None,
                   help="train steps per dispatch (cadences must divide by k)")
    a.add_argument("--device_feature_cache", action="store_true",
                   help="keep all train video features on the device and "
                        "send only row indices per step (requires uniform "
                        "frame sampling)")
    a.add_argument("--feature_cache_dtype", type=str, default=None,
                   choices=["float32", "bfloat16", "float16"],
                   help="storage dtype of the device feature caches; "
                        "compute stays float32")
    a.add_argument("--data_bundle", action="store_true",
                   help="build/load the preprocessed-corpus bundle (packed "
                        "features + tokenized captions + vocab, mmapped; "
                        "built at first use, or by recnet_tpu_torch.cli."
                        "bundle build)")
    a.add_argument("--coordinator", type=str, default=None,
                   help="multi-process: rank 0's address host:port "
                        "(torchrun sets MASTER_ADDR/MASTER_PORT instead)")
    a.add_argument("--num_processes", type=int, default=None,
                   help="multi-process: total process count (implies "
                        "--mesh)")
    a.add_argument("--process_id", type=int, default=None,
                   help="multi-process: this process's rank")
    a.add_argument("--cpu_collectives", type=str, default=None,
                   choices=["gloo"],
                   help="collectives through gloo on the card too (NCCL by "
                        "default there; gloo always on the CPU)")
    a.add_argument("--ckpt_backend", choices=["npz", "orbax"], default="npz",
                   help="checkpoint format: npz (orbax is the JAX "
                        "package's; refused here)")
    a.add_argument("--async_ckpt", action="store_true",
                   help="non-blocking checkpoint saves (orbax backend; "
                        "refused here)")
    a.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = a.parse_args(argv)
    if args.ckpt_backend == "orbax":
        from recnet_tpu_torch.checkpoint import NPZ_ONLY
        a.error(f"--ckpt_backend orbax: {NPZ_ONLY}")
    if args.async_ckpt:
        a.error("--async_ckpt requires --ckpt_backend orbax "
                "(npz saves are synchronous)")

    # before anything touches a device; a no-op unless the flags or
    # torchrun's environment ask for a process group
    from recnet_tpu_torch.parallel import distributed as dist
    dist.initialize(coordinator_address=args.coordinator,
                    num_processes=args.num_processes,
                    process_id=args.process_id,
                    cpu_collectives=args.cpu_collectives,
                    device=args.device)
    try:
        _run(args, dist.is_multihost())
    finally:
        dist.shutdown()


def _run(args, multihost: bool):
    if args.config:
        with open(args.config) as f:
            tc = TrainConfig.from_json(f.read())
    else:
        tc = TrainConfig()
    use_mesh = args.mesh or multihost
    if args.mesh_shape:
        tc = tc.replace(mesh_shape=tuple(
            (kv.split("=")[0], int(kv.split("=")[1]))
            for kv in args.mesh_shape.split(",")))
        use_mesh = True
    if args.steps_per_dispatch is not None:
        tc = tc.replace(steps_per_dispatch=args.steps_per_dispatch)
    if args.device_feature_cache:
        tc = tc.replace(device_feature_cache=True)
    if args.feature_cache_dtype is not None:
        tc = tc.replace(feature_cache_dtype=args.feature_cache_dtype)
    if args.data_bundle:
        tc = tc.replace(data_bundle=True)
    # die on incompatible knobs before any data or device is touched
    tc.validate(debug=args.debug)
    train(tc, debug=args.debug, loss_only=args.loss_only,
          resume_from=args.resume, use_mesh=use_mesh,
          profile_dir=args.profile_dir, keep_last_k=args.keep_last_k,
          device=args.device)


if __name__ == "__main__":
    main()
