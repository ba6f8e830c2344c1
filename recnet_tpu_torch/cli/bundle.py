"""CLI: build / inspect preprocessed-corpus bundles offline (a copy of
``recnet_tpu/cli/bundle.py``; the bundles are the same files).

``recnet-torch-train --data_bundle`` builds the bundle lazily on first use;
this command does the same build as an explicit offline step (on a
data-prep host, say, so no training run pays the one-time pack), and prints
what a bundle contains. A host tool: numpy, h5py and torch's bfloat16
cast, no device.

Usage:
    python -m recnet_tpu_torch.cli.bundle build [--corpus MSVD] [--data_root D] ...
    python -m recnet_tpu_torch.cli.bundle info  [--corpus MSVD] [--data_root D] ...
    python -m recnet_tpu_torch.cli.bundle info --path <bundle-dir>
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _config(args):
    from recnet_tpu_torch.config import TrainConfig
    kw = {"data_bundle": True}
    if args.data_root:
        kw["data_root"] = args.data_root
    if args.corpus:
        kw["corpus"] = args.corpus
    if args.encoder:
        kw["encoder_model"] = args.encoder
    if args.encoder_output_len is not None:
        kw["encoder_output_len"] = args.encoder_output_len
    if args.min_count is not None:
        kw["min_count"] = args.min_count
    if args.caption_max_len is not None:
        kw["caption_max_len"] = args.caption_max_len
    if args.bundle_root:
        kw["data_bundle_root"] = args.bundle_root
    if args.feature_cache_dtype:
        # half-width storage is keyed: an offline build for a bf16-cache
        # training config must pass the same dtype to address that bundle
        kw["device_feature_cache"] = True
        kw["feature_cache_dtype"] = args.feature_cache_dtype
    return TrainConfig(**kw)


def _info(path: str) -> int:
    meta_fpath = os.path.join(path, "meta.json")
    if not os.path.isfile(meta_fpath):
        print(f"no bundle at {path}", file=sys.stderr)
        return 1
    with open(meta_fpath) as f:
        meta = json.load(f)
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    meta["path"] = path
    meta["size_bytes"] = size
    print(json.dumps(meta, indent=2))
    return 0


def main(argv=None) -> int:
    a = argparse.ArgumentParser(
        description="Build or inspect a preprocessed-corpus bundle "
                    "(packed features + tokenized captions + vocab; "
                    "see recnet_tpu_torch/data/bundle.py)")
    a.add_argument("command", choices=["build", "info"])
    a.add_argument("--corpus", type=str, default=None)
    a.add_argument("--data_root", type=str, default=None)
    a.add_argument("--bundle_root", type=str, default=None,
                   help="override TrainConfig.data_bundle_root")
    a.add_argument("--encoder", type=str, default=None,
                   help="override TrainConfig.encoder_model")
    a.add_argument("--encoder_output_len", type=int, default=None)
    a.add_argument("--min_count", type=int, default=None)
    a.add_argument("--caption_max_len", type=int, default=None)
    a.add_argument("--feature_cache_dtype", type=str, default=None,
                   choices=["float32", "bfloat16", "float16"],
                   help="build the bundle for a device-feature-cache "
                        "config with this storage dtype (train/val packed "
                        "half-width; test stays float32)")
    a.add_argument("--path", type=str, default=None,
                   help="info: inspect this bundle dir directly instead of "
                        "resolving the config's keyed directory")
    a.add_argument("--rebuild", action="store_true",
                   help="build: replace an existing bundle for this key")
    args = a.parse_args(argv)

    if args.command == "info" and args.path:
        return _info(args.path)

    from recnet_tpu_torch.data import bundle as B
    tc = _config(args)
    path = B.bundle_dir(tc)

    if args.command == "info":
        return _info(path)

    if os.path.isdir(path) and not args.rebuild:
        print(f"bundle already exists at {path} (use --rebuild to replace)",
              file=sys.stderr)
        return _info(path)
    if os.path.isdir(path):
        import shutil
        shutil.rmtree(path)
    B.build_bundle(tc, path)
    return _info(path)


if __name__ == "__main__":
    sys.exit(main())
