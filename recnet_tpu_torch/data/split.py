"""Offline dataset splitter (reference: scripts/split.py): a copy of
``recnet_tpu/data/split.py``, writing the same files from the same inputs.

Shuffles the HDF5 video keys with a fixed seed (42) and writes per-split
HDF5 feature files + caption CSV subsets, sized 1200/100/670 for MSVD
(reference: scripts/split.py:36-53, config.py:13-16).
"""

from __future__ import annotations

import random
from typing import List

from recnet_tpu_torch.config import SplitConfig


def split(config: SplitConfig) -> None:
    """Corpus dispatch: MSVD seeded shuffle (reference scripts/split.py) or
    MSR-VTT's own per-video split labels."""
    if config.corpus == "MSR-VTT":
        return split_msrvtt(config)
    return split_msvd(config)


def split_msrvtt(config: SplitConfig) -> None:
    """Split MSR-VTT by the ``split`` labels inside videodatainfo.json.

    MSR-VTT ships its official split in the annotation file itself
    (``videos[*].split`` = train/validate/test — the standard
    6513/497/2990); no seeded shuffle is involved.  The reference has no
    MSR-VTT loader at all (its README lists only paper numbers,
    README.md:95-97).  Falls back to seeded-shuffle sizing (n_train/n_val
    from the config) when the JSON carries no ``videos`` section.
    Writes {encoder}_{split}.hdf5 + {split}.json in the layout
    TrainConfig.video_fpath/caption_fpath expects.
    """
    import json as _json

    import h5py

    with open(config.caption_fpath) as f:
        info = _json.load(f)
    sentences = info.get("sentences", [])

    fin = h5py.File(config.video_fpath, "r")
    names = {"train": "train", "validate": "val", "test": "test"}
    if info.get("videos"):
        splits = {"train": [], "val": [], "test": []}
        for v in info["videos"]:
            ours = names.get(v.get("split", ""))
            if ours and v["video_id"] in fin:
                splits[ours].append(v["video_id"])
    else:
        random.seed(config.random_seed)
        vids: List[str] = list(fin.keys())
        random.shuffle(vids)
        splits = {
            "train": vids[: config.n_train],
            "val": vids[config.n_train: config.n_train + config.n_val],
            "test": vids[config.n_train + config.n_val:],
        }

    for name, split_vids in splits.items():
        vfp = config.split_video_fpath(name)
        with h5py.File(vfp, "w") as fout:
            for vid in split_vids:
                fout[vid] = fin[vid][()]
        print(f"Saved {vfp} ({len(split_vids)} videos)")
        vidset = set(split_vids)
        mfp = config.split_metadata_fpath(name)
        with open(mfp, "w") as fout:
            _json.dump({"sentences": [s for s in sentences
                                      if s["video_id"] in vidset]}, fout)
        print(f"Saved {mfp}")
    fin.close()


def split_msvd(config: SplitConfig) -> None:
    import h5py
    import pandas as pd

    random.seed(config.random_seed)

    fin = h5py.File(config.video_fpath, "r")
    df = pd.read_csv(config.caption_fpath)
    df = df[df["Language"] == "English"]
    df = df[pd.notnull(df["Description"])]
    df = df.reset_index(drop=True)

    vids: List[str] = list(fin.keys())
    random.shuffle(vids)

    splits = {
        "train": vids[: config.n_train],
        "val": vids[config.n_train: config.n_train + config.n_val],
        "test": vids[config.n_train + config.n_val:],
    }

    for name, split_vids in splits.items():
        vfp = config.split_video_fpath(name)
        with h5py.File(vfp, "w") as fout:
            for vid in split_vids:
                fout[vid] = fin[vid][()]
        print(f"Saved {vfp}")

        vidset = set(split_vids)
        keep = [i for i, r in df.iterrows()
                if "{}_{}_{}".format(r.iloc[0], r.iloc[1], r.iloc[2]) in vidset]
        mfp = config.split_metadata_fpath(name)
        df.iloc[keep].to_csv(mfp)
        print(f"Saved {mfp}")

    fin.close()


def main(argv=None):
    import argparse

    a = argparse.ArgumentParser(
        description="Split the corpus HDF5+CSV into train/val/test "
                    "(reference: python -m scripts.split, seed 42)")
    a.add_argument("--data_root", type=str, default=None,
                   help="override SplitConfig.data_root")
    a.add_argument("--corpus", type=str, default=None)
    a.add_argument("--encoder", type=str, default=None,
                   help="override SplitConfig.encoder_model")
    args = a.parse_args(argv)
    kw = {}
    if args.data_root:
        kw["data_root"] = args.data_root
    if args.corpus:
        kw["corpus"] = args.corpus
    if args.encoder:
        kw["encoder_model"] = args.encoder
    split(SplitConfig(**kw))


if __name__ == "__main__":
    main()
