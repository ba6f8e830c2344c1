"""Caption and feature files to (vid, video, caption) datasets: a copy of
the parts of ``recnet_tpu/data/datasets.py`` that evaluation and captioning
read.

Reproduces reference dataset/MSVD.py:209-303 semantics: the whole per-split
HDF5 is loaded into host RAM; the video key is "{VideoID}_{Start}_{End}";
the test split's (video, caption) pairs keep HDF5 key order; a caption-less
score dataset feeds the decoder. MSR-VTT reads JSON sentence annotations
keyed by video id. The JAX package's device feature cache
(``feature_cache``, ``get_indexed``) is a training path and is not copied.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


def load_msvd_captions(caption_fpath: str) -> Dict[str, List[str]]:
    """CSV → {vid: [caption,...]}, English + non-null rows only
    (reference: dataset/MSVD.py:242-253)."""
    import pandas as pd

    df = pd.read_csv(caption_fpath)
    df = df[df["Language"] == "English"]
    df = df[pd.notnull(df["Description"])]
    captions: Dict[str, List[str]] = defaultdict(list)
    for video_id, start, end, caption in df[
            ["VideoID", "Start", "End", "Description"]].values:
        vid = "{}_{}_{}".format(video_id, start, end)
        captions[vid].append(caption)
    return captions


def load_msvd_caption_values(caption_fpath: str) -> List[str]:
    """All English caption strings, for vocab building
    (reference: dataset/MSVD.py:183-188)."""
    import pandas as pd

    df = pd.read_csv(caption_fpath)
    df = df[df["Language"] == "English"]
    df = df[pd.notnull(df["Description"])]
    return list(df["Description"].values)


def load_msrvtt_captions(annotation_fpath: str) -> Dict[str, List[str]]:
    """MSR-VTT videodatainfo-style JSON → {video_id: [caption,...]}."""
    with open(annotation_fpath) as f:
        info = json.load(f)
    captions: Dict[str, List[str]] = defaultdict(list)
    for sent in info["sentences"]:
        captions[sent["video_id"]].append(sent["caption"])
    return captions


def load_msrvtt_caption_values(annotation_fpath: str) -> List[str]:
    with open(annotation_fpath) as f:
        info = json.load(f)
    return [s["caption"] for s in info["sentences"]]


def load_videos_hdf5(video_fpath: str) -> Dict[str, np.ndarray]:
    """Load every dataset in the HDF5 into RAM (reference: MSVD.py:234-240)."""
    import h5py

    videos: Dict[str, np.ndarray] = {}
    with h5py.File(video_fpath, "r") as fin:
        for vid in fin:
            videos[vid] = np.asarray(fin[vid])
    return videos


class CaptionDataset:
    """The (vid, caption) pairs of a split, one per caption, in HDF5 key
    order (reference: dataset/MSVD.py:255-264). Evaluation reads only
    ``video_caption_pairs`` and ``videos``."""

    def __init__(self, videos: Dict[str, np.ndarray],
                 captions: Dict[str, List[str]]):
        self.videos = videos
        self.captions = captions
        self.video_caption_pairs: List[Tuple[str, str]] = [
            (vid, cap) for vid in videos for cap in captions.get(vid, [])]

    def __len__(self) -> int:
        return len(self.video_caption_pairs)


class ScoreDataset:
    """Caption-less (vid, video) dataset for decoding
    (reference: dataset/MSVD.py:267-303)."""

    def __init__(self, videos: Dict[str, np.ndarray],
                 transform_frame: Optional[Callable] = None):
        self.videos = videos
        self.transform_frame = transform_frame
        self.vids = list(videos.keys())

    def __len__(self) -> int:
        return len(self.vids)

    def get(self, idx: int):
        vid = self.vids[idx]
        video = self.videos[vid]
        if self.transform_frame is not None:
            video = self.transform_frame(video)
        return vid, video
