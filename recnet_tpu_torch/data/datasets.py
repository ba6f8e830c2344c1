"""Caption and feature files to (vid, video, caption) datasets: a copy of
``recnet_tpu/data/datasets.py``.

Reproduces reference dataset/MSVD.py:209-303 semantics: the whole per-split
HDF5 is loaded into host RAM; the video key is "{VideoID}_{Start}_{End}";
one example per (video, caption) pair, in HDF5 key order; a caption-less
score dataset feeds the decoder. MSR-VTT reads JSON sentence annotations
keyed by video id. ``feature_cache`` and ``get_indexed`` serve the device
feature cache (config.device_feature_cache).
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
    """(vid, video, caption) pairs with per-item transforms, one per
    caption, in HDF5 key order (reference: dataset/MSVD.py:209-264)."""

    def __init__(self, videos: Dict[str, np.ndarray],
                 captions: Dict[str, List[str]],
                 transform_frame: Optional[Callable] = None,
                 transform_caption: Optional[Callable] = None):
        self.videos = videos
        self.captions = captions
        self.transform_frame = transform_frame
        self.transform_caption = transform_caption
        self.video_caption_pairs: List[Tuple[str, str]] = [
            (vid, cap) for vid in videos for cap in captions.get(vid, [])]
        self._vid_to_row: Optional[Dict[str, int]] = None

    def __len__(self) -> int:
        return len(self.video_caption_pairs)

    def get(self, idx: int):
        vid, caption = self.video_caption_pairs[idx]
        video = self.videos[vid]
        if self.transform_frame is not None:
            video = self.transform_frame(video)
        if self.transform_caption is not None:
            caption = self.transform_caption(caption)
        return vid, video, caption

    def feature_cache(self) -> np.ndarray:
        """Every video transformed once, stacked to (V, frames, feat)
        float32 in ``videos`` order, the rows :meth:`get_indexed` gives.
        Valid only for a deterministic frame transform (uniform sampling):
        a cache would freeze one random draw for the whole run."""
        out: Optional[np.ndarray] = None
        for i, vid in enumerate(self.videos):
            x = self.videos[vid]
            if self.transform_frame is not None:
                x = self.transform_frame(x)
            x = np.asarray(x, np.float32)
            if out is None:
                out = np.empty((len(self.videos),) + x.shape, np.float32)
            if x.shape != out.shape[1:]:
                raise ValueError(f"video {vid!r} has shape {x.shape}, "
                                 f"expected {out.shape[1:]}")
            out[i] = x
        if out is None:
            raise ValueError("feature_cache() of an empty dataset")
        return out

    def get_indexed(self, idx: int):
        """(vid, the video's row in :meth:`feature_cache`, caption): the
        caption transform runs, the video is not materialised."""
        if self._vid_to_row is None:
            self._vid_to_row = {v: i for i, v in enumerate(self.videos)}
        vid, caption = self.video_caption_pairs[idx]
        if self.transform_caption is not None:
            caption = self.transform_caption(caption)
        return vid, self._vid_to_row[vid], caption


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
