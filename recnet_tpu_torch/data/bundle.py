"""Preprocessed-corpus bundles: pack the host-side data prep once, mmap it
after. A copy of ``recnet_tpu/data/bundle.py`` that writes the same files,
byte for byte, under the same key, so a bundle built by either package
loads in the other.

The reference recomputes everything from raw CSV/JSON/HDF5 on every start —
the whole per-split HDF5 is read into RAM (reference: dataset/MSVD.py:234-240),
the vocab is re-derived from the full caption file (reference: eval.py:185)
and every caption is re-tokenized per epoch.

A bundle is a versioned on-disk artifact keyed on a hash of every input
file's (size, mtime) plus every config knob that shapes preprocessing. It
contains, per split:

* ``{split}_feats.npy``    — (V, frames, feat), the frame pipeline already
  applied (uniform sampling only — it is deterministic; stochastic
  sampling would be frozen by a cache and is rejected, same rule as
  ``config.device_feature_cache``). train/val are stored in the config's
  ``feature_cache_dtype`` when the device feature cache is on: the cast the
  training loop would do per start is done once at build. bfloat16 is
  stored as raw 16-bit words under the npy descr ``'<V2'``, the header the
  JAX package's ``ml_dtypes.bfloat16`` arrays write; ``as_tensor`` reads
  them back as ``torch.bfloat16``. test features stay float32 always: eval
  decodes them directly and the metric scores must not move with a cache
  knob;
* ``{split}_rows.npy``     — (N,) int32 pair→feature-row map;
* ``{split}_captions.npy`` — (N, max_sentence_len+1) int32 tokenized/padded
  caption matrix (the caption pipeline already applied);
* ``{split}_vids.json``    — feature-row-order video ids;
* ``{split}_raw_captions.json`` — pair-order raw caption strings (ground
  truth for the metric suite);

plus ``vocab.json`` and ``meta.json``. Loading mmaps the feature arrays
(np.load mmap_mode="r"). Bundled and fresh-built corpora are
batch-for-batch bit-identical (tests/test_torch_bundle.py).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from recnet_tpu_torch.data import datasets as D
from recnet_tpu_torch.data import transforms as T
from recnet_tpu_torch.data.vocab import Vocab

BUNDLE_VERSION = 2
SPLITS = ("train", "val", "test")

# bfloat16 words: numpy has no bfloat16, and the npy format stores the JAX
# package's ml_dtypes.bfloat16 under the void descr '<V2' (it loads back
# as '|V2'), so the words are written and read as 2-byte voids
_BF16_WORDS = np.dtype("V2")
_BF16_DESCR = "<V2"
_STORE_DTYPES = {"float32": np.dtype(np.float32),
                 "float16": np.dtype(np.float16), "bfloat16": _BF16_WORDS}


def feature_store_dtype(tc, split: str) -> str:
    """Storage dtype for a split's packed features. train/val follow
    feature_cache_dtype when the device cache is on — they are only ever
    consumed through that cache then, so pre-casting at build is the same
    single rounding the loop would apply. test stays float32 (decoded
    directly; scores must not move with a cache knob)."""
    if split == "test" or not getattr(tc, "device_feature_cache", False):
        return "float32"
    return getattr(tc, "feature_cache_dtype", "float32")


def as_tensor(feats: np.ndarray) -> torch.Tensor:
    """A packed feature array (or a CaptionDataset's float32 cache) as a
    host tensor, read into memory: bfloat16 words become a
    ``torch.bfloat16`` tensor through an int16 view."""
    x = np.array(feats)
    if x.dtype == _BF16_WORDS:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _cast(x: np.ndarray, dtype_name: str) -> np.ndarray:
    """float32 features in the storage dtype; bfloat16 rounds to nearest
    even (``Tensor.to``), as ``ml_dtypes``' cast does."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(x).to(torch.bfloat16).view(
            torch.int16).numpy().view(_BF16_WORDS)
    return x.astype(_STORE_DTYPES[dtype_name])


# ---------------------------------------------------------------------------
# Keying
# ---------------------------------------------------------------------------


def _file_stat(path: str) -> Tuple[str, int, int]:
    st = os.stat(path)
    return (os.path.basename(path), st.st_size, st.st_mtime_ns)


def bundle_key(tc) -> str:
    """Hash of everything that shapes preprocessing: the config knobs the
    transforms/vocab read, plus (size, mtime) of every input file — the
    JAX package's key for the same config and files. Content hashing is
    deliberately avoided: the inputs are multi-GB HDF5 files."""
    if tc.frame_sampling_method != "uniform":
        raise ValueError(
            "data bundles require frame_sampling_method='uniform' "
            "(stochastic sampling would be frozen by the packed features); "
            f"got {tc.frame_sampling_method!r}")
    inputs = [tc.total_caption_fpath]
    for split in SPLITS:
        inputs.append(tc.video_fpath(split))
        inputs.append(tc.caption_fpath(split))
    blob = {
        "version": BUNDLE_VERSION,
        "corpus": tc.corpus,
        "encoder_model": tc.encoder_model,
        "min_count": tc.min_count,
        "caption_max_len": tc.caption_max_len,
        "frame_sampling_method": tc.frame_sampling_method,
        "encoder_output_len": tc.encoder_output_len,
        "init_word2idx": sorted(tc.init_word2idx_dict.items()),
        # half-width feature storage is keyed, so a config switching
        # feature_cache_dtype (or toggling the device cache) addresses a
        # different bundle instead of silently reusing the wrong rounding
        "feature_store_dtype": {s: feature_store_dtype(tc, s)
                                for s in SPLITS},
        "files": [_file_stat(p) for p in inputs],
    }
    return hashlib.sha256(
        json.dumps(blob, sort_keys=True).encode()).hexdigest()[:16]


def bundle_dir(tc) -> str:
    root = getattr(tc, "data_bundle_root", "") or os.path.join(
        tc.data_root, tc.corpus, "bundles")
    return os.path.join(root, bundle_key(tc))


# ---------------------------------------------------------------------------
# Bundled datasets — duck-typed to datasets.CaptionDataset / ScoreDataset
# ---------------------------------------------------------------------------


class BundledCaptionDataset:
    """CaptionDataset API over packed arrays (same consumer surface:
    __len__/get/get_indexed/feature_cache/video_caption_pairs)."""

    def __init__(self, vids: List[str], feats: np.ndarray,
                 rows: np.ndarray, captions: np.ndarray,
                 raw_captions: List[str]):
        self.vids = vids
        self.feats = feats            # (V, frames, feat), possibly mmap
        self.rows = rows              # (N,) int32
        self.captions = captions      # (N, T+1) int32
        self.raw_captions = raw_captions
        # (vid, raw caption) pairs — what evaluation.py feeds gts_from_pairs
        self.video_caption_pairs: List[Tuple[str, str]] = [
            (vids[r], c) for r, c in zip(rows, raw_captions)]

    def __len__(self) -> int:
        return len(self.rows)

    def get(self, idx: int):
        r = int(self.rows[idx])
        return self.vids[r], self.feats[r], self.captions[idx]

    def get_indexed(self, idx: int):
        r = int(self.rows[idx])
        return self.vids[r], r, self.captions[idx]

    def feature_cache(self) -> np.ndarray:
        # already packed in feature-row order; uniform sampling is the
        # bundle precondition, so this equals CaptionDataset.feature_cache
        # (bfloat16 storage as words: ``as_tensor`` reads them)
        return self.feats


class BundledScoreDataset:
    """ScoreDataset API over packed (already-transformed) features."""

    def __init__(self, vids: List[str], feats: np.ndarray):
        self.vids = vids
        self.feats = feats

    def __len__(self) -> int:
        return len(self.vids)

    def get(self, idx: int):
        return self.vids[idx], self.feats[idx]


class Bundle:
    def __init__(self, path: str, vocab: Vocab,
                 datasets: Dict[str, BundledCaptionDataset]):
        self.path = path
        self.vocab = vocab
        self.datasets = datasets

    def score_dataset(self) -> BundledScoreDataset:
        test = self.datasets["test"]
        return BundledScoreDataset(test.vids, test.feats)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def _open_feats(path: str, dtype_name: str, shape) -> np.ndarray:
    """A writable mmap of a new ``.npy``; bfloat16 under the '<V2' header
    the JAX package's files carry, so both write the same bytes."""
    if dtype_name != "bfloat16":
        return np.lib.format.open_memmap(
            path, mode="w+", dtype=_STORE_DTYPES[dtype_name], shape=shape)
    with open(path, "wb") as fp:
        np.lib.format.write_array_header_1_0(fp, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": tuple(shape)})
        offset = fp.tell()
    return np.memmap(path, dtype=_BF16_WORDS, mode="r+", offset=offset,
                     shape=tuple(shape))


def _write_split(tc, split: str, vocab: Vocab, out_dir: str,
                 videos: Mapping[str, np.ndarray],
                 captions: Mapping[str, List[str]],
                 transform_frame: Callable,
                 transform_caption: Callable) -> Dict:
    """Pack one split from ``videos`` ({vid: (frames, feat)}, an open HDF5
    file or a dict, read in key order) and ``captions`` ({vid: [caption,
    ...]}): each video is read, transformed and written straight into the
    packed ``.npy`` (one touch a byte; the dirty file-backed pages stay
    reclaimable, so the build's RSS stays bounded for corpora larger than
    host RAM), then the pair rows, the caption matrix and the JSON files.
    Returns the split's entry of meta.json."""
    dtype_name = feature_store_dtype(tc, split)
    keys = list(videos)
    feats: Optional[np.ndarray] = None
    vids: List[str] = []
    for i, vid in enumerate(keys):
        x = transform_frame(np.asarray(videos[vid]))
        x = np.asarray(x, np.float32)
        if feats is None:
            feats = _open_feats(os.path.join(out_dir, f"{split}_feats.npy"),
                                dtype_name, (len(keys),) + x.shape)
        if x.shape != feats.shape[1:]:
            raise ValueError(
                f"video {vid!r} has shape {x.shape}, expected "
                f"{feats.shape[1:]}")
        x = _cast(x, dtype_name)    # the loop's cast-once, done at build
        if dtype_name == "float16" and not np.isfinite(x).all():
            raise ValueError(
                f"video {vid!r} overflows float16 (±65504); use "
                "feature_cache_dtype='bfloat16' (keeps f32 range)")
        feats[i] = x
        vids.append(vid)
    if feats is None:
        raise ValueError(f"no videos in the {split} split")
    feats.flush()
    del feats  # drop the writable mapping before the atomic rename

    rows: List[int] = []
    raw: List[str] = []
    for r, vid in enumerate(vids):
        for cap in captions.get(vid, []):
            rows.append(r)
            raw.append(cap)
    cap_mat = np.empty((len(raw), vocab.max_sentence_len + 1), np.int32)
    for i, cap in enumerate(raw):
        cap_mat[i] = np.asarray(transform_caption(cap), np.int32)

    np.save(os.path.join(out_dir, f"{split}_rows.npy"),
            np.asarray(rows, np.int32))
    np.save(os.path.join(out_dir, f"{split}_captions.npy"), cap_mat)
    with open(os.path.join(out_dir, f"{split}_vids.json"), "w") as f:
        json.dump(vids, f)
    with open(os.path.join(out_dir, f"{split}_raw_captions.json"), "w") as f:
        json.dump(raw, f)
    return {"n_videos": len(vids), "n_pairs": len(raw),
            "feats_dtype": dtype_name}


def _build_split(tc, split: str, vocab: Vocab, out_dir: str,
                 transform_frame, transform_caption) -> Dict:
    """One streaming pass over the split's HDF5 and caption file
    (the reference's load-everything step this replaces is
    dataset/MSVD.py:234-240)."""
    import h5py

    captions = (D.load_msvd_captions(tc.caption_fpath(split))
                if tc.corpus == "MSVD"
                else D.load_msrvtt_captions(tc.caption_fpath(split)))
    with h5py.File(tc.video_fpath(split), "r") as fin:
        return _write_split(tc, split, vocab, out_dir, fin, captions,
                            transform_frame, transform_caption)


def _pack(tc, path: str, vocab: Vocab, write_split: Callable, log) -> str:
    """Build a bundle at ``path`` with ``write_split(split, out_dir) ->
    meta entry`` for each split. Atomic: builds into a sibling tmp dir,
    then renames; losing the rename to a concurrent build of the same
    key is success."""
    key = os.path.basename(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    try:
        counts = {}
        for split in SPLITS:
            ts = time.time()
            counts[split] = write_split(split, tmp)
            log(f"[bundle] {split}: {counts[split]['n_videos']} videos / "
                f"{counts[split]['n_pairs']} pairs packed in "
                f"{time.time() - ts:.1f}s")
        with open(os.path.join(tmp, "vocab.json"), "w") as f:
            f.write(vocab.to_json())
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"version": BUNDLE_VERSION, "key": key,
                       "corpus": tc.corpus, "splits": counts,
                       "built_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                 time.gmtime())}, f, indent=2)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.isdir(path):          # another process finished first
            shutil.rmtree(tmp)
        else:
            try:
                os.replace(tmp, path)
            except OSError:
                # a concurrent build renamed its tmp dir between the isdir
                # check and this replace: theirs is a complete bundle for
                # the same key
                if not os.path.isdir(path):
                    raise
                shutil.rmtree(tmp, ignore_errors=True)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    return path


def _pack_in_memory(tc, path: str, vocab: Vocab,
                    splits: Mapping[str, Tuple[Mapping, Mapping]],
                    log=lambda m: print(m, file=sys.stderr)) -> str:
    """Build a bundle at ``path`` from in-memory splits ({split: (videos,
    captions)}, as ``Corpus(splits=...)`` takes them) and ``vocab``,
    through the writer ``build_bundle`` feeds from the HDF5 files: for a
    host without h5py. The same bytes as a build from files holding the
    same videos and captions."""
    sentence = T.sentence_pipeline(tc.caption_max_len)
    frame = T.frame_pipeline(tc.frame_sampling_method, tc.encoder_output_len)
    caption = T.caption_pipeline(sentence, vocab.word2idx,
                                 vocab.max_sentence_len)
    return _pack(tc, path, vocab, lambda split, out: _write_split(
        tc, split, vocab, out, *splits[split], frame, caption), log)


def build_bundle(tc, path: Optional[str] = None,
                 log=lambda m: print(m, file=sys.stderr)) -> str:
    """Build the bundle for ``tc``'s corpus into ``path`` (default: the
    keyed directory) from its raw caption and HDF5 files."""
    path = path or bundle_dir(tc)
    t0 = time.time()

    sentence = T.sentence_pipeline(tc.caption_max_len)
    frame = T.frame_pipeline(tc.frame_sampling_method, tc.encoder_output_len)

    from recnet_tpu_torch.data.corpus import load_caption_values
    vocab = Vocab(tc.init_word2idx_dict, tc.min_count)
    vocab.build(load_caption_values(tc.corpus, tc.total_caption_fpath),
                sentence)
    caption = T.caption_pipeline(sentence, vocab.word2idx,
                                 vocab.max_sentence_len)
    log(f"[bundle] vocab built in {time.time() - t0:.1f}s "
        f"({vocab.n_vocabs} words)")
    _pack(tc, path, vocab, lambda split, out: _build_split(
        tc, split, vocab, out, frame, caption), log)
    log(f"[bundle] built {path} in {time.time() - t0:.1f}s")
    return path


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------


def load_bundle(path: str) -> Bundle:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("version") != BUNDLE_VERSION:
        raise ValueError(
            f"bundle {path} has version {meta.get('version')}, "
            f"expected {BUNDLE_VERSION}")
    with open(os.path.join(path, "vocab.json")) as f:
        vocab = Vocab.from_json(f.read())
    datasets = {}
    for split in SPLITS:
        feats = np.load(os.path.join(path, f"{split}_feats.npy"),
                        mmap_mode="r")
        # the npy header cannot name bfloat16 (it reads back as the 2-byte
        # void '|V2'); meta.json records the dtype
        dtype_name = meta["splits"][split].get("feats_dtype", "float32")
        if feats.dtype != _STORE_DTYPES[dtype_name]:
            raise ValueError(
                f"bundle {path}: {split}_feats.npy holds {feats.dtype}, "
                f"meta.json says {dtype_name}")
        rows = np.load(os.path.join(path, f"{split}_rows.npy"))
        captions = np.load(os.path.join(path, f"{split}_captions.npy"))
        with open(os.path.join(path, f"{split}_vids.json")) as f:
            vids = json.load(f)
        with open(os.path.join(path, f"{split}_raw_captions.json")) as f:
            raw = json.load(f)
        datasets[split] = BundledCaptionDataset(vids, feats, rows, captions,
                                                raw)
    return Bundle(path, vocab, datasets)


def _process_index() -> int:
    """This process's rank in an initialized ``torch.distributed`` group,
    else 0."""
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def load_or_build(tc, log=lambda m: print(m, file=sys.stderr),
                  build_wait_s: float = 3600.0) -> Bundle:
    path = bundle_dir(tc)
    if not os.path.isdir(path):
        if _process_index() != 0:
            # several processes sharing data_root: only the primary packs
            # the (multi-minute) bundle; the others poll for its atomic
            # rename instead of duplicating the whole build
            log(f"[bundle] waiting for primary to build {path}")
            deadline = time.time() + build_wait_s
            while not os.path.isdir(path):
                if time.time() > deadline:
                    # the primary never produced it (crashed, or data_root
                    # is not shared storage): build here; build_bundle is
                    # atomic and concurrency-safe either way
                    log(f"[bundle] primary did not produce {path} within "
                        f"{build_wait_s:.0f}s; building locally")
                    build_bundle(tc, path, log=log)
                    break
                time.sleep(2.0)
        else:
            log(f"[bundle] no bundle at {path}; building (one-time cost)")
            build_bundle(tc, path, log=log)
    t0 = time.time()
    b = load_bundle(path)
    log(f"[bundle] loaded {path} in {time.time() - t0:.2f}s (features "
        f"mmapped)")
    return b
