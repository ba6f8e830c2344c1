"""Corpus facade: vocab, per-split datasets and batchers.

A copy of ``recnet_tpu.data.Corpus`` (reference: dataset/MSVD.py:17-162):
``vocab``, ``train_dataset`` / ``train_batcher`` and ``val_dataset`` /
``val_batcher`` for training (``index_mode`` under the device feature
cache, with the same shuffle stream), ``test_dataset``
(``video_caption_pairs``) and ``score_batcher``, an iterable of
(vids, videos (B, L, F) float32) batches in HDF5 key order, the last one
padded by repeating its last video under the vid "PAD", as the JAX
``Batcher`` gives with ``shuffle=False``.

The data comes from the raw CSV/JSON and HDF5 files, from memory
(``splits``), or, with ``config.data_bundle``, from the preprocessed corpus
bundle (``data/bundle.py``), built at first use: the same batches, with
the frame pipeline already applied and the features memory-mapped. Where an
input file the bundle's key reads is missing (a host that holds only the
test split), the corpus says so and reads the raw files of the splits it
was asked for. ``score_batches_device`` uploads the score split to a device
once, for the periodic test passes.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.data import bundle as B
from recnet_tpu_torch.data import datasets as D
from recnet_tpu_torch.data import transforms as T
from recnet_tpu_torch.data.batcher import Batcher
from recnet_tpu_torch.data.vocab import Vocab

# one split held in memory: {vid: features (frames, feat)} and
# {vid: [caption, ...]}
Split = Tuple[Dict[str, np.ndarray], Dict[str, List[str]]]


def load_caption_values(corpus: str, fpath: str) -> List[str]:
    """Every caption string of a caption file, for building the vocab."""
    if corpus == "MSVD":
        return D.load_msvd_caption_values(fpath)
    elif corpus == "MSR-VTT":
        return D.load_msrvtt_caption_values(fpath)
    raise NotImplementedError(f"Unknown corpus: {corpus}")


def build_vocab_from_captions(tc: TrainConfig, caption_fpath: str) -> Vocab:
    """The vocab rebuilt deterministically from a full caption file with
    the run's min_count and pipeline — the reference's own eval route
    (reference eval.py:185)."""
    vocab = Vocab(tc.init_word2idx_dict, tc.min_count)
    vocab.build(load_caption_values(tc.corpus, caption_fpath),
                T.sentence_pipeline(tc.caption_max_len))
    return vocab


class ScoreBatcher:
    """A ``ScoreDataset`` in fixed-size batches, in order; a short last
    batch repeats its last video under the vid "PAD"."""

    def __init__(self, dataset: D.ScoreDataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator:
        for start in range(0, len(self.dataset), self.batch_size):
            items = [self.dataset.get(i) for i in range(
                start, min(start + self.batch_size, len(self.dataset)))]
            pad_len = self.batch_size - len(items)
            vids = [it[0] for it in items] + ["PAD"] * pad_len
            items += [items[-1]] * pad_len
            yield vids, np.stack([np.asarray(it[1], np.float32)
                                  for it in items])


class Corpus:
    """Vocab, datasets and batchers of a TrainConfig's corpus, for the
    loaders the config asks for (``build_*_data_loader``).

    ``vocab`` defaults to one built from the whole caption file with the
    run's min_count, as the JAX ``Corpus`` builds it. ``splits`` maps
    "train" / "val" / "test" to in-memory (videos, captions) in place of
    the files; ``vocab`` is then required. ``bundle`` is the directory of
    a bundle built elsewhere, read in place of the one
    ``config.data_bundle`` would address by its key (which stats the raw
    files): for a host that holds the bundle and not the raw files.
    """

    def __init__(self, config: TrainConfig, vocab: Optional[Vocab] = None,
                 splits: Optional[Mapping[str, Split]] = None,
                 bundle: Optional[str] = None):
        self.C = config
        self._splits = splits
        if splits is not None and vocab is None:
            raise ValueError("an in-memory corpus needs its vocab")
        if splits is not None and (bundle or config.data_bundle):
            raise ValueError("an in-memory corpus has no data bundle")
        rng = np.random.default_rng(config.seed)
        self.transform_sentence = T.sentence_pipeline(config.caption_max_len)
        self.transform_frame = T.frame_pipeline(
            config.frame_sampling_method, config.encoder_output_len, rng)

        # the preprocessed corpus bundle: every dataset below comes from
        # the packed files instead of the raw CSV/HDF5, batch for batch the
        # same, but the start is an mmap, not a rebuild
        self._bundle = None
        if bundle or getattr(config, "data_bundle", False):
            try:
                self._bundle = (B.load_bundle(bundle) if bundle
                                else B.load_or_build(config))
            except FileNotFoundError as e:
                if bundle:
                    raise
                # the key stats every split's input files: a host that
                # holds only the test split cannot address a bundle, so it
                # reads the raw files of the splits it was asked for
                print(f"[bundle] input file missing ({e}); falling back "
                      "to raw CSV/HDF5 loading", file=sys.stderr)
            if self._bundle is not None:
                if (vocab is not None
                        and vocab.word2idx != self._bundle.vocab.word2idx):
                    raise ValueError(
                        "explicit vocab does not match the bundle's vocab "
                        f"({len(vocab.word2idx)} vs "
                        f"{len(self._bundle.vocab.word2idx)} words); the "
                        "bundle was built for different preprocessing "
                        "inputs")
                vocab = self._bundle.vocab
        self.vocab = vocab if vocab is not None else self.build_vocab()
        self.transform_caption = T.caption_pipeline(
            self.transform_sentence, self.vocab.word2idx,
            self.vocab.max_sentence_len)

        self.train_dataset = self.val_dataset = self.test_dataset = None
        self.train_batcher = self.val_batcher = None
        self.score_dataset = self.score_batcher = None
        # index_mode keeps the same shuffle stream, so cached and uncached
        # runs see the same batches
        index_mode = bool(getattr(config, "device_feature_cache", False))
        if config.build_train_data_loader:
            self.train_dataset = self._dataset("train")
            self.train_batcher = self._batcher(self.train_dataset, index_mode)
        if config.build_val_data_loader:
            self.val_dataset = self._dataset("val")
            self.val_batcher = self._batcher(self.val_dataset, index_mode)
        if config.build_test_data_loader:
            self.test_dataset = self._dataset("test")
        if config.build_score_data_loader:
            if self._bundle is not None:
                # packed test features are frame-transformed already
                self.score_dataset = self._bundle.score_dataset()
            else:
                # the test split's in-RAM videos when both are built
                videos = (self.test_dataset.videos
                          if self.test_dataset is not None
                          else self._split("test")[0])
                self.score_dataset = D.ScoreDataset(videos,
                                                    self.transform_frame)
            self.score_batcher = ScoreBatcher(self.score_dataset,
                                              config.batch_size)
        self._score_batches_dev: Dict[torch.device, list] = {}
        # how many times the score split went to a device
        self.score_uploads = 0

    def score_batches_device(self, device="cuda") -> list:
        """The score batches with their videos as float32 tensors on
        ``device``, uploaded at the first call for that device and reused
        by every later one (the periodic test passes of the loop). Valid
        because the score batches come in a fixed order and uniform frame
        sampling is deterministic: callers check frame_sampling_method.
        Float32 whatever ``feature_cache_dtype`` says: eval decodes these
        directly, and scores must not move with a cache knob."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # "cuda" and "cuda:0" name one card: key the copy by its index
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._score_batches_dev:
            self._score_batches_dev[device] = [
                (vids, torch.from_numpy(videos).to(device))
                for vids, videos in self.score_batcher]
            self.score_uploads += 1
        return self._score_batches_dev[device]

    def _split(self, split: str) -> Split:
        if self._splits is not None:
            return self._splits[split]
        return (D.load_videos_hdf5(self.C.video_fpath(split)),
                self._load_captions(self.C.caption_fpath(split)))

    def _dataset(self, split: str):
        if self._bundle is not None:
            return self._bundle.datasets[split]
        videos, captions = self._split(split)
        return D.CaptionDataset(videos, captions,
                                transform_frame=self.transform_frame,
                                transform_caption=self.transform_caption)

    def _batcher(self, dataset, index_mode: bool) -> Batcher:
        return Batcher(dataset, self.C.batch_size, shuffle=self.C.shuffle,
                       seed=self.C.seed, has_captions=True,
                       index_mode=index_mode)

    def _load_captions(self, fpath: str):
        if self.C.corpus == "MSVD":
            return D.load_msvd_captions(fpath)
        elif self.C.corpus == "MSR-VTT":
            return D.load_msrvtt_captions(fpath)
        raise NotImplementedError(f"Unknown corpus: {self.C.corpus}")

    def build_vocab(self) -> Vocab:
        return build_vocab_from_captions(self.C, self.C.total_caption_fpath)
