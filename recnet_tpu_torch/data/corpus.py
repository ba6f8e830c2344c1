"""Corpus facade: vocab, per-split datasets and batchers.

A copy of ``recnet_tpu.data.Corpus`` (reference: dataset/MSVD.py:17-162):
``vocab``, ``train_dataset`` / ``train_batcher`` and ``val_dataset`` /
``val_batcher`` for training (``index_mode`` under the device feature
cache, with the same shuffle stream), ``test_dataset``
(``video_caption_pairs``) and ``score_batcher``, an iterable of
(vids, videos (B, L, F) float32) batches in HDF5 key order, the last one
padded by repeating its last video under the vid "PAD", as the JAX
``Batcher`` gives with ``shuffle=False``.

The data comes from the raw CSV/JSON and HDF5 files, or from memory
(``splits``). The JAX package's preprocessed data bundle is not ported
(ROADMAP Queue 1, item 8): a config that asks for it to train raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

from recnet_tpu_torch.config import TrainConfig
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
    the files; ``vocab`` is then required.
    """

    def __init__(self, config: TrainConfig, vocab: Optional[Vocab] = None,
                 splits: Optional[Mapping[str, Split]] = None):
        self.C = config
        self._splits = splits
        wants_training = (config.build_train_data_loader
                          or config.build_val_data_loader)
        if getattr(config, "data_bundle", False) and wants_training:
            raise NotImplementedError(
                "data_bundle=True: the preprocessed data bundle is not "
                "ported yet (ROADMAP Queue 1, item 8, data preparation); "
                "set data_bundle to false to read the raw files")
        if splits is not None and vocab is None:
            raise ValueError("an in-memory corpus needs its vocab")
        rng = np.random.default_rng(config.seed)
        self.transform_sentence = T.sentence_pipeline(config.caption_max_len)
        self.transform_frame = T.frame_pipeline(
            config.frame_sampling_method, config.encoder_output_len, rng)
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
            # the test split's in-RAM videos when both are built
            videos = (self.test_dataset.videos
                      if self.test_dataset is not None
                      else self._split("test")[0])
            self.score_dataset = D.ScoreDataset(videos, self.transform_frame)
            self.score_batcher = ScoreBatcher(self.score_dataset,
                                              config.batch_size)

    def _split(self, split: str) -> Split:
        if self._splits is not None:
            return self._splits[split]
        return (D.load_videos_hdf5(self.C.video_fpath(split)),
                self._load_captions(self.C.caption_fpath(split)))

    def _dataset(self, split: str) -> D.CaptionDataset:
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
        vocab = Vocab(self.C.init_word2idx_dict, self.C.min_count)
        vocab.build(load_caption_values(self.C.corpus,
                                        self.C.total_caption_fpath),
                    self.transform_sentence)
        return vocab
