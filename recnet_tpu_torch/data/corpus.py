"""The evaluation corpus: vocab, the test captions and the score batches.

A copy of what ``recnet_tpu.data.Corpus`` gives evaluation and the eval
CLI, and nothing of its training side: ``vocab``, ``test_dataset``
(``video_caption_pairs``) and ``score_batcher``, an iterable of
(vids, videos (B, L, F) float32) batches in HDF5 key order, the last one
padded to the batch size by repeating its last video under the vid "PAD"
(reference: dataset/MSVD.py:57-61,80-84), as the JAX ``Batcher`` gives
with ``shuffle=False``. The train and val loaders, the device prefetch,
the device feature cache and the data bundle are training paths and are
not copied; the port reads the raw CSV/JSON and HDF5 files.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.data import datasets as D
from recnet_tpu_torch.data import transforms as T
from recnet_tpu_torch.data.vocab import Vocab


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
    """Vocab, the test split's captions and the score batches of a
    TrainConfig's corpus. ``vocab`` defaults to one built from the whole
    caption file with the run's min_count, as the JAX ``Corpus`` builds it.
    """

    def __init__(self, config: TrainConfig, vocab: Optional[Vocab] = None):
        self.C = config
        rng = np.random.default_rng(config.seed)
        self.transform_sentence = T.sentence_pipeline(config.caption_max_len)
        self.transform_frame = T.frame_pipeline(
            config.frame_sampling_method, config.encoder_output_len, rng)
        self.vocab = vocab if vocab is not None else self.build_vocab()

        self.test_dataset = self.score_dataset = self.score_batcher = None
        if config.build_test_data_loader:
            self.test_dataset = D.CaptionDataset(
                D.load_videos_hdf5(config.video_fpath("test")),
                self._load_captions(config.caption_fpath("test")))
        if config.build_score_data_loader:
            # the test split's in-RAM videos when both are built
            videos = (self.test_dataset.videos
                      if self.test_dataset is not None
                      else D.load_videos_hdf5(config.video_fpath("test")))
            self.score_dataset = D.ScoreDataset(videos, self.transform_frame)
            self.score_batcher = ScoreBatcher(self.score_dataset,
                                              config.batch_size)

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
