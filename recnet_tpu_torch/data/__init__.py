"""Vocab, frame and text transforms, datasets, batchers and the corpus:
copies of ``recnet_tpu.data`` under the same module names, with the
device prefetch in PyTorch."""

from recnet_tpu_torch.data.batcher import Batcher, cycle, prefetch_to_device
from recnet_tpu_torch.data.corpus import Corpus, ScoreBatcher
from recnet_tpu_torch.data.vocab import Vocab

__all__ = ["Batcher", "Corpus", "ScoreBatcher", "Vocab", "cycle",
           "prefetch_to_device"]
