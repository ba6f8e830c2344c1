"""Vocab, frame and text transforms, datasets and the evaluation corpus:
copies of the jax-free parts of ``recnet_tpu.data`` that the port reads,
under the same module names."""

from recnet_tpu_torch.data.corpus import Corpus, ScoreBatcher
from recnet_tpu_torch.data.vocab import Vocab

__all__ = ["Corpus", "ScoreBatcher", "Vocab"]
