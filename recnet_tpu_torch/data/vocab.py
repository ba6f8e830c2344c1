"""Vocabulary built from caption CSVs, reproducible & serializable (a copy
of ``recnet_tpu/data/vocab.py``).

Matches reference dataset/MSVD.py:166-206 (min-count trimming, init tokens
<PAD>=0/<SOS>=1/<EOS>=2, max_sentence_len tracking) with two deliberate fixes:

* insertion-order-deterministic word ids (the reference's Python-2 dict
  iteration order was hash-dependent);
* the vocab is a first-class serialized artifact (to_json/from_json) so
  checkpoints carry it instead of re-deriving it from the corpus CSV at eval
  time (the fragility noted at reference eval.py:185).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Callable, Dict, Iterable, List


class Vocab:
    def __init__(self, init_word2idx: Dict[str, int], min_count: int = 1):
        self.min_count = min_count
        self.word2idx: Dict[str, int] = dict(init_word2idx)
        self.idx2word: Dict[int, str] = {v: k for k, v in self.word2idx.items()}
        self.word_freq_dict: Dict[str, int] = defaultdict(int)
        self.n_vocabs = len(self.word2idx)
        self.n_words = self.n_vocabs
        self.n_vocabs_untrimmed = 0
        self.n_words_untrimmed = 0
        self.max_sentence_len = -1

    def build(self, captions: Iterable[str],
              transform: Callable[[str], List[str]]) -> "Vocab":
        """Count frequencies, then keep words with freq >= min_count
        (reference: dataset/MSVD.py:190-206)."""
        for caption in captions:
            words = transform(caption)
            self.max_sentence_len = max(self.max_sentence_len, len(words))
            for w in words:
                self.word_freq_dict[w] += 1
        self.n_vocabs_untrimmed = len(self.word_freq_dict)
        self.n_words_untrimmed = sum(self.word_freq_dict.values())

        keep = [w for w, f in self.word_freq_dict.items() if f >= self.min_count]
        for idx, w in enumerate(keep, len(self.word2idx)):
            self.word2idx[w] = idx
            self.idx2word[idx] = w
        self.n_vocabs = len(self.word2idx)
        self.n_words = sum(self.word_freq_dict[w] for w in keep)
        return self

    # ---- serialization (new capability vs reference) ----

    def to_dict(self) -> dict:
        return {
            "min_count": self.min_count,
            "word2idx": self.word2idx,
            "max_sentence_len": self.max_sentence_len,
            "n_vocabs_untrimmed": self.n_vocabs_untrimmed,
            "n_words_untrimmed": self.n_words_untrimmed,
            "n_words": self.n_words,
            "word_freq": dict(self.word_freq_dict),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "Vocab":
        v = cls.__new__(cls)
        v.min_count = d["min_count"]
        v.word2idx = dict(d["word2idx"])
        v.idx2word = {int(i): w for w, i in v.word2idx.items()}
        v.word_freq_dict = defaultdict(int, d.get("word_freq", {}))
        v.max_sentence_len = d["max_sentence_len"]
        v.n_vocabs = len(v.word2idx)
        v.n_vocabs_untrimmed = d.get("n_vocabs_untrimmed", 0)
        v.n_words_untrimmed = d.get("n_words_untrimmed", 0)
        v.n_words = d.get("n_words", v.n_vocabs)
        return v

    @classmethod
    def from_json(cls, s: str) -> "Vocab":
        return cls.from_dict(json.loads(s))

    def __len__(self) -> int:
        return self.n_vocabs
