"""Frame and text transforms — pure NumPy/Python, semantics-matched (a
copy of ``recnet_tpu/data/transforms.py``).

Mirrors reference dataset/transform.py exactly, including the
``int(np.linspace(...))`` truncation of uniform sampling indices (:18), the
jitter std formula ``int(sqrt(n/n_sample/4))`` (:46), zero-padding short clips
to a fixed frame count (:56-63), and the text pipeline's silent OOV drop
(:138-143). Composition replaces torchvision.transforms.Compose.
"""

from __future__ import annotations

import math
import re
import string
from typing import Callable, Dict, List, Sequence

import numpy as np


class Compose:
    def __init__(self, fns: Sequence[Callable]):
        self.fns = list(fns)

    def __call__(self, x):
        for fn in self.fns:
            x = fn(x)
        return x


# ---------------- frame transforms (reference: transform.py:9-75) -----------


class UniformSample:
    """linspace(0, n-1, k) with int() truncation (transform.py:9-20)."""

    def __init__(self, n_sample: int):
        self.n_sample = n_sample

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames)
        n = len(frames)
        if n < self.n_sample:
            return frames
        idx = np.linspace(0, n - 1, self.n_sample).astype(np.int64)
        return frames[idx]


class RandomSample:
    """sorted choice without replacement (transform.py:23-34)."""

    def __init__(self, n_sample: int, rng: np.random.Generator | None = None):
        self.n_sample = n_sample
        self.rng = rng or np.random.default_rng()

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames)
        n = len(frames)
        if n < self.n_sample:
            return frames
        idx = np.sort(self.rng.choice(n, self.n_sample, replace=False))
        return frames[idx]


class UniformJitterSample:
    """linspace + gaussian jitter, clamped & re-sorted (transform.py:37-53)."""

    def __init__(self, n_sample: int, rng: np.random.Generator | None = None):
        self.n_sample = n_sample
        self.rng = rng or np.random.default_rng()

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames)
        n = len(frames)
        if n < self.n_sample:
            return frames
        jitter_std = int(math.sqrt(n / self.n_sample / 2 / 2))
        base = np.linspace(0, n - 1, self.n_sample).astype(np.int64)
        jit = (base + self.rng.normal(0, jitter_std, self.n_sample)).astype(np.int64)
        jit = np.clip(jit, 0, n - 1)
        return frames[np.sort(jit)]


class ZeroPadIfLessThan:
    """Append zero frames up to length n (transform.py:56-63)."""

    def __init__(self, n: int):
        self.n = n

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames)
        if len(frames) >= self.n:
            return frames
        pad = np.zeros((self.n - len(frames),) + frames.shape[1:], frames.dtype)
        return np.concatenate([frames, pad], axis=0)


class AsArray:
    """ToTensor equivalent (transform.py:66-75) — dtype-cast ndarray."""

    def __init__(self, dtype=np.float32):
        self.dtype = dtype

    def __call__(self, x) -> np.ndarray:
        return np.asarray(x, dtype=self.dtype)


# ---------------- text transforms (reference: transform.py:78-143) ----------


class TrimExceptAscii:
    """Drop non-ascii characters (transform.py:78-81)."""

    def __call__(self, sentence: str) -> str:
        return sentence.encode("ascii", "ignore").decode("ascii")


class RemovePunctuation:
    """Strip string.punctuation (transform.py:84-89)."""

    def __init__(self):
        self.regex = re.compile("[%s]" % re.escape(string.punctuation))

    def __call__(self, sentence: str) -> str:
        return self.regex.sub("", sentence)


class Lowercase:
    def __call__(self, sentence: str) -> str:
        return sentence.lower()


class SplitWithWhiteSpace:
    def __call__(self, sentence: str) -> List[str]:
        return sentence.split()


class Truncate:
    def __init__(self, n_word: int):
        self.n_word = n_word

    def __call__(self, words: List[str]) -> List[str]:
        return words[: self.n_word]


class PadFirst:
    def __init__(self, token):
        self.token = token

    def __call__(self, words: list) -> list:
        return [self.token] + words


class PadLast:
    """Append <EOS> (transform.py:120-125)."""

    def __init__(self, token):
        self.token = token

    def __call__(self, words: list) -> list:
        return words + [self.token]


class PadToLength:
    """Right-pad with <PAD> to fixed length (transform.py:128-135)."""

    def __init__(self, token, length: int):
        self.token = token
        self.length = length

    def __call__(self, words: list) -> list:
        return words + [self.token] * (self.length - len(words))


class ToIndex:
    """Word→idx; silently drops OOV/trimmed words (transform.py:138-143)."""

    def __init__(self, word2idx: Dict[str, int]):
        self.word2idx = word2idx

    def __call__(self, words: List[str]) -> List[int]:
        return [self.word2idx[w] for w in words if w in self.word2idx]


def sentence_pipeline(caption_max_len: int) -> Compose:
    """The shared sentence normalizer (reference: dataset/MSVD.py:32-38)."""
    return Compose([
        TrimExceptAscii(),
        RemovePunctuation(),
        Lowercase(),
        SplitWithWhiteSpace(),
        Truncate(caption_max_len),
    ])


def frame_pipeline(method: str, n_frames: int,
                   rng: np.random.Generator | None = None) -> Compose:
    """Frame sampler + pad + cast (reference: dataset/MSVD.py:96-110)."""
    if method == "uniform":
        sample = UniformSample(n_frames)
    elif method == "random":
        sample = RandomSample(n_frames, rng)
    elif method == "uniform_jitter":
        sample = UniformJitterSample(n_frames, rng)
    else:
        raise NotImplementedError(f"Unknown frame sampling method: {method}")
    return Compose([sample, ZeroPadIfLessThan(n_frames), AsArray(np.float32)])


def caption_pipeline(sentence: Compose, word2idx: Dict[str, int],
                     max_sentence_len: int) -> Compose:
    """words → padded index vector (reference: dataset/MSVD.py:111-117)."""
    return Compose([
        sentence,
        ToIndex(word2idx),
        PadLast(word2idx["<EOS>"]),
        PadToLength(word2idx["<PAD>"], max_sentence_len + 1),
        AsArray(np.int32),
    ])
