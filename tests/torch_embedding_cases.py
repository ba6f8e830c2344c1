"""Token patterns for the embedding backward's tests, on the CPU
(``test_torch_embedding_backward.py``) and on the card
(``test_torch_cuda.py``, which imports no JAX): random patterns and
teacher-forced caption inputs, which ``chip_smoke.py --embedding-backward``
times the kernel on too."""

import json
from pathlib import Path

import numpy as np
import torch

PAD, SOS, EOS = 0, 1, 2
# caption lengths in words and their weights: the MSVD-like lengths of the
# benchmark's train traffic, read from its file
TRAIN_TRAFFIC = (Path(__file__).resolve().parents[1] / "h100_bench"
                 / "traffic" / "train-f32-b1024.json")
CAPTION_WORDS = {int(k): v for k, v in json.loads(
    TRAIN_TRAFFIC.read_text())["caption_words"].items()}


def tokens(pattern: str, n: int, v: int, seed: int,
           dtype=torch.int64) -> torch.Tensor:
    """(n,) tokens in [0, v) (in [-v, v) for "negative"): "traffic" 70%
    <PAD>, some <SOS> and <EOS>, words uniform over the rest; "same" one
    token; "ends" the first and last rows; "sparse" four rows of the
    table; "negative" counted from the end, as the gather reads them."""
    rng = np.random.default_rng(seed)
    if pattern == "traffic":
        tok = rng.integers(EOS + 1, v, n)
        kind = rng.random(n)
        tok[kind < 0.70] = PAD
        tok[(kind >= 0.70) & (kind < 0.74)] = SOS
        tok[(kind >= 0.74) & (kind < 0.78)] = EOS
    elif pattern == "same":
        tok = np.full(n, 3)
    elif pattern == "ends":
        tok = np.where(rng.random(n) < 0.5, 0, v - 1)
    elif pattern == "sparse":
        tok = rng.choice([1, 5, 6, v - 3], n)
    elif pattern == "negative":
        tok = rng.integers(-v, v, n)
    else:
        raise ValueError(pattern)
    return torch.from_numpy(tok).to(dtype)


def caption_inputs(seed: int, T: int, B: int, V: int) -> torch.Tensor:
    """(T, B) int64 teacher-forced inputs of CAPTION_WORDS' lengths:
    <SOS>, words uniform over [3, V), <EOS>, then <PAD>s."""
    rng = np.random.default_rng(seed)
    words = np.array(list(CAPTION_WORDS))
    p = np.array(list(CAPTION_WORDS.values()), dtype=np.float64)
    n = rng.choice(words, B, p=p / p.sum())[None, :]
    pos = np.arange(T)[:, None]
    tok = np.where(pos == 0, SOS, np.where(pos <= n, rng.integers(
        EOS + 1, V, (T, B)), np.where(pos == n + 1, EOS, PAD)))
    return torch.from_numpy(tok.astype(np.int64))
