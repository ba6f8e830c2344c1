"""Inputs and weights made from a run's ``--seed``.

Each kind of input draws from a stream of its own (``stream_seed``), so the
same seed gives the same inputs whatever else a run makes. Weights and
features are drawn on the device in a few large calls in float32, the
distributions of the reference's initialisers (PyTorch's defaults: U(+-1 /
sqrt(fan)) for every linear and recurrent weight and bias, N(0, 1) for the
embedding, ones for the attention's bias). Features are U[0, 1), as pooled
CNN features are non-negative. Caption lengths come from the traffic file's
histogram: every seed gets the same multiset of lengths a batch, in another
order.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch

PAD, SOS, EOS = 0, 1, 2


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for the named stream of a run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def _gates(cell: str, hidden: int) -> int:
    return (3 if cell == "GRU" else 4) * hidden


def _uniform_tree(spec: Dict, g: torch.Generator, device) -> Dict:
    """{path: tensor} for ``spec`` {path: (shape, bound)}: one U(-1, 1)
    draw for all of them, each leaf its slice scaled by its bound."""
    sizes = [int(np.prod(shape)) for shape, _ in spec.values()]
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0,
                                                           generator=g)
    out, at = {}, 0
    for (path, (shape, bound)), n in zip(spec.items(), sizes):
        out[path] = flat[at:at + n].view(shape) * bound
        at += n
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """{"a/b/0/c": x} -> {"a": {"b": [{"c": x}]}}: a key of digits indexes
    a list."""
    root: Dict = {}
    for path, x in flat.items():
        keys = path.split("/")
        node = root
        for key, nxt in zip(keys[:-1], keys[1:]):
            node = _slot(node, key, lambda: [] if nxt.isdigit() else {})
        _slot(node, keys[-1], lambda: x)
    return root


def _slot(node, key: str, make):
    """node[key] (a list's index when ``node`` is a list), made by ``make``
    where it is not there yet."""
    if isinstance(node, list):
        i = int(key)
        node.extend([None] * (i + 1 - len(node)))
        if node[i] is None:
            node[i] = make()
        return node[i]
    if key not in node:
        node[key] = make()
    return node[key]


def flatten(tree, prefix: str = "") -> Dict:
    """The inverse of ``nest``: {path: leaf}, dict keys sorted."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def decoder_params(c: Dict, vocab: int, seed: int, device) -> Dict:
    """The decoder's parameters in the JAX layout (input-major weights),
    float32 on ``device``."""
    H, E, F = (c["decoder_hidden_size"], c["embedding_size"],
               c["encoder_output_size"])
    A, V = c["decoder_attn_size"], vocab
    G = _gates(c["decoder_model"], H)
    if c["decoder_n_layers"] != 1:
        raise ValueError("the benchmark's decoder has one layer")
    bh = H ** -0.5
    g = generator(seed, "decoder", device)
    flat = _uniform_tree({
        "attention/U": ((F, A), F ** -0.5),
        "attention/W": ((H, A), bh),
        "attention/w": ((A, 1), A ** -0.5),
        "out_b": ((V,), bh), "out_w": ((H, V), bh),
        "rnn/0/b_hh": ((G,), bh), "rnn/0/b_ih": ((G,), bh),
        "rnn/0/w_hh": ((H, G), bh), "rnn/0/w_ih": ((E + F, G), bh),
    }, g, device)
    flat["embedding"] = torch.empty((V, E), device=device).normal_(
        generator=g)
    flat["attention/b"] = torch.ones((A,), device=device)
    return nest(flat)


def reconstructor_params(c: Dict, seed: int, device) -> Dict:
    """The reconstructor's parameters (global or local), JAX layout."""
    Hd, Hr = c["decoder_hidden_size"], c["reconstructor_hidden_size"]
    Ar = c["reconstructor_attn_size"]
    Gr = _gates(c["reconstructor_model"], Hr)
    if c["reconstructor_n_layers"] != 1:
        raise ValueError("the benchmark's reconstructor has one layer")
    local = c["reconstructor_type"] == "local"
    br = Hr ** -0.5
    spec = {"out_b": ((Hr,), br), "out_w": ((Hr, Hr), br),
            "rnn/0/b_hh": ((Gr,), br), "rnn/0/b_ih": ((Gr,), br),
            "rnn/0/w_hh": ((Hr, Gr), br),
            "rnn/0/w_ih": (((Hd if local else 2 * Hd), Gr), br)}
    if local:
        spec.update({"attention/U": ((Hd, Ar), Hd ** -0.5),
                     "attention/W": ((Hr, Ar), br),
                     "attention/w": ((Ar, 1), Ar ** -0.5)})
    flat = _uniform_tree(spec, generator(seed, "reconstructor", device),
                         device)
    if local:
        flat["attention/b"] = torch.ones((Ar,), device=device)
    return nest(flat)


def to_numpy(tree):
    """A tree of tensors as numpy arrays (the port's weight bridges take
    arrays)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def features(c: Dict, n: int, seed: int, stream: str, device,
             dtype=torch.float32) -> torch.Tensor:
    """(n, frames, width) features, U[0, 1) drawn in float32, stored in
    ``dtype``."""
    shape = (n, c["encoder_output_len"], c["encoder_output_size"])
    x = torch.empty(shape, device=device).uniform_(
        0.0, 1.0, generator=generator(seed, stream, device))
    return x.to(dtype)


def length_multiset(batch: int, weights: Dict[str, float]) -> np.ndarray:
    """``batch`` caption lengths in words, in the shares of ``weights``
    ({words: weight}), rounded by largest remainder."""
    words = np.array([int(k) for k in weights])
    w = np.array([float(v) for v in weights.values()])
    exact = w / w.sum() * batch
    counts = np.floor(exact).astype(int)
    short = batch - counts.sum()
    counts[np.argsort(-(exact - counts), kind="stable")[:short]] += 1
    return np.repeat(words, counts)


def train_batches(c: Dict, vocab: int, traffic: Dict, seed: int,
                  n_calls: int) -> Tuple[np.ndarray, np.ndarray]:
    """(rows (n_calls, k, B) into the feature cache, captions (n_calls, k,
    T, B)): each batch B distinct videos and B captions of the traffic's
    lengths (words uniform over the vocabulary past the special tokens,
    then <EOS>, then <PAD>)."""
    k, B = traffic["steps_per_call"], traffic["batch_size"]
    T, N = c["caption_max_len"] + 1, traffic["videos"]
    lengths = length_multiset(B, traffic["caption_words"])
    if lengths.max() >= T:
        raise ValueError(f"a caption of {lengths.max()} words leaves no "
                         f"room for <EOS> in {T} steps")
    rng = np.random.default_rng(stream_seed(seed, "captions"))
    rows = np.empty((n_calls, k, B), np.int64)
    caps = np.empty((n_calls, k, T, B), np.int64)
    pos = np.arange(T)[:, None]
    for i in range(n_calls):
        for j in range(k):
            rows[i, j] = rng.choice(N, B, replace=False)
            n_words = rng.permutation(lengths)[None, :]
            words = rng.integers(EOS + 1, vocab, size=(T, B))
            caps[i, j] = np.where(pos < n_words, words,
                                  np.where(pos == n_words, EOS, PAD))
    return rows, caps
