"""Corpus BLEU-1..4 — Python 3 reimplementation of the vendored scorer
(a copy of ``recnet_tpu/metrics/bleu.py``, with its C++ fast path through
``recnet_tpu_torch.native``).

Matches reference coco_caption/pycocoevalcap/bleu/bleu_scorer.py semantics:
'closest' effective reference length (bleu_scorer.py:71), the tiny=1e-15 /
small=1e-9 smoothing constants and the brevity penalty applied both per-image
and corpus-level (bleu_scorer.py:198-263). The Bleu wrapper calls with
option='closest' (bleu/bleu.py:40).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List

from recnet_tpu_torch import native


def _ngram_counts(words: List[str], n: int = 4) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


def _cook_refs(refs: List[str], n: int = 4):
    reflen = []
    maxcounts: Dict[tuple, int] = {}
    for ref in refs:
        words = ref.split()
        reflen.append(len(words))
        for ngram, cnt in _ngram_counts(words, n).items():
            maxcounts[ngram] = max(maxcounts.get(ngram, 0), cnt)
    return reflen, maxcounts


def _image_stats(hyp: str, refs, n: int = 4):
    """Per-image sufficient statistics; C++ fast path when built."""
    if native.has("bleu_stats"):
        table = {}
        intern = lambda ws: [table.setdefault(w, len(table)) for w in ws]
        hyp_ids = intern(hyp.split())
        ref_ids = [intern(r.split()) for r in refs]
        testlen, reflen, guess, correct = native.fastmetrics.bleu_stats(
            hyp_ids, ref_ids, n)
        return {"testlen": testlen, "reflen": reflen,
                "guess": guess, "correct": correct}
    reflen, maxcounts = _cook_refs(refs, n)
    return _cook_test(hyp, reflen, maxcounts, n)


def _cook_test(test: str, reflen, refmaxcounts, n: int = 4):
    words = test.split()
    testlen = len(words)
    counts = _ngram_counts(words, n)
    # 'closest' reflen: min |l - testlen|, ties to the smaller l
    # (bleu_scorer.py:71 — min over (abs_diff, l) tuples)
    closest = min((abs(l - testlen), l) for l in reflen)[1]
    guess = [max(0, testlen - k + 1) for k in range(1, n + 1)]
    correct = [0] * n
    for ngram, cnt in counts.items():
        correct[len(ngram) - 1] += min(refmaxcounts.get(ngram, 0), cnt)
    return {"testlen": testlen, "reflen": closest,
            "guess": guess, "correct": correct}


class Bleu:
    """compute_score(gts, res) -> (corpus [B1..B4], per-image [[...]×4])."""

    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(self, gts: Dict[str, List[str]],
                      res: Dict[str, List[str]]):
        assert gts.keys() == res.keys()
        n = self.n
        small, tiny = 1e-9, 1e-15
        comps_list = []
        for iid in gts:
            assert len(res[iid]) == 1
            comps_list.append(_image_stats(res[iid][0], gts[iid], n))

        bleu_list: List[List[float]] = [[] for _ in range(n)]
        total_testlen = 0
        total_reflen = 0
        totals = {"guess": [0] * n, "correct": [0] * n}
        for comps in comps_list:
            testlen = comps["testlen"]
            reflen = comps["reflen"]
            total_testlen += testlen
            total_reflen += reflen
            for key in ("guess", "correct"):
                for k in range(n):
                    totals[key][k] += comps[key][k]
            bleu = 1.0
            for k in range(n):
                bleu *= (comps["correct"][k] + tiny) / (comps["guess"][k] + small)
                bleu_list[k].append(bleu ** (1.0 / (k + 1)))
            ratio = (testlen + tiny) / (reflen + small)
            if ratio < 1:
                for k in range(n):
                    bleu_list[k][-1] *= math.exp(1 - 1 / ratio)

        bleus = []
        bleu = 1.0
        for k in range(n):
            bleu *= (totals["correct"][k] + tiny) / (totals["guess"][k] + small)
            bleus.append(bleu ** (1.0 / (k + 1)))
        ratio = (total_testlen + tiny) / (total_reflen + small)
        if ratio < 1:
            for k in range(n):
                bleus[k] *= math.exp(1 - 1 / ratio)
        return bleus, bleu_list

    def method(self) -> str:
        return "Bleu"
