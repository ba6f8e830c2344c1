"""CIDEr — Python 3 reimplementation of the vendored scorer
(a copy of ``recnet_tpu/metrics/cider.py``'s pure-Python path).

Matches reference coco_caption/pycocoevalcap/cider/cider_scorer.py: document
frequency over reference sets (:93-104), tf·idf vectors with
ref_len = log(#images) (:107-131,162), clipped cosine similarity with a
gaussian length penalty sigma=6 (:133-159), mean over 1..4-grams ×10 divided
by #refs (:162-181).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List

import numpy as np


def _ngram_counts(s: str, n: int = 4) -> Dict[tuple, int]:
    words = tuple(s.split())          # tuple-slice below yields the key directly
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[words[i:i + k]] += 1
    return counts


class Cider:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute_score(self, gts: Dict[str, List[str]],
                      res: Dict[str, List[str]]):
        assert gts.keys() == res.keys()
        ids = list(gts.keys())
        crefs = [[_ngram_counts(r, self.n) for r in gts[iid]] for iid in ids]
        ctest = [_ngram_counts(res[iid][0], self.n) for iid in ids]

        # document frequency over ref sets (cider_scorer.py:93-104)
        document_frequency: Dict[tuple, float] = defaultdict(float)
        for refs in crefs:
            for ngram in set().union(*refs):
                document_frequency[ngram] += 1

        ref_len = float(np.log(float(len(crefs))))   # cider_scorer.py:162

        # log-df per DISTINCT ngram, hoisted (profiled: recomputing
        # np.log(df) per occurrence was ~half the MSR-VTT-scale scoring
        # cost). np.log kept — not math.log — for bit-parity with the
        # vendored scorer's ufunc; float() casts only strip the np-scalar
        # dispatch overhead, the IEEE value is unchanged. Unseen test
        # ngrams: max(1, 0) → log 0.0.
        df_log = {ng: float(np.log(max(1.0, df)))
                  for ng, df in document_frequency.items()}

        def counts2vec(cnts):
            vec = [{} for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            get_df = df_log.get
            for ngram, tf in cnts.items():
                k = len(ngram) - 1
                v = float(tf) * (ref_len - get_df(ngram, 0.0))
                vec[k][ngram] = v
                norm[k] += v * v
                if k == 1:                        # quirk: bigram count as length
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vh, vr, nh, nr, lh, lr):
            delta = float(lh - lr)
            # identical per-k factor hoisted (same expression, same bits)
            penalty = math.e ** (-(delta ** 2) / (2 * self.sigma ** 2))
            val = [0.0] * self.n
            for k in range(self.n):
                s = 0.0
                vrk_get = vr[k].get
                for ngram, vhv in vh[k].items():
                    # clipped tf-idf product (cider_scorer.py:151); missing
                    # ref ngrams contribute exactly 0 (tf-idf values are
                    # >= 0 since df <= #images), so skipping them is exact
                    vrv = vrk_get(ngram)
                    if vrv is not None:
                        s += min(vhv, vrv) * vrv
                if nh[k] != 0 and nr[k] != 0:
                    s /= nh[k] * nr[k]
                val[k] = s * penalty
            return val

        scores = []
        n_range = range(self.n)
        for test, refs in zip(ctest, crefs):
            vec, norm, length = counts2vec(test)
            score = [0.0] * self.n
            for ref in refs:
                vr, nr, lr = counts2vec(ref)
                v = sim(vec, vr, norm, nr, length, lr)
                for k in n_range:
                    score[k] += v[k]
            scores.append(float(np.mean(score) / len(refs) * 10.0))
        return float(np.mean(scores)), np.asarray(scores)

    def method(self) -> str:
        return "CIDEr"
