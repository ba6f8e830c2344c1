"""ROUGE-L — Python 3 reimplementation of the vendored scorer
(a copy of ``recnet_tpu/metrics/rouge.py``'s pure-Python path).

Matches reference coco_caption/pycocoevalcap/rouge/rouge.py: LCS DP (:13-34),
F-beta with beta=1.2 and max precision/recall over references (:45-75).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def lcs_length(a: List[str], b: List[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[len(b)]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        assert len(candidate) == 1
        assert len(refs) > 0
        token_c = candidate[0].split(" ")
        prec, rec = [], []
        for reference in refs:
            token_r = reference.split(" ")
            lcs = lcs_length(token_r, token_c)
            prec.append(lcs / float(len(token_c)))
            rec.append(lcs / float(len(token_r)))
        prec_max, rec_max = max(prec), max(rec)
        if prec_max != 0 and rec_max != 0:
            return ((1 + self.beta ** 2) * prec_max * rec_max /
                    float(rec_max + self.beta ** 2 * prec_max))
        return 0.0

    def compute_score(self, gts: Dict[str, List[str]],
                      res: Dict[str, List[str]]):
        assert gts.keys() == res.keys()
        scores = [self.calc_score(res[iid], gts[iid]) for iid in gts]
        return float(np.mean(scores)), np.asarray(scores)

    def method(self) -> str:
        return "Rouge"
