"""METEOR — pure-Python reimplementation (no JVM / meteor-1.5.jar).

Replaces the reference's long-lived Java subprocess + stdio line protocol
(reference: coco_caption/pycocoevalcap/meteor/meteor.py:17-46) with an
in-process scorer. Two formulations are provided:

``version="2007"`` (default) — the classic, unambiguously documented
formulation (Lavie & Agarwal 2007, as also used by NLTK/HF
reimplementations):

    Fmean   = P·R / (alpha·P + (1-alpha)·R),  alpha = 0.9
    Penalty = gamma · (chunks/matches)^beta,  gamma = 0.5, beta = 3
    score   = Fmean · (1 - Penalty)

with match modules exact (weight 1.0) and Porter-stem (weight 0.6).

``version="1.5"`` (opt-in) — the METEOR-1.5 *parameterization* the jar uses
for English (Denkowski & Lavie 2014, "Meteor Universal"): alpha=0.85,
beta=0.2, gamma=0.6, plus delta=0.75 content/function-word weighting.
Precision and recall weight each matched (and each total) word by whether
it is a content word (delta) or a function word (1-delta):

    P    = Σ_i w_i·(δ·m_i(h_c) + (1−δ)·m_i(h_f)) / (δ·|h_c| + (1−δ)·|h_f|)
    R    = Σ_i w_i·(δ·m_i(r_c) + (1−δ)·m_i(r_f)) / (δ·|r_c| + (1−δ)·|r_f|)
    Fmean = P·R / (α·P + (1−α)·R)
    Pen  = γ·(chunks/m)^β,  m = matched words (averaged over hyp/ref)
    score = (1 − Pen)·Fmean

with match modules exact (1.0) and stem (0.6). The jar's remaining two
modules — WordNet synonymy (0.8) and the paraphrase table (0.6) — are
ABSENT here (no WordNet corpus / paraphrase data ships with this package),
and the embedded English function-word list is a curated closed-class list
rather than the jar's corpus-frequency-derived one (rel. freq > 1e-3).
Jar-scored numbers (e.g. the reference README's METEOR 27.2/27.3) sit
systematically HIGHER than this mode because synonym/paraphrase matches
raise P and R; 1.5-mode scores are comparable between runs of this
implementation and closer in scale to jar numbers than 2007-mode, but
still not equal to them.

Documented deltas vs the jar (accepted; the jar is not shippable without a
JVM): no WordNet synonym / paraphrase-table modules; Porter-with-Snowball-1c
instead of full Snowball stemming; greedy closest-occurrence alignment
instead of the jar's beam-search alignment. **Scores are therefore NOT
numerically comparable to jar-based published numbers** in either mode;
compare METEOR only between runs of this implementation. CaptionScorer
prints a one-time warning to that effect.

Measured accuracy (tests/test_metrics.py::test_meteor_matches_nltk_*): with
the stem weight set to NLTK's unweighted 1.0, segment scores agree with
NLTK 3.10's independent 2007-formulation implementation EXACTLY (delta 0.0)
on caption pairs whose maximal alignment is unique. On pairs with
duplicate-word alignment ambiguity the two diverge (mean |delta| 0.045 over
the 15-pair suite) because NLTK matches the last occurrence while this
implementation picks the closest occurrence — the 2007 paper specifies
choosing the maximal matching with the FEWEST CHUNKS, which closest-occurrence
satisfies on these cases and NLTK does not (verified by hand-computed
golden values in test_meteor_duplicate_alignment_follows_spec).

Corpus score aggregates sufficient statistics over segments (as the jar's
EVAL phase does), not a mean of segment scores.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from recnet_tpu_torch.metrics.stemmer import porter_stem

ALPHA = 0.9
BETA = 3.0
GAMMA = 0.5
W_EXACT = 1.0
W_STEM = 0.6

# METEOR-1.5 English task parameters (Denkowski & Lavie 2014, Table 2)
ALPHA_15 = 0.85
BETA_15 = 0.2
GAMMA_15 = 0.6
DELTA_15 = 0.75

# Curated English closed-class (function) word list for the 1.5 mode's
# delta weighting. The jar derives its list from corpus relative frequency
# (> 1e-3); this is the standard closed classes plus PTB-tokenizer
# artifacts (clitics, brackets, punctuation) — a documented delta.
FUNCTION_WORDS = frozenset("""
a an the
and or but nor so yet either neither both whether because although though
while if unless until since once than as that
of in on at by with from to into onto over under above below between among
through during before after about against around behind beyond despite down
off out up near inside outside within without upon across along past toward
towards via per for
i you he she it we they me him her us them my your his its our their mine
yours hers ours theirs this these those who whom whose which what someone
something anyone anything everyone everything nobody nothing
am is are was were be been being do does did doing have has had having will
would shall should can could may might must
not no there here when where why how all any each every some such own same
then just also too very
's 't 'll 're 've 'd 'm n't
. , ! ? ; : ' " ` `` '' -lrb- -rrb- --
""".split())


def _align(hyp: List[str], ref: List[str], stem_weight: float = W_STEM
           ) -> Tuple[List[Tuple[int, int, float]], int]:
    """Two-stage (exact, stem) alignment.

    Returns (matches [(hyp_i, ref_j, weight)], chunks). Greedy: hyp words
    left-to-right pick the closest unmatched ref occurrence (which realizes
    the 2007 spec's fewest-chunks tie-break on duplicate words).
    """
    matches: List[Tuple[int, int, float]] = []
    hyp_used = [False] * len(hyp)
    ref_used = [False] * len(ref)

    def stage(hyp_keys: List[str], ref_keys: List[str], weight: float):
        for i, hk in enumerate(hyp_keys):
            if hyp_used[i]:
                continue
            best = None
            for j, rk in enumerate(ref_keys):
                if ref_used[j] or rk != hk:
                    continue
                d = abs(i - j)
                if best is None or d < best[0]:
                    best = (d, j)
            if best is not None:
                j = best[1]
                hyp_used[i] = True
                ref_used[j] = True
                matches.append((i, j, weight))

    stage(hyp, ref, W_EXACT)
    stage([porter_stem(w) for w in hyp], [porter_stem(w) for w in ref],
          stem_weight)

    matches.sort(key=lambda m: m[0])
    chunks = 0
    prev = None
    for (i, j, _) in matches:
        if prev is None or i != prev[0] + 1 or j != prev[1] + 1:
            chunks += 1
        prev = (i, j)
    return matches, chunks


class _Stats:
    __slots__ = ("w_h", "w_r", "m", "chunks", "len_h", "len_r")

    def __init__(self, w_h=0.0, w_r=0.0, m=0, chunks=0, len_h=0, len_r=0):
        self.w_h, self.w_r, self.m = w_h, w_r, m
        self.chunks, self.len_h, self.len_r = chunks, len_h, len_r

    def __iadd__(self, o):
        self.w_h += o.w_h
        self.w_r += o.w_r
        self.m += o.m
        self.chunks += o.chunks
        self.len_h += o.len_h
        self.len_r += o.len_r
        return self


def _segment_stats(hyp: str, ref: str, stem_weight: float = W_STEM) -> _Stats:
    h, r = hyp.split(), ref.split()
    matches, chunks = _align(h, r, stem_weight)
    w = sum(m[2] for m in matches)
    return _Stats(w_h=w, w_r=w, m=len(matches), chunks=chunks,
                  len_h=len(h), len_r=len(r))


def _score_from_stats(s: _Stats) -> float:
    if s.m == 0 or s.len_h == 0 or s.len_r == 0:
        return 0.0
    p = s.w_h / s.len_h
    r = s.w_r / s.len_r
    if p == 0 or r == 0:
        return 0.0
    fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
    frag = float(s.chunks) / s.m if s.chunks > 0 else 0.0
    penalty = GAMMA * (frag ** BETA)
    return fmean * (1.0 - penalty)


class _Stats15:
    """METEOR-1.5 sufficient statistics: delta-weighted P/R numerators and
    denominators, matched-word count, chunks."""

    __slots__ = ("p_num", "p_den", "r_num", "r_den", "m", "chunks")

    def __init__(self, p_num=0.0, p_den=0.0, r_num=0.0, r_den=0.0,
                 m=0.0, chunks=0):
        self.p_num, self.p_den = p_num, p_den
        self.r_num, self.r_den = r_num, r_den
        self.m, self.chunks = m, chunks

    def __iadd__(self, o):
        self.p_num += o.p_num
        self.p_den += o.p_den
        self.r_num += o.r_num
        self.r_den += o.r_den
        self.m += o.m
        self.chunks += o.chunks
        return self


def _delta_weight(word: str) -> float:
    return (1.0 - DELTA_15) if word in FUNCTION_WORDS else DELTA_15


def _segment_stats_15(hyp: str, ref: str) -> _Stats15:
    h, r = hyp.split(), ref.split()
    matches, chunks = _align(h, r, W_STEM)
    p_num = sum(w * _delta_weight(h[i]) for (i, j, w) in matches)
    r_num = sum(w * _delta_weight(r[j]) for (i, j, w) in matches)
    p_den = sum(_delta_weight(w) for w in h)
    r_den = sum(_delta_weight(w) for w in r)
    # exact+stem modules align word-to-word, so hyp and ref cover the same
    # number of words and the jar's hyp/ref-averaged m equals len(matches)
    return _Stats15(p_num, p_den, r_num, r_den, float(len(matches)), chunks)


def _score_from_stats_15(s: _Stats15) -> float:
    if s.m == 0 or s.p_den == 0 or s.r_den == 0:
        return 0.0
    p = s.p_num / s.p_den
    r = s.r_num / s.r_den
    if p == 0 or r == 0:
        return 0.0
    fmean = p * r / (ALPHA_15 * p + (1 - ALPHA_15) * r)
    frag = float(s.chunks) / s.m if s.chunks > 0 else 0.0
    penalty = GAMMA_15 * (frag ** BETA_15) if frag > 0 else 0.0
    return fmean * (1.0 - penalty)


class Meteor:
    """compute_score(gts, res) -> (corpus_score, per-segment scores).

    ``version``: "2007" (default; Lavie & Agarwal 2007 formulation) or
    "1.5" (Denkowski & Lavie 2014 English parameterization with
    content/function-word weighting — module docstring for deltas vs the
    jar)."""

    def __init__(self, version: str = "2007"):
        if version not in ("2007", "1.5"):
            raise ValueError(f"unknown METEOR version: {version!r} "
                             "(use '2007' or '1.5')")
        self.version = version

    def compute_score(self, gts: Dict[str, List[str]],
                      res: Dict[str, List[str]]):
        assert gts.keys() == res.keys()
        seg, final = ((_segment_stats_15, _score_from_stats_15)
                      if self.version == "1.5"
                      else (_segment_stats, _score_from_stats))
        agg = _Stats15() if self.version == "1.5" else _Stats()
        scores = []
        for iid in gts:
            hyp = res[iid][0]
            best_score, best_stats = 0.0, None
            for ref in gts[iid]:
                st = seg(hyp, ref)
                sc = final(st)
                if best_stats is None or sc > best_score:
                    best_score, best_stats = sc, st
            scores.append(best_score)
            agg += best_stats
        return final(agg), np.asarray(scores)

    def method(self) -> str:
        return "METEOR"
