"""PTB-style tokenizer — pure Python, no JVM.

Replaces the reference's subprocess call into Stanford CoreNLP's PTBTokenizer
(reference: coco_caption/pycocoevalcap/tokenizer/ptbtokenizer.py:24-68, jar at
:18) with a regex implementation of the Penn Treebank tokenization rules as
used with ``-preserveLines -lowerCase``, followed by removal of the same
punctuation list (ptbtokenizer.py:21-22).

Accuracy evidence (tests/test_metrics.py::test_ptb_tokenizer_golden_corpus):
a 20-sentence golden corpus derived from the Stanford tokenizer's documented
behavior (contractions, possessives, bracket placeholders incl. the
-LSB-/-RSB- forms the COCO strip list misses, numeric commas/colons,
cannot/gonna/wanna, ellipsis, final periods) passes exactly; and on the
actual caption domain this pipeline feeds (lowercase ascii, punctuation
already stripped by the corpus transforms) tokenization is verified to be
the identity, so all four metric inputs match the jar pipeline there
(test_ptb_tokenizer_clean_caption_domain_is_identity).

Cross-validation breadth (round 4): NLTK's TreebankWordTokenizer — an
independent port of the same classic tokenizer.sed rules — agrees with
``ptb_tokenize_line`` on 100% of ~420 structured sentences and 3000 seeded
fuzz compositions of tricky fragments (contractions, abbreviations, money,
numeric commas/colons, quotes, stray punctuation); the only deliberate
divergences are the Stanford bracket placeholders (-LRB- …, which the COCO
strip list depends on) and the lowercase option
(tests/test_metrics.py::test_ptb_tokenizer_agrees_with_nltk_*).

Known remaining deltas vs the Stanford jar (documented; outside the caption
domain): rare unicode normalizations and abbreviation-specific period
handling (e.g. sentence-final "u.s.").
"""

from __future__ import annotations

import re
from typing import Dict, List

# ptbtokenizer.py:21-22 — removed AFTER tokenization
PUNCTUATIONS = {"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"}

# Penn Treebank tokenization, in the order of the classic sed script.
_RULES_1 = [
    (re.compile(r"^\""), r"`` "),                    # leading double quote
    (re.compile(r'([ (\[{<])"'), r"\1 `` "),          # quote after bracket
    (re.compile(r"\.\.\."), r" ... "),
    # commas/colons stay attached between digits ("1,000", "5:30") as the
    # Stanford tokenizer keeps them; split everywhere else
    (re.compile(r"([,:])(?!\d)|(?<!\d)([,:])"),
     lambda m: f" {m.group(1) or m.group(2)} "),
    (re.compile(r"([;@#$%&])"), r" \1 "),
    # word-final period (before optional closers + end)
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"([?!])"), r" \1 "),
    (re.compile(r"([\]\[\(\)\{\}<>])"), r" \1 "),
    (re.compile(r"--"), r" -- "),
]
_RULES_2 = [
    (re.compile(r'"'), r" '' "),                      # remaining double quotes
    (re.compile(r"([^'])' "), r"\1 ' "),
    # contractions
    (re.compile(r"('[sSmMdD]) "), r" \1 "),
    (re.compile(r"('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r" \1 "),
    (re.compile(r"\b(can)(not)\b", re.IGNORECASE), r"\1 \2"),
    (re.compile(r"\b(gon)(na)\b", re.IGNORECASE), r"\1 \2"),
    (re.compile(r"\b(wan)(na)\b", re.IGNORECASE), r"\1 \2"),
]
# Stanford's bracket placeholders: note [ ] map to -LSB-/-RSB-, which the
# COCO PUNCTUATIONS list does NOT contain — the jar pipeline keeps them,
# so we must too (ptbtokenizer.py:21-22).
_BRACKETS = {"(": "-LRB-", ")": "-RRB-", "[": "-LSB-", "]": "-RSB-",
             "{": "-LCB-", "}": "-RCB-"}


def ptb_tokenize_line(line: str, lowercase: bool = True) -> List[str]:
    s = " " + line.replace("\n", " ") + " "
    for rx, rep in _RULES_1:
        s = rx.sub(rep, s)
    s = s + " "
    for rx, rep in _RULES_2:
        s = rx.sub(rep, s)
    tokens = s.split()
    if lowercase:
        tokens = [t.lower() for t in tokens]
    # bracket placeholders stay uppercase so the PUNCTUATIONS filter
    # (ptbtokenizer.py:21-22) removes them
    tokens = [_BRACKETS.get(t, t) for t in tokens]
    return tokens


# caption string -> tokenized string. Pure function, so a capped memo is
# exact (the stemmer got the same treatment in round 4). The payoff is the
# training loop's periodic test evals: the GT side of every evaluate() call
# re-tokenizes the SAME fixed corpus captions — 2 search methods × every
# test block — ~1 s each at MSR-VTT scale, all but the first now free.
_MEMO: Dict[str, str] = {}
_MEMO_MAX = 1 << 20


def _tokenize_caption(caption: str) -> str:
    hit = _MEMO.get(caption)
    if hit is not None:
        return hit
    toks = ptb_tokenize_line(caption)
    out = " ".join(t for t in toks if t not in PUNCTUATIONS)
    if len(_MEMO) < _MEMO_MAX:
        _MEMO[caption] = out
    return out


class PTBTokenizer:
    """Drop-in for the reference wrapper: dict {id: [{'caption': str}]} →
    dict {id: [tokenized_str]}, punctuation list removed
    (ptbtokenizer.py:27-68)."""

    def tokenize(self, captions_for_image: Dict[str, List[dict]]
                 ) -> Dict[str, List[str]]:
        return {k: [_tokenize_caption(ann["caption"]) for ann in anns]
                for k, anns in captions_for_image.items()}
