"""Classic Porter stemmer — pure Python, for METEOR's stem-match module.

Self-contained implementation of M.F. Porter's 1980 algorithm with two
Snowball-endorsed amendments that matter for caption text (the METEOR 1.5
jar uses Snowball/Porter2):

* step 1c uses Snowball's rule — ``y -> i`` when preceded by a consonant
  that is not the word's first letter — so "flies"/"flying"/"cry" all stem
  to "fli"/"fli"/"cri" as Snowball (and NLTK's extended Porter) produce,
  instead of the original's vowel-in-stem condition which leaves
  "fly" ≠ "fli";
* Snowball's small exceptional-form pool (skis/skies/dying/... and the
  invariants sky/news/...).

Remaining differences vs Snowball affect a handful of rare suffixes and are
documented as an accepted delta in metrics/meteor.py.
"""

from __future__ import annotations

_EXCEPTIONS = {"skis": "ski", "skies": "sky", "dying": "die",
               "lying": "lie", "tying": "tie"}
# Step 4 suffixes, longest-first (hoisted — this sort ran per call before)
_STEP4 = sorted(["al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                 "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
                 "ive", "ize"], key=len, reverse=True)
_INVARIANT = frozenset(
    {"sky", "news", "howe", "atlas", "cosmos", "bias", "andes"})


def _is_cons(word: str, i: int) -> bool:
    ch = word[i]
    if ch in "aeiou":
        return False
    if ch == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        cons = _is_cons(stem, i)
        if cons and prev_vowel:
            m += 1
        prev_vowel = not cons
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_cons(word, len(word) - 1))


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    if (_is_cons(word, len(word) - 1) and not _is_cons(word, len(word) - 2)
            and _is_cons(word, len(word) - 3)):
        return word[-1] not in "wxy"
    return False


# Caption corpora draw from a small vocabulary, so the same words are
# stemmed millions of times per scoring pass (profiled: 33 of 35 s of a
# MSR-VTT-scale METEOR call was unmemoized porter_stem). Pure function →
# a capped memo is exact; the cap only matters for adversarial streams.
_MEMO: dict = {}
_MEMO_MAX = 1 << 20


def porter_stem(word: str) -> str:
    hit = _MEMO.get(word)
    if hit is not None:
        return hit
    out = _porter_stem_uncached(word)
    if len(_MEMO) < _MEMO_MAX:
        _MEMO[word] = out
    return out


def _porter_stem_uncached(word: str) -> str:
    if len(word) <= 2:
        return word
    w = word.lower()
    if w in _INVARIANT:
        return w
    if w in _EXCEPTIONS:
        return _EXCEPTIONS[w]

    # Step 1a (with Snowball's short-word amendment: "ies"/"ied" -> "ie"
    # when preceded by a single letter — "ties" -> "tie", "died" -> "die")
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith(("ies", "ied")):
        w = w[:-3] + ("ie" if len(w) == 4 else "i")
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _has_vowel(w[:-2]):
            w = w[:-2]
            flag_1b = True
    elif w.endswith("ing"):
        if _has_vowel(w[:-3]):
            w = w[:-3]
            flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"

    # Step 1c (Snowball rule): y -> i when preceded by a consonant that is
    # not the first letter ("cry" -> "cri", "fly" -> "fli", "say" -> "say")
    if w.endswith("y") and len(w) > 2 and w[-2] not in "aeiou":
        w = w[:-1] + "i"

    # Step 2
    step2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
             ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
             ("alli", "al"), ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
             ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
             ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
             ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
             ("biliti", "ble")]
    for suf, rep in step2:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 3
    step3 = [("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
             ("ical", "ic"), ("ful", ""), ("ness", "")]
    for suf, rep in step3:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 4
    for suf in _STEP4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and _measure(w[:-3]) > 1 and w[-4] in "st":
            w = w[:-3]

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # Step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]

    return w
