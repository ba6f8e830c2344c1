"""The port's C++ metrics core (recnet_tpu_torch/native/fastmetrics.cpp,
built with g++ at first use) against its own pure-Python paths and against
the JAX package's scorers (recnet_tpu/native and recnet_tpu/metrics), on
the same inputs: the mirror of tests/test_fastmetrics.py, plus the two
repairs of the copy (a core without a function falls back to Python; ids
the 31-bit n-gram packing cannot hold raise instead of aliasing) and the
readable build error."""

import json
import random
import types

import pytest

from recnet_tpu.metrics import CaptionScorer as JaxScorer
from recnet_tpu.metrics import bleu as j_bleu
from recnet_tpu.metrics import cider as j_cider
from recnet_tpu.metrics import rouge as j_rouge
from recnet_tpu.metrics.coco import COCOCaptions as JaxCOCO
from recnet_tpu.native import fastmetrics as j_fast
from recnet_tpu_torch import native
from recnet_tpu_torch.metrics import CaptionScorer
from recnet_tpu_torch.metrics import bleu as t_bleu
from recnet_tpu_torch.metrics import cider as t_cider
from recnet_tpu_torch.metrics import rouge as t_rouge
from recnet_tpu_torch.metrics.coco import COCOCaptions

WORDS = "a b c d e f g h i j".split()
MAX_ID = 2 ** 31 - 2


@pytest.fixture(scope="module")
def core():
    """The port's built core; the tests need it built (g++ and Python.h
    are in this image), so a build failure fails them with its reason."""
    assert native.HAVE_FASTMETRICS, native.BUILD_ERROR
    return native.fastmetrics


def _sent(rng, lo=1, hi=15):
    return [rng.choice(WORDS) for _ in range(rng.randint(lo, hi))]


def _corpus(seed, n=20, refs=3):
    rng = random.Random(seed)
    gts = {f"i{k}": [" ".join(_sent(rng)) for _ in range(refs)]
           for k in range(n)}
    res = {f"i{k}": [" ".join(_sent(rng))] for k in range(n)}
    return gts, res


def test_lcs_parity_random(core):
    rng = random.Random(0)
    for _ in range(200):
        a, b = _sent(rng), _sent(rng)
        want = j_rouge.lcs_length(a, b)
        assert t_rouge.lcs_length(a, b) == want
        assert t_rouge._lcs_length_py(a, b) == want


@pytest.mark.parametrize("a,b", [([], [1, 2]), ([1, 2, 3], [1, 2, 3]),
                                 ([1, 2, 3], [3, 2, 1]), ([], [])])
def test_lcs_edge_cases(core, a, b):
    assert core.lcs(a, b) == j_fast.lcs(a, b)


def test_bleu_stats_parity_random(core):
    rng = random.Random(1)
    for _ in range(100):
        hyp = " ".join(_sent(rng))
        refs = [" ".join(_sent(rng)) for _ in range(rng.randint(1, 5))]
        got = t_bleu._image_stats(hyp, refs)
        want = j_bleu._image_stats(hyp, refs)
        reflen, maxcounts = t_bleu._cook_refs(refs)
        py = t_bleu._cook_test(hyp, reflen, maxcounts)
        for key in ("testlen", "reflen"):
            assert got[key] == want[key] == py[key]
        for key in ("guess", "correct"):
            assert list(got[key]) == list(want[key]) == list(py[key])


def test_corpus_scores_identical_with_and_without_ext(core, monkeypatch):
    gts, res = _corpus(2)
    b_fast, bi_fast = t_bleu.Bleu(4).compute_score(gts, res)
    r_fast, ri_fast = t_rouge.Rouge().compute_score(gts, res)
    b_jax, _ = j_bleu.Bleu(4).compute_score(gts, res)
    r_jax, _ = j_rouge.Rouge().compute_score(gts, res)

    monkeypatch.setattr(native, "HAVE_FASTMETRICS", False)
    b_py, bi_py = t_bleu.Bleu(4).compute_score(gts, res)
    r_py, ri_py = t_rouge.Rouge().compute_score(gts, res)

    assert b_fast == b_py == b_jax
    assert bi_fast == bi_py
    assert r_fast == r_py == r_jax
    assert (ri_fast == ri_py).all()


def test_cider_native_bit_equals_python(core):
    """Bit equality, not closeness: the core keeps the Python scorer's
    per-k first-occurrence summation order and its libm calls."""
    rng = random.Random(3)
    gts = {f"i{k}": [" ".join(_sent(rng)) for _ in range(rng.randint(1, 6))]
           for k in range(60)}
    res = {f"i{k}": [" ".join(_sent(rng))] for k in range(60)}
    for k in range(0, 60, 3):
        res[f"i{k}"] = [gts[f"i{k}"][0]]
    s_py, a_py = t_cider.Cider(use_native=False).compute_score(gts, res)
    s_cc, a_cc = t_cider.Cider(use_native=True).compute_score(gts, res)
    s_j, a_j = j_cider.Cider(use_native=True).compute_score(gts, res)
    assert s_py == s_cc == s_j
    assert (a_py == a_cc).all() and (a_cc == a_j).all()


def test_cider_native_edge_cases(core):
    gts = {"empty_hyp": ["a b c", "b c d"], "one_word": ["a", "b"],
           "repeats": ["a a a a b b", "a b a b"],
           "long": [" ".join("a b c d e f g h i j".split() * 3)]}
    res = {"empty_hyp": [""], "one_word": ["a"], "repeats": ["a a b"],
           "long": ["a b c d e"]}
    s_py, a_py = t_cider.Cider(use_native=False).compute_score(gts, res)
    s_cc, a_cc = t_cider.Cider(use_native=True).compute_score(gts, res)
    s_j, a_j = j_cider.Cider(use_native=False).compute_score(gts, res)
    assert s_py == s_cc == s_j
    assert (a_py == a_cc).all() and (a_cc == a_j).all()


@pytest.mark.parametrize("native_on", [True, False],
                         ids=["cpp", "python"])
def test_caption_scorer_bit_equals_jax(core, monkeypatch, native_on):
    """Every score of CaptionScorer.evaluate(), the port's (C++ core or
    Python paths) against the JAX package's with its C++ extension."""
    gts_raw, res_raw = _corpus(4, n=40, refs=5)
    gts = {k: [{"caption": c} for c in v] for k, v in gts_raw.items()}
    res = {k: [{"caption": c} for c in v] for k, v in res_raw.items()}
    want = JaxScorer(gts, res).evaluate()
    if not native_on:
        monkeypatch.setattr(native, "HAVE_FASTMETRICS", False)
    got = CaptionScorer(gts, res).evaluate()
    assert got == want


@pytest.mark.parametrize("missing", ["lcs", "bleu_stats", "cider_stats"])
def test_a_core_without_a_function_falls_back_to_python(core, monkeypatch,
                                                        missing):
    """A module built from an older source may lack a function: the scorer
    that needs it takes its Python path (and gives the same scores)
    instead of raising AttributeError at scoring time."""
    stale = types.SimpleNamespace(**{
        name: getattr(core, name)
        for name in ("lcs", "bleu_stats", "cider_stats") if name != missing})
    gts, res = _corpus(5)
    want = [t_bleu.Bleu(4).compute_score(gts, res),
            t_rouge.Rouge().compute_score(gts, res)[0],
            t_cider.Cider(use_native=False).compute_score(gts, res)[0]]
    monkeypatch.setattr(native, "fastmetrics", stale)
    assert not native.has(missing)
    got = [t_bleu.Bleu(4).compute_score(gts, res),
           t_rouge.Rouge().compute_score(gts, res)[0],
           t_cider.Cider().compute_score(gts, res)[0]]
    assert got == want


@pytest.mark.parametrize("bad", [MAX_ID + 1, 2 ** 40, -1])
@pytest.mark.parametrize("call", ["lcs", "bleu_stats", "cider_stats"])
def test_ids_the_packing_cannot_hold_raise(core, call, bad):
    """Ids pack as id + 1 into 31 bits a position: 2^31 - 1 would spill
    into the next position's bits (and alias another n-gram), -1 would
    pack as the empty key. The core raises on them."""
    args = {"lcs": ([bad, 1], [1]),
            "bleu_stats": ([1, bad], [[1, 2]]),
            "cider_stats": ([[1, 2]], [[[bad, 1]]])}[call]
    with pytest.raises(ValueError, match="outside"):
        getattr(core, call)(*args)


def test_the_largest_id_stays_distinct(core):
    """At the edge of the range the keys stay exact: an n-gram of the
    largest id matches itself and not its neighbour."""
    hi, lo = MAX_ID, MAX_ID - 1
    _, _, _, correct = core.bleu_stats([hi, hi, lo], [[hi, hi, hi]])
    assert correct == [2, 1, 0, 0]
    assert core.lcs([hi, lo, hi], [lo, hi]) == 2
    # two images, so that idf is log 2 > 0: the bigram (hi, lo) scores
    # against itself and nothing against (lo, hi)
    same = core.cider_stats([[hi, lo], [1]], [[[hi, lo]], [[1]]])
    other = core.cider_stats([[hi, lo], [1]], [[[lo, hi]], [[1]]])
    assert same[0][1] > 0 and other[0][1] == 0


def test_the_build_error_is_readable(monkeypatch, tmp_path):
    """Without g++ the core is off, BUILD_ERROR says why, and the scorers
    give the Python paths' scores."""
    # an earlier test's monkeypatch may have left the lazily read
    # attributes in the module's dict: read them afresh
    for name in ("HAVE_FASTMETRICS", "fastmetrics", "BUILD_ERROR"):
        monkeypatch.delitem(vars(native), name, raising=False)
    monkeypatch.setattr(native, "_loaded", False)
    monkeypatch.setattr(native, "_module", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "fastmetrics-none.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.HAVE_FASTMETRICS is False
    assert "g++ not found" in native.BUILD_ERROR
    gts, res = _corpus(6)
    assert t_cider.Cider().compute_score(gts, res)[0] == \
        j_cider.Cider(use_native=False).compute_score(gts, res)[0]


def test_coco_captions_adapter(tmp_path, core):
    ds = {"images": [{"id": 1}, {"id": 2}, {"id": 3}],
          "annotations": [
              {"id": 10, "image_id": 1, "caption": "a man runs"},
              {"id": 11, "image_id": 1, "caption": "someone is running"},
              {"id": 12, "image_id": 2, "caption": "a dog sleeps"}]}
    p = tmp_path / "caps.json"
    p.write_text(json.dumps(ds))
    preds = [{"image_id": 1, "caption": "a man runs"},
             {"image_id": 2, "caption": "a cat"}]
    got, want = COCOCaptions(str(p)), JaxCOCO(str(p))
    assert got.getImgIds() == want.getImgIds()
    assert got.to_gts() == want.to_gts()
    assert dict(got.imgToAnns) == dict(want.imgToAnns)
    res, jres = got.loadRes(preds), want.loadRes(preds)
    assert res.to_gts() == jres.to_gts()
    gts = {k: v for k, v in got.to_gts().items() if v}
    scores = CaptionScorer(gts, res.to_gts()).evaluate()
    assert scores == JaxScorer(gts, jres.to_gts()).evaluate()
    assert scores["Bleu_1"] > 0.3
