"""The port's training data path against the JAX package's (corpus,
datasets, Batcher and cycle, batch for batch), its device prefetch, and
``sample_decode`` held to the properties of the JAX sampler (its draws
cannot be reproduced)."""

import threading
import time

import numpy as np
import pytest
import torch

from fixtures import make_msvd_fixture, tiny_train_config
from recnet_tpu.data import Corpus as JaxCorpus
from recnet_tpu.data import cycle as j_cycle
from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.data import Corpus, cycle, prefetch_to_device
from recnet_tpu_torch.decoding import greedy_decode, sample_decode
from recnet_tpu_torch.models import decoder as t_dec
from recnet_tpu_torch.weights import params_from_jax, random_params


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("msvd")
    make_msvd_fixture(str(root), feat_dim=32)
    return str(root)


def _configs(root, **overrides):
    jtc = tiny_train_config(root, **overrides)
    return jtc, TrainConfig.from_json(jtc.to_json())


@pytest.mark.parametrize("cache", [False, True], ids=["videos", "index"])
def test_train_and_val_batches_equal_jax(fixture_root, cache):
    """Shuffled train batches over three epochs and the val batches, with
    a padded last batch (24 pairs in batches of 5)."""
    jtc, ttc = _configs(fixture_root, batch_size=5,
                        device_feature_cache=cache)
    jc, tc = JaxCorpus(jtc), Corpus(ttc)
    assert tc.vocab.word2idx == jc.vocab.word2idx
    n = 3 * len(jc.train_batcher)
    j_it, t_it = j_cycle(jc.train_batcher), cycle(tc.train_batcher)
    padded = 0
    for _ in range(n):
        (jv, jx, jy), (tv, tx, ty) = next(j_it), next(t_it)
        assert tv == jv
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        padded += "PAD" in tv
    assert padded == 3                       # one short batch an epoch
    for (jv, jx, jy), (tv, tx, ty) in zip(jc.val_batcher, tc.val_batcher):
        assert tv == jv
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    if cache:
        np.testing.assert_array_equal(tc.train_dataset.feature_cache(),
                                      jc.train_dataset.feature_cache())


def test_in_memory_corpus_equals_the_files(fixture_root):
    _, ttc = _configs(fixture_root)
    files = Corpus(ttc)
    splits = {s: (getattr(files, f"{s}_dataset").videos,
                  getattr(files, f"{s}_dataset").captions)
              for s in ("train", "val", "test")}
    mem = Corpus(ttc, vocab=files.vocab, splits=splits)
    for a, b in zip(files.train_batcher, mem.train_batcher):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    assert [v for v, _ in files.score_batcher] == [
        v for v, _ in mem.score_batcher]
    with pytest.raises(ValueError, match="vocab"):
        Corpus(ttc, splits=splits)


def test_data_bundle_raises_for_training(fixture_root, tmp_path):
    """The bundle is ported: a training corpus with data_bundle gives the
    JAX package's bundled train batches; only an in-memory corpus, which
    has no files to pack, raises on it."""
    jtc, ttc = _configs(fixture_root, data_bundle=True,
                        data_bundle_root=str(tmp_path / "bundles"))
    tc, jc = Corpus(ttc), JaxCorpus(jtc)
    assert tc._bundle is not None and jc._bundle is not None
    for (jv, jx, jy), (tv, tx, ty) in zip(jc.train_batcher,
                                          tc.train_batcher):
        assert tv == jv
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    splits = {s: ({}, {}) for s in ("train", "val", "test")}
    with pytest.raises(ValueError, match="no data bundle"):
        Corpus(ttc, vocab=tc.vocab, splits=splits)


def test_prefetch_copies_batches_in_order():
    src = ((["v"], np.full((2, 3), i, np.float32)) for i in range(5))
    pf = prefetch_to_device(src, size=2, device="cpu")
    got = list(pf)
    assert [int(b[1][0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b[1], torch.Tensor) and b[0] == ["v"]
               for b in got)
    with pytest.raises(StopIteration):
        next(pf)
    pf.thread.join(timeout=5)
    assert not pf.thread.is_alive()


def test_prefetch_reraises_a_producer_error():
    def src():
        yield (np.zeros(2, np.float32),)
        raise OSError("disk gone")
    pf = prefetch_to_device(src(), device="cpu")
    next(pf)
    with pytest.raises(RuntimeError, match="prefetch worker failed") as e:
        next(pf)
    assert isinstance(e.value.__cause__, OSError)
    pf.close()
    assert not pf.thread.is_alive()


def test_prefetch_close_stops_the_thread():
    def endless():
        while True:
            yield (np.zeros(4, np.float32),)
    pf = prefetch_to_device(endless(), size=1, device="cpu")
    next(pf)
    deadline = time.time() + 5
    while not pf._q.full() and time.time() < deadline:   # blocked on put
        time.sleep(0.01)
    pf.close()
    assert not pf.thread.is_alive()
    assert "prefetch_to_device" not in [th.name for th in threading.enumerate()
                                        if th.is_alive()]


def _decoder():
    ttc = TrainConfig(caption_max_len=8, embedding_size=12,
                      encoder_output_size=20, encoder_output_len=6,
                      decoder_hidden_size=16, decoder_attn_size=8)
    cfg = t_dec.config_from_train(ttc, 40)
    params = params_from_jax(random_params(cfg, 2))
    enc = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (6, 6, 20)).astype(np.float32))
    return cfg, params, enc


def test_sample_decode_shape_and_determinism():
    cfg, params, enc = _decoder()
    gen = lambda s: torch.Generator().manual_seed(s)
    r1 = sample_decode(params, cfg, enc, 8, gen(0))
    r2 = sample_decode(params, cfg, enc, 8, gen(0))
    assert r1.tokens.shape == (9, 6) and r1.tokens.dtype == torch.int32
    assert torch.equal(r1.tokens, r2.tokens) and r1.n_steps == r2.n_steps
    r3 = sample_decode(params, cfg, enc, 8, gen(1))
    assert not torch.equal(r1.tokens, r3.tokens)


@pytest.mark.parametrize("kw", [dict(temperature=1e-4), dict(top_k=1)])
def test_sample_decode_degenerates_to_greedy(kw):
    cfg, params, enc = _decoder()
    g = greedy_decode(params, cfg, enc, 8)
    s = sample_decode(params, cfg, enc, 8, torch.Generator().manual_seed(3),
                      **kw)
    n = min(g.n_steps, s.n_steps)
    assert torch.equal(s.tokens[:n], g.tokens[:n])


def test_sample_decode_draws_stay_in_the_top_k():
    """Step 0 sees the same logits in every call (zero state, <SOS>), so
    its draws over many seeds must all lie in that step's top k."""
    cfg, params, enc = _decoder()
    from recnet_tpu_torch.ops.attention import precompute_uv
    B = enc.shape[0]
    logits, _ = t_dec.decoder_step(
        params, cfg, torch.full((B,), cfg.sos_token, dtype=torch.int32),
        t_dec.zero_state(cfg, B), enc, precompute_uv(params["attention"],
                                                     enc))
    top3 = torch.topk(logits, 3, dim=-1).indices
    seen = set()
    for seed in range(40):
        first = sample_decode(params, cfg, enc, 8,
                              torch.Generator().manual_seed(seed),
                              top_k=3).tokens[0]
        assert bool((top3 == first[:, None].long()).any(dim=1).all())
        seen |= {(b, int(x)) for b, x in enumerate(first)}
    assert len(seen) > B        # more than one token per row was drawn


def test_sample_freezes_at_all_pad():
    cfg, params, enc = _decoder()
    params = dict(params, out_b=params["out_b"].clone())
    params["out_b"][cfg.pad_token] = 1e4          # <PAD> always wins
    r = sample_decode(params, cfg, enc, 8, torch.Generator().manual_seed(0))
    assert r.n_steps == 1 and bool((r.tokens == cfg.pad_token).all())
