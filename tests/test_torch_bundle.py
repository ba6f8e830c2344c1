"""The port's preprocessed-corpus bundle (recnet_tpu_torch/data/bundle.py)
against the JAX package's (recnet_tpu/data/bundle.py) on the same fixture:
the mirror of tests/test_bundle.py case for case (round-trip, batches equal
to the fresh-built corpus, key invalidation, the loop's integration, the
half-width storage, the non-primary poll), plus the cross-package cases:
the two packages' bundles are byte-equal under the same key, and a bundle
built by either loads in the other with equal batches."""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import ml_dtypes

from fixtures import make_msvd_fixture, tiny_train_config
from recnet_tpu.data import Corpus as JaxCorpus
from recnet_tpu.data import bundle as JB
from recnet_tpu_torch.cli import bundle as t_cli
from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.data import Corpus
from recnet_tpu_torch.data import bundle as B
from recnet_tpu_torch.training.loop import train
from recnet_tpu_torch.utils.misc import tree_leaves

BF16 = np.dtype(ml_dtypes.bfloat16)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("msvd_bundle"))
    make_msvd_fixture(root)
    return root


def _tcs(root, **kw):
    """(JAX TrainConfig, port TrainConfig) with the same fields."""
    jtc = tiny_train_config(root, **kw)
    return jtc, TrainConfig.from_json(jtc.to_json())


def _tc(root, **kw):
    return _tcs(root, **kw)[1]


def _files(path):
    """{file name: bytes} of a bundle, meta.json without its build time."""
    out = {}
    for name in sorted(os.listdir(path)):
        data = open(os.path.join(path, name), "rb").read()
        if name == "meta.json":
            meta = json.loads(data)
            meta.pop("built_at")
            data = json.dumps(meta, sort_keys=True).encode()
        out[name] = data
    return out


def _loop_params(tc, tmp_path, tag):
    final = train(tc, loss_only=True, log_dir=str(tmp_path / f"l{tag}"),
                  save_dir=str(tmp_path / f"c{tag}"), device="cpu")
    return [p.detach().numpy() for p in tree_leaves(final.dec_params)]


def test_bundle_builds_and_loads(fixture_root, tmp_path):
    tc = _tc(fixture_root, data_bundle=True,
             data_bundle_root=str(tmp_path / "bundles"))
    path = B.bundle_dir(tc)
    assert not os.path.isdir(path)
    b = B.load_or_build(tc)
    assert os.path.isdir(path)
    assert set(b.datasets) == {"train", "val", "test"}
    for split, ds in b.datasets.items():
        assert ds.feats.shape[1:] == (tc.encoder_output_len,
                                      tc.encoder_output_size)
        assert ds.captions.shape == (len(ds), b.vocab.max_sentence_len + 1)
        assert ds.captions.dtype == np.int32
        assert len(ds.rows) == len(ds.raw_captions) == len(ds)
    # a second load hits the artifact: building again would fail here
    b2 = B.load_or_build(
        tc, log=lambda m: (_ for _ in ()).throw(AssertionError(m))
        if "building" in m else None)
    assert b2.vocab.word2idx == b.vocab.word2idx


@pytest.mark.parametrize("store", ["float32", "bfloat16", "float16"])
def test_bundles_of_both_packages_are_byte_equal(fixture_root, tmp_path,
                                                 store):
    """Same config, same files: the same key and the same bytes in every
    file (meta.json up to its build time), f32 and half-width storage."""
    kw = dict(data_bundle=True, device_feature_cache=store != "float32",
              feature_cache_dtype=store)
    jtc, ttc = _tcs(fixture_root, data_bundle_root=str(tmp_path / "j"), **kw)
    ttc = ttc.replace(data_bundle_root=str(tmp_path / "t"))
    assert B.bundle_key(ttc) == JB.bundle_key(jtc)
    jpath, tpath = JB.build_bundle(jtc, log=print), B.build_bundle(ttc)
    assert os.path.basename(jpath) == os.path.basename(tpath)
    assert _files(tpath) == _files(jpath)


def test_bundled_corpus_is_bit_identical(fixture_root, tmp_path):
    """Fresh-built and bundled corpora give the same vocab, pairs, feature
    caches and batch streams; and the port's bundled stream equals the
    JAX package's bundled one."""
    jtc, tc = _tcs(fixture_root)
    tcb = tc.replace(data_bundle=True,
                     data_bundle_root=str(tmp_path / "bundles"))
    fresh, bundled = Corpus(tc), Corpus(tcb)
    jbundled = JaxCorpus(jtc.replace(
        data_bundle=True, data_bundle_root=str(tmp_path / "jbundles")))

    assert bundled.vocab.word2idx == fresh.vocab.word2idx
    assert bundled.vocab.max_sentence_len == fresh.vocab.max_sentence_len
    assert (bundled.test_dataset.video_caption_pairs
            == fresh.test_dataset.video_caption_pairs
            == jbundled.test_dataset.video_caption_pairs)
    np.testing.assert_array_equal(
        np.asarray(bundled.train_dataset.feature_cache()),
        fresh.train_dataset.feature_cache())
    for (v1, vid1, cap1), (v2, vid2, cap2), (v3, vid3, cap3) in zip(
            fresh.train_batcher, bundled.train_batcher,
            jbundled.train_batcher):
        assert v1 == v2 == v3
        np.testing.assert_array_equal(vid1, vid2)
        np.testing.assert_array_equal(vid2, vid3)
        np.testing.assert_array_equal(cap1, cap2)
        np.testing.assert_array_equal(cap2, cap3)
    for (v1, vid1), (v2, vid2) in zip(fresh.score_batcher,
                                      bundled.score_batcher):
        assert v1 == v2
        np.testing.assert_array_equal(vid1, vid2)


def test_bundled_index_mode_matches(fixture_root, tmp_path):
    """device_feature_cache + bundle: same row indices, same captions."""
    tc = _tc(fixture_root, device_feature_cache=True)
    tcb = tc.replace(data_bundle=True,
                     data_bundle_root=str(tmp_path / "bundles"))
    fresh, bundled = Corpus(tc), Corpus(tcb)
    for (v1, r1, c1), (v2, r2, c2) in zip(fresh.train_batcher,
                                          bundled.train_batcher):
        assert v1 == v2
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(c1, c2)


def test_bundle_key_tracks_inputs_and_knobs(fixture_root, tmp_path):
    """Every key equals the JAX package's for the same config and files."""
    jtc, tc = _tcs(fixture_root, data_bundle=True,
                   data_bundle_root=str(tmp_path / "bundles"))
    key = B.bundle_key(tc)
    same = lambda **kw: B.bundle_key(tc.replace(**kw)) == JB.bundle_key(
        jtc.replace(**kw))
    assert key == JB.bundle_key(jtc)
    assert B.bundle_key(tc.replace(min_count=2)) != key and same(min_count=2)
    assert B.bundle_key(tc.replace(caption_max_len=9)) != key
    assert same(caption_max_len=9)
    assert B.bundle_key(tc.replace(batch_size=2, n_iterations=1)) == key
    cap = os.path.join(fixture_root, "MSVD", "metadata",
                       "MSR Video Description Corpus.csv")
    st = os.stat(cap)
    os.utime(cap, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    try:
        assert B.bundle_key(tc) != key
        assert B.bundle_key(tc) == JB.bundle_key(jtc)
    finally:
        os.utime(cap, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert B.bundle_key(tc) == key


def test_bundle_rejects_stochastic_sampling(fixture_root, tmp_path):
    tc = _tc(fixture_root, data_bundle=True,
             frame_sampling_method="random",
             data_bundle_root=str(tmp_path / "bundles"))
    with pytest.raises(ValueError, match="uniform"):
        Corpus(tc)


def test_bundle_vocab_mismatch_is_loud(fixture_root, tmp_path):
    from recnet_tpu_torch.data.vocab import Vocab
    tc = _tc(fixture_root, data_bundle=True,
             data_bundle_root=str(tmp_path / "bundles"))
    wrong = Vocab({"<PAD>": 0, "<SOS>": 1, "<EOS>": 2}, 1)
    wrong.build(["completely different corpus text"], lambda s: s.split())
    with pytest.raises(ValueError, match="vocab"):
        Corpus(tc, vocab=wrong)


def test_train_loop_with_bundle_matches_without(fixture_root, tmp_path):
    """Two fresh 2-iteration runs of the port's loop, raw files against a
    bundle the JAX package built: final params bit-exact."""
    kw = dict(n_iterations=2, log_every=2, validate_every=2, test_every=2,
              save_every=2, use_recon=False)
    jtc, tc = _tcs(fixture_root, **kw)
    root = str(tmp_path / "bundles")
    JB.build_bundle(jtc.replace(data_bundle=True, data_bundle_root=root),
                    log=print)
    tcb = tc.replace(data_bundle=True, data_bundle_root=root)
    for a, b in zip(_loop_params(tc, tmp_path, 1),
                    _loop_params(tcb, tmp_path, 2)):
        np.testing.assert_array_equal(a, b)


def test_bundle_missing_input_falls_back_to_raw(fixture_root, tmp_path,
                                                capsys):
    """A host without the train split's files: Corpus reads the raw files
    of the splits it was asked for, and says so."""
    root = str(tmp_path / "evalhost")
    shutil.copytree(fixture_root, root)
    tc = _tc(root, data_bundle=True,
             data_bundle_root=str(tmp_path / "bundles2"),
             build_train_data_loader=False, build_val_data_loader=False,
             build_test_data_loader=True, build_score_data_loader=True)
    os.remove(tc.video_fpath("train"))
    corpus = Corpus(tc)
    assert corpus._bundle is None
    assert corpus.test_dataset is not None and len(corpus.test_dataset) > 0
    assert "falling back" in capsys.readouterr().err


def test_bundle_cli_build_and_info(fixture_root, tmp_path, capsys):
    """build packs the keyed bundle (the JAX CLI's key for the same
    flags); info prints its meta, by config and by --path."""
    from recnet_tpu.cli import bundle as j_cli

    tc = _tc(fixture_root)
    argv = ["--corpus", "MSVD", "--data_root", fixture_root,
            "--encoder", tc.encoder_model,
            "--encoder_output_len", str(tc.encoder_output_len),
            "--min_count", str(tc.min_count),
            "--caption_max_len", str(tc.caption_max_len)]
    root = ["--bundle_root", str(tmp_path / "bundles_cli")]
    assert t_cli.main(["build"] + argv + root) == 0
    meta = json.loads(capsys.readouterr().out)
    assert meta["splits"]["train"]["n_videos"] > 0
    assert os.path.isdir(meta["path"])
    assert j_cli.main(["build"] + argv
                      + ["--bundle_root", str(tmp_path / "j")]) == 0
    assert json.loads(capsys.readouterr().out)["key"] == meta["key"]
    assert t_cli.main(["build"] + argv + root) == 0
    assert "already exists" in capsys.readouterr().err
    assert t_cli.main(["info", "--path", meta["path"]]) == 0
    assert json.loads(capsys.readouterr().out)["key"] == meta["key"]
    # the JAX CLI reads the port's bundle
    assert j_cli.main(["info", "--path", meta["path"]]) == 0
    assert json.loads(capsys.readouterr().out)["key"] == meta["key"]
    assert t_cli.main(["info", "--path", str(tmp_path / "nope")]) == 1


def test_bundle_build_replace_race_is_success(fixture_root, tmp_path,
                                              monkeypatch):
    """A concurrent build that wins the os.replace race leaves a complete
    bundle: losing is success, not an error."""
    tc = _tc(fixture_root, data_bundle=True,
             data_bundle_root=str(tmp_path / "bundles3"))
    path = B.bundle_dir(tc)
    real_replace = os.replace

    def racing_replace(src, dst):
        real_replace(src, dst)
        raise OSError("Directory not empty")

    monkeypatch.setattr(B.os, "replace", racing_replace)
    B.build_bundle(tc, path)
    assert os.path.isdir(path)
    assert set(B.load_bundle(path).datasets) == {"train", "val", "test"}


def test_halfwidth_bundle_stores_cache_dtype(fixture_root, tmp_path):
    """bfloat16 storage of train/val (test stays float32), read back as
    torch.bfloat16: the bits of the loop's own cast of the fresh cache,
    and of the JAX package's ml_dtypes cast."""
    tc = _tc(fixture_root, data_bundle=True, device_feature_cache=True,
             feature_cache_dtype="bfloat16",
             data_bundle_root=str(tmp_path / "bundles_bf16"))
    tcf = tc.replace(feature_cache_dtype="float32")
    bundled = Corpus(tc)
    cache = B.as_tensor(bundled.train_dataset.feature_cache())
    assert cache.dtype == torch.bfloat16
    assert B.as_tensor(bundled.val_dataset.feature_cache()).dtype == \
        torch.bfloat16
    assert np.asarray(bundled.test_dataset.feature_cache()).dtype == \
        np.float32
    assert np.asarray(bundled.score_dataset.get(0)[1]).dtype == np.float32

    Corpus(tcf)
    sz16 = os.path.getsize(os.path.join(B.bundle_dir(tc), "train_feats.npy"))
    sz32 = os.path.getsize(os.path.join(B.bundle_dir(tcf),
                                        "train_feats.npy"))
    assert sz16 < 0.55 * sz32

    fresh = Corpus(tcf.replace(data_bundle=False)).train_dataset
    want = torch.from_numpy(fresh.feature_cache()).to(torch.bfloat16)
    assert torch.equal(cache.view(torch.int16), want.view(torch.int16))
    jax_bits = fresh.feature_cache().astype(BF16).view(np.int16)
    np.testing.assert_array_equal(cache.view(torch.int16).numpy(), jax_bits)


def test_halfwidth_bundle_key_tracks_dtype(fixture_root, tmp_path):
    kw = dict(data_bundle=True,
              data_bundle_root=str(tmp_path / "bundles_key"))
    keys = {}
    for name, extra in [
            ("f32", {}),
            ("bf16", dict(device_feature_cache=True,
                          feature_cache_dtype="bfloat16")),
            ("cache_f32", dict(device_feature_cache=True)),
            ("inert", dict(feature_cache_dtype="bfloat16"))]:
        jtc, ttc = _tcs(fixture_root, **kw, **extra)
        keys[name] = B.bundle_key(ttc)
        assert keys[name] == JB.bundle_key(jtc), name
    assert keys["f32"] != keys["bf16"]
    assert keys["cache_f32"] == keys["f32"] == keys["inert"]


def test_halfwidth_bundle_training_matches_fresh_bf16_cache(
        fixture_root, tmp_path):
    """Training from a bf16 bundle equals training fresh with the bf16
    device cache (the loop's cast): bit-equal final params."""
    kw = dict(n_iterations=2, log_every=2, validate_every=2, test_every=2,
              save_every=2, use_recon=False, device_feature_cache=True,
              feature_cache_dtype="bfloat16")
    tc = _tc(fixture_root, **kw)
    tcb = tc.replace(data_bundle=True,
                     data_bundle_root=str(tmp_path / "bundles_train16"))
    for a, b in zip(_loop_params(tc, tmp_path, 1),
                    _loop_params(tcb, tmp_path, 2)):
        np.testing.assert_array_equal(a, b)


def test_f16_overflow_fails_loudly(fixture_root, tmp_path):
    import h5py

    root = str(tmp_path / "bigfeat")
    shutil.copytree(fixture_root, root)
    tc = _tc(root, data_bundle=True, device_feature_cache=True,
             feature_cache_dtype="float16",
             data_bundle_root=str(tmp_path / "bundles_f16"))
    with h5py.File(tc.video_fpath("train"), "r+") as f:
        vid = list(f)[0]
        x = np.asarray(f[vid])
        x[0, 0] = 70000.0
        del f[vid]
        f[vid] = x
    with pytest.raises(ValueError, match="float16"):
        B.build_bundle(tc)


def test_loop_warns_when_cache_dtype_is_inert(fixture_root, tmp_path):
    tc = _tc(fixture_root, n_iterations=2, log_every=2, validate_every=2,
             test_every=2, save_every=2, use_recon=False,
             feature_cache_dtype="bfloat16")
    with pytest.warns(UserWarning, match="no effect"):
        train(tc, loss_only=True, log_dir=str(tmp_path / "lw"),
              save_dir=str(tmp_path / "cw"), device="cpu")


def test_load_or_build_nonprimary_polls_for_primary(fixture_root, tmp_path,
                                                    monkeypatch):
    """rank != 0 and no bundle on disk: wait for the primary's atomic
    rename instead of duplicating the build."""
    tc = _tc(fixture_root, data_bundle=True,
             data_bundle_root=str(tmp_path / "bundles_poll"))
    monkeypatch.setattr(B, "_process_index", lambda: 1)
    real_sleep = time.sleep
    monkeypatch.setattr(B.time, "sleep",
                        lambda s: real_sleep(min(s, 0.05)))

    def primary():
        real_sleep(0.3)
        B.build_bundle(tc, log=lambda m: None)

    t = threading.Thread(target=primary)
    t.start()
    logs = []
    b = B.load_or_build(tc, log=logs.append, build_wait_s=60.0)
    t.join(timeout=30)
    assert not t.is_alive()
    assert any("waiting for primary" in m for m in logs)
    assert not any("building locally" in m for m in logs)
    assert set(b.datasets) == {"train", "val", "test"}
    assert len(b.datasets["train"]) > 0


def test_load_or_build_timeout_falls_back_to_local_build(
        fixture_root, tmp_path, monkeypatch):
    tc = _tc(fixture_root, data_bundle=True,
             data_bundle_root=str(tmp_path / "bundles_timeout"))
    monkeypatch.setattr(B, "_process_index", lambda: 1)
    logs = []
    b = B.load_or_build(tc, log=logs.append, build_wait_s=0.0)
    assert any("building locally" in m for m in logs)
    assert set(b.datasets) == {"train", "val", "test"}
    assert os.path.isdir(B.bundle_dir(tc))


def test_process_index_reads_the_torch_distributed_rank(monkeypatch):
    assert B._process_index() == 0       # no process group
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 3)
    assert B._process_index() == 3


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_bundles_load_across_packages(fixture_root, tmp_path, store):
    """A JAX-built bundle in the port, and a port-built one in the JAX
    package: the same vocab, rows, captions and feature bits."""
    kw = dict(data_bundle=True, device_feature_cache=store != "float32",
              feature_cache_dtype=store)
    jtc, ttc = _tcs(fixture_root, **kw)
    jpath = JB.build_bundle(jtc.replace(
        data_bundle_root=str(tmp_path / "j")), log=print)
    tpath = B.build_bundle(ttc.replace(data_bundle_root=str(tmp_path / "t")))
    for path in (jpath, tpath):
        got, want = B.load_bundle(path), JB.load_bundle(path)
        assert got.vocab.word2idx == want.vocab.word2idx
        for split in B.SPLITS:
            g, w = got.datasets[split], want.datasets[split]
            assert g.vids == w.vids and g.raw_captions == w.raw_captions
            np.testing.assert_array_equal(g.rows, w.rows)
            np.testing.assert_array_equal(g.captions, w.captions)
            gt = B.as_tensor(g.feature_cache())
            wf = np.asarray(w.feature_cache())
            if wf.dtype == BF16:
                np.testing.assert_array_equal(
                    gt.view(torch.int16).numpy(), wf.view(np.int16))
            else:
                np.testing.assert_array_equal(gt.numpy(), wf)


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_a_bundle_packed_from_memory_equals_one_built_from_files(
        fixture_root, tmp_path, store):
    """A host without h5py packs in-memory splits through the writer
    build_bundle feeds from the HDF5 files: the same bytes."""
    from recnet_tpu_torch.data import datasets as D
    tc = _tc(fixture_root, device_feature_cache=store != "float32",
             feature_cache_dtype=store)
    path = B.build_bundle(tc, str(tmp_path / "files" / "key"))
    vocab = B.load_bundle(path).vocab
    splits = {s: (D.load_videos_hdf5(tc.video_fpath(s)),
                  D.load_msvd_captions(tc.caption_fpath(s)))
              for s in B.SPLITS}
    mem = B._pack_in_memory(tc, str(tmp_path / "memory" / "key"), vocab,
                            splits)
    assert _files(mem) == _files(path)


def test_corpus_reads_a_bundle_by_path(fixture_root, tmp_path):
    """A host with the bundle and without the raw files: Corpus(bundle=)
    gives the batches of the corpus that addressed it by key."""
    root = str(tmp_path / "prep")
    shutil.copytree(fixture_root, root)
    tc = _tc(root, data_bundle=True, device_feature_cache=True,
             data_bundle_root=str(tmp_path / "bundles"))
    want = Corpus(tc)
    path = B.bundle_dir(tc)
    shutil.rmtree(os.path.join(root, "MSVD"))
    with pytest.raises(FileNotFoundError):
        Corpus(tc, bundle=str(tmp_path / "nope"))
    got = Corpus(tc, bundle=path)
    assert got.vocab.word2idx == want.vocab.word2idx
    for (v1, r1, c1), (v2, r2, c2) in zip(got.train_batcher,
                                          want.train_batcher):
        assert v1 == v2
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(c1, c2)
    for (v1, x1), (v2, x2) in zip(got.score_batcher, want.score_batcher):
        assert v1 == v2
        np.testing.assert_array_equal(x1, x2)
