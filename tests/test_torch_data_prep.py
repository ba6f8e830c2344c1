"""The port's data preparation (data/split.py with cli/split.py,
data/concat_features.py) against the JAX package's on the same inputs:
the files they write hold the same datasets, keys, dtypes and values
(mirror of the split and concat cases of tests/test_data.py); and
evaluate's device feature cache: the score split goes to the device once
and is reused, in float32, with predictions equal to the JAX package's
(mirror of test_score_batches_device_stay_float32_and_memoize)."""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

import h5py
import jax

from fixtures import make_msrvtt_fixture, make_msvd_fixture, tiny_train_config
from recnet_tpu import config as j_config
from recnet_tpu.cli import split as j_split_cli
from recnet_tpu.data import Corpus as JaxCorpus
from recnet_tpu.data import split as j_split
from recnet_tpu.data.concat_features import concat_features as j_concat
from recnet_tpu.evaluation import evaluate as j_evaluate
from recnet_tpu.training.step import init_train_state
from recnet_tpu_torch import config as t_config
from recnet_tpu_torch import evaluation as t_eval
from recnet_tpu_torch.cli import split as t_split_cli
from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.data import Corpus
from recnet_tpu_torch.data import split as t_split
from recnet_tpu_torch.data.concat_features import concat_features
from recnet_tpu_torch.models.decoder import config_from_train
from recnet_tpu_torch.weights import params_from_jax


def _h5(path):
    """{key: (dtype, shape, values)} of an HDF5 file, in key order."""
    with h5py.File(path, "r") as f:
        return [(k, f[k].dtype, f[k].shape, np.asarray(f[k])) for k in f]


def _assert_same_h5(got, want):
    a, b = _h5(got), _h5(want)
    assert [x[:3] for x in a] == [x[:3] for x in b], got
    for (k, _, _, x), (_, _, _, y) in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg=f"{got}:{k}")


def _drop_split_files(root, corpus):
    """Leave only the full HDF5 and the full caption file."""
    for f in glob.glob(os.path.join(root, corpus, "features", "Tiny_*.hdf5")):
        os.remove(f)
    full = {"MSVD": "MSR Video Description Corpus.csv",
            "MSR-VTT": "videodatainfo.json"}[corpus]
    for f in glob.glob(os.path.join(root, corpus, "metadata", "*")):
        if not f.endswith(full):
            os.remove(f)


def _two_roots(tmp_path, corpus):
    make = make_msvd_fixture if corpus == "MSVD" else make_msrvtt_fixture
    src = str(tmp_path / "src")
    make(src)
    _drop_split_files(src, corpus)
    roots = str(tmp_path / "jax"), str(tmp_path / "port")
    for root in roots:
        shutil.copytree(src, root)
    return roots


@pytest.mark.parametrize("corpus,sizes", [
    ("MSVD", None), ("MSVD", (8, 2, 2)), ("MSR-VTT", None)],
    ids=["msvd-cli", "msvd-8-2-2", "msrvtt-cli"])
def test_splitters_write_the_jax_files(tmp_path, corpus, sizes):
    """Both splitters on copies of one corpus: equal HDF5 files and
    byte-equal caption files for every split; the port's corpus reads
    its own split back (cli.split: the JAX SplitConfig's default sizes,
    1200/100/670; or 8/2/2 through data.split.split)."""
    jroot, troot = _two_roots(tmp_path, corpus)
    if sizes is None:
        argv = ["--corpus", corpus, "--encoder", "Tiny", "--data_root"]
        j_split_cli.main(argv + [jroot])
        t_split_cli.main(argv + [troot])
    else:
        kw = dict(corpus=corpus, encoder_model="Tiny",
                  n_train=sizes[0], n_val=sizes[1], n_test=sizes[2])
        j_split.split(j_config.SplitConfig(data_root=jroot, **kw))
        t_split.split(t_config.SplitConfig(data_root=troot, **kw))
    tcfg = t_config.SplitConfig(data_root=troot, corpus=corpus,
                                encoder_model="Tiny")
    jcfg = j_config.SplitConfig(data_root=jroot, corpus=corpus,
                                encoder_model="Tiny")
    for split in ("train", "val", "test"):
        _assert_same_h5(tcfg.split_video_fpath(split),
                        jcfg.split_video_fpath(split))
        with open(tcfg.split_metadata_fpath(split), "rb") as f, \
                open(jcfg.split_metadata_fpath(split), "rb") as g:
            assert f.read() == g.read(), split
    if corpus == "MSR-VTT" or sizes is not None:
        tc = TrainConfig.from_json(tiny_train_config(
            troot, corpus=corpus).to_json())
        port = Corpus(tc)
        jax_corpus = JaxCorpus(tiny_train_config(jroot, corpus=corpus))
        assert len(port.train_dataset) == len(jax_corpus.train_dataset) > 0
        assert len(port.score_dataset) == len(jax_corpus.score_dataset) > 0
        vid, video, _ = port.train_dataset.get(0)
        assert video.shape == (tc.encoder_output_len, tc.encoder_output_size)


def test_concat_features(tmp_path):
    rng = np.random.default_rng(0)
    a, b = str(tmp_path / "a.hdf5"), str(tmp_path / "b.hdf5")
    with h5py.File(a, "w") as f:
        f["v1"] = rng.standard_normal((10, 4)).astype(np.float32)
        f["v2"] = rng.standard_normal((6, 4)).astype(np.float32)
        f["only_a"] = rng.standard_normal((3, 4)).astype(np.float32)
    with h5py.File(b, "w") as f:
        f["v1"] = rng.standard_normal((5, 6)).astype(np.float32)
        f["v2"] = rng.standard_normal((6, 6)).astype(np.float32)
    out, jout = str(tmp_path / "o.hdf5"), str(tmp_path / "jo.hdf5")
    assert concat_features(a, b, out) == j_concat(a, b, jout) == 2
    _assert_same_h5(out, jout)
    with h5py.File(out, "r") as f:
        assert f["v1"].shape == (10, 10)   # b resampled to 10 frames
        assert f["v2"].shape == (6, 10)
        assert "only_a" not in f


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("msvd_eval_cache"))
    make_msvd_fixture(root, n_videos=14, splits=(6, 2, 6))
    return root


def test_score_batches_device_stay_float32_and_memoize(fixture_root):
    """The device-resident score features stay float32 whatever
    feature_cache_dtype says (eval decodes them directly), are uploaded
    once a device and equal the JAX package's."""
    jtc = tiny_train_config(fixture_root, device_feature_cache=True,
                            feature_cache_dtype="bfloat16")
    corpus = Corpus(TrainConfig.from_json(jtc.to_json()))
    batches = corpus.score_batches_device("cpu")
    want = JaxCorpus(jtc).score_batches_device()
    assert batches and len(batches) == len(want)
    for (vids, videos), (jvids, jvideos) in zip(batches, want):
        assert vids == jvids
        assert videos.dtype == torch.float32
        np.testing.assert_array_equal(videos.numpy(), np.asarray(jvideos))
    assert corpus.score_batches_device("cpu") is batches
    assert corpus.score_uploads == 1


@pytest.mark.parametrize("search", ["greedy", ("beam", 2)],
                         ids=["greedy", "beam2"])
def test_evaluate_uploads_the_score_split_once(fixture_root, tmp_path,
                                               search):
    """Two evaluate calls with the device feature cache (as the loop's
    periodic test passes make them): one upload, and each call's
    predictions.txt and scores equal the JAX package's evaluate with its
    cache."""
    jtc = tiny_train_config(fixture_root, device_feature_cache=True,
                            build_train_data_loader=False,
                            build_val_data_loader=False)
    jcorpus = JaxCorpus(jtc)
    state, _, _ = init_train_state(jax.random.PRNGKey(0), jtc,
                                   jcorpus.vocab.n_vocabs)
    dec = dict(state.dec_params, out_w=state.dec_params["out_w"] * 8.0)
    _, jdcfg, _ = init_train_state(jax.random.PRNGKey(0), jtc,
                                   jcorpus.vocab.n_vocabs)
    want = j_evaluate(jtc, jcorpus, dec, jdcfg, search,
                      predictions_fpath=str(tmp_path / "jax.txt"))

    tc = TrainConfig.from_json(jtc.to_json())
    corpus = Corpus(tc)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, dec), "cpu")
    dcfg = config_from_train(tc, corpus.vocab.n_vocabs)
    for i in range(2):
        got = t_eval.evaluate(tc, corpus, params, dcfg, search,
                              predictions_fpath=str(tmp_path / f"{i}.txt"))
        assert got == want
        assert (tmp_path / f"{i}.txt").read_bytes() == \
            (tmp_path / "jax.txt").read_bytes()
    assert corpus.score_uploads == 1
