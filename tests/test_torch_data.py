"""The port's own copies of the JAX package's jax-free modules (config,
vocab, transforms, datasets, the evaluation corpus, the caption scorers)
against the originals, on the same inputs."""

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest

from recnet_tpu import config as j_config
from recnet_tpu import metrics as j_metrics
from recnet_tpu.data import Corpus as JaxCorpus
from recnet_tpu.data import transforms as j_transforms
from recnet_tpu.data.vocab import Vocab as JaxVocab
from recnet_tpu_torch import config as t_config
from recnet_tpu_torch import metrics as t_metrics
from recnet_tpu_torch.data import Corpus as TorchCorpus
from recnet_tpu_torch.data import transforms as t_transforms
from recnet_tpu_torch.data.vocab import Vocab as TorchVocab

from fixtures import make_msvd_fixture, tiny_train_config

REPO = Path(__file__).resolve().parents[1]
PRESETS = sorted((REPO / "examples").glob("*.json"))


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("msvd_data"))
    make_msvd_fixture(root, n_videos=14, splits=(6, 2, 6))
    return root


@pytest.mark.parametrize("path", PRESETS, ids=lambda p: p.name)
def test_train_config_reads_every_preset_like_jax(path, monkeypatch):
    # a preset without "timestamp" gets the current second in each package:
    # hold the clock, or a second boundary between the two reads fails it
    now = time.gmtime()
    monkeypatch.setattr(time, "gmtime", lambda secs=None: now)
    text = path.read_text()
    want = j_config.TrainConfig.from_json(text)
    got = t_config.TrainConfig.from_json(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.id == want.id
    assert got.video_fpath("test") == want.video_fpath("test")


def test_train_config_reads_a_checkpoints_config_json(fixture_root):
    """A JAX run's config.json (every field written out) reads back field
    by field; replace and validate behave as in JAX."""
    tc = tiny_train_config(fixture_root, decoder_model="LSTM",
                           search_methods=("greedy", ("beam", 3)))
    got = t_config.TrainConfig.from_json(tc.to_json())
    want = j_config.TrainConfig.from_json(tc.to_json())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_json() == want.to_json()
    assert (got.replace(batch_size=7).batch_size
            == want.replace(batch_size=7).batch_size == 7)
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.batch_size = 3


def test_vocab_round_trips_to_the_same_ids(fixture_root):
    tc = tiny_train_config(fixture_root)
    captions = JaxCorpus(tc.replace(
        build_train_data_loader=False, build_val_data_loader=False,
        build_test_data_loader=False,
        build_score_data_loader=False)).vocab
    got = TorchVocab.from_json(captions.to_json())
    assert got.word2idx == captions.word2idx
    assert got.idx2word == captions.idx2word
    assert got.to_json() == captions.to_json()
    words = ["a man is playing guitar", "the dog runs fast", "a a a cat"]
    pipe = t_transforms.sentence_pipeline(10)
    built = TorchVocab({"<PAD>": 0, "<SOS>": 1, "<EOS>": 2}, 1).build(
        words, pipe)
    want = JaxVocab({"<PAD>": 0, "<SOS>": 1, "<EOS>": 2}, 1).build(
        words, j_transforms.sentence_pipeline(10))
    assert built.word2idx == want.word2idx


@pytest.mark.parametrize("method", ["uniform", "random", "uniform_jitter"])
@pytest.mark.parametrize("n_frames", [3, 28, 57])
def test_frame_pipeline_gives_equal_arrays(method, n_frames):
    video = np.random.default_rng(n_frames).standard_normal(
        (n_frames, 16)).astype(np.float64)
    got = t_transforms.frame_pipeline(method, 28,
                                      np.random.default_rng(5))(video)
    want = j_transforms.frame_pipeline(method, 28,
                                       np.random.default_rng(5))(video)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_sentence_and_caption_pipelines_agree():
    s = "A man, is   playing THE guitar!! ¿qué?"
    w2i = {"<PAD>": 0, "<SOS>": 1, "<EOS>": 2, "<UNK>": 3, "a": 4, "man": 5}
    t_pipe = t_transforms.sentence_pipeline(6)
    j_pipe = j_transforms.sentence_pipeline(6)
    assert t_pipe(s) == j_pipe(s)
    np.testing.assert_array_equal(
        t_transforms.caption_pipeline(t_pipe, w2i, 8)(s),
        j_transforms.caption_pipeline(j_pipe, w2i, 8)(s))


def test_corpus_gives_the_same_score_batches(fixture_root):
    """The port's Corpus (plain numpy batching) against the JAX Corpus
    (Batcher, shuffle off): the same vocab, test captions and score
    batches, in the same order, the short last batch padded alike."""
    tc = tiny_train_config(fixture_root, batch_size=4).replace(
        build_train_data_loader=False, build_val_data_loader=False)
    want = JaxCorpus(tc)
    got = TorchCorpus(t_config.TrainConfig.from_json(tc.to_json()))
    assert got.vocab.word2idx == want.vocab.word2idx
    assert (got.test_dataset.video_caption_pairs
            == want.test_dataset.video_caption_pairs)
    got_batches, want_batches = list(got.score_batcher), list(
        want.score_batcher)
    assert len(got_batches) == len(want_batches) == len(got.score_batcher) == 2
    for (g_vids, g_videos), (w_vids, w_videos) in zip(got_batches,
                                                      want_batches):
        assert g_vids == w_vids
        assert g_videos.dtype == w_videos.dtype == np.float32
        np.testing.assert_array_equal(g_videos, w_videos)
    assert got_batches[-1][0][-2:] == ["PAD", "PAD"]


def test_caption_scorer_gives_equal_scores(fixture_root):
    tc = tiny_train_config(fixture_root).replace(
        build_train_data_loader=False, build_val_data_loader=False,
        build_score_data_loader=False)
    pairs = JaxCorpus(tc).test_dataset.video_caption_pairs
    rng = np.random.default_rng(3)
    words = [w for _, c in pairs for w in c.split()]
    predictions = {vid: [" ".join(rng.choice(words, rng.integers(2, 9)))]
                   for vid, _ in pairs}
    scores = {}
    for name, m in (("jax", j_metrics), ("port", t_metrics)):
        scorer = m.CaptionScorer(m.gts_from_pairs(pairs),
                                 m.res_from_dict(predictions))
        scores[name] = (scorer.evaluate(), scorer.imgToEval)
    assert set(scores["port"][0]) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                                      "METEOR", "ROUGE_L", "CIDEr"}
    assert scores["port"] == scores["jax"]
    assert json.dumps(scores["port"][0], sort_keys=True) == json.dumps(
        scores["jax"][0], sort_keys=True)
