"""The port's evaluation and eval CLI against JAX ``evaluate`` on the CPU.

A JAX-initialised decoder (out_w x 8, so captions end and candidate
margins are clear) is saved with ``recnet_tpu.checkpoint`` on the MSVD
fixture corpus. The port's ``cli.eval`` reads that checkpoint and must
write a predictions.txt byte-equal to the one JAX ``evaluate`` writes from
the same params, with the same scores, for greedy and beam. With
``use_pallas`` the port runs the plain twins of K2 and K3 here; JAX runs
its XLA paths, since ``pallas_supported`` is False off the TPU."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from recnet_tpu import checkpoint as j_ckpt
from recnet_tpu.data import Corpus
from recnet_tpu.evaluation import evaluate as j_evaluate
from recnet_tpu.training.step import init_train_state
from recnet_tpu_torch import evaluation as t_eval
from recnet_tpu_torch.cli.eval import main as eval_main
from recnet_tpu_torch.models.decoder import DecoderConfig

from fixtures import make_msvd_fixture, tiny_train_config


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "use_pallas"])
def saved(request, tmp_path_factory):
    """(checkpoint dir, TrainConfig, decoder params) of a peaky decoder;
    use_pallas checkpoints also carry greedy_segment=4."""
    root = str(tmp_path_factory.mktemp("msvd"))
    make_msvd_fixture(root)
    kw = dict(use_pallas=True, greedy_segment=4) if request.param else {}
    tc = tiny_train_config(root, **kw)
    vocab = Corpus(tc).vocab
    state, _, _ = init_train_state(jax.random.PRNGKey(0), tc, vocab.n_vocabs)
    dec = dict(state.dec_params, out_w=state.dec_params["out_w"] * 8.0)
    state = state._replace(dec_params=dec)
    d = j_ckpt.save_checkpoint(str(tmp_path_factory.mktemp("ck")), 1, state,
                               tc, vocab)
    return d, tc, dec


@pytest.mark.parametrize("search", ["greedy", ("beam", 2)],
                         ids=["greedy", "beam2"])
def test_eval_cli_matches_jax_evaluate(saved, search, tmp_path, monkeypatch):
    d, tc, dec = saved
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()

    tc_eval = tc.replace(build_train_data_loader=False,
                         build_val_data_loader=False, data_bundle=False)
    _, dcfg, _ = init_train_state(jax.random.PRNGKey(0), tc_eval,
                                  Corpus(tc_eval).vocab.n_vocabs)
    want = j_evaluate(tc_eval, Corpus(tc_eval), dec, dcfg, search,
                      predictions_fpath=str(jax_dir / "predictions.txt"))

    monkeypatch.chdir(port_dir)
    argv = ["--ckpt", d, "--device", "cpu"]
    argv += ["--greedy"] if search == "greedy" else ["--beam", "2"]
    got = eval_main(argv)

    lines = (port_dir / "predictions.txt").read_bytes()
    assert lines == (jax_dir / "predictions.txt").read_bytes()
    # 2 test videos and 2 <PAD> rows of batch padding, none of them scored
    assert [line.split(b"\t\t")[0] for line in lines.splitlines()][2:] \
        == [b"PAD", b"PAD"]
    assert got == want
    assert set(tc.scores) <= set(got)
    assert all(np.isfinite(v) for v in got.values())


def _fake(name, captured, n_steps=3):
    def decode(params, dcfg, videos, *args, **kw):
        captured["fn"] = name
        captured["device"] = videos.device
        captured.update(kw)
        B = videos.shape[0]
        if name == "beam":
            tokens = torch.zeros((B, n_steps + 2), dtype=torch.int32)
        else:
            tokens = torch.zeros((n_steps + 2, B), dtype=torch.int32)
        return types.SimpleNamespace(tokens=tokens, n_steps=n_steps)
    return decode


def test_decode_batch_forwards_use_pallas_and_greedy_segment(monkeypatch):
    """use_pallas reaches beam_decode's use_pallas_topk; with use_pallas,
    greedy_segment picks the K2 segments (eos_stop) and 0 picks K1; the
    output is (n_steps, B) either way."""
    captured = {}
    for fn, name in (("beam_decode", "beam"), ("greedy_decode", "greedy"),
                     ("greedy_decode_whole", "whole"),
                     ("greedy_decode_whole_segmented", "segmented")):
        monkeypatch.setattr(t_eval, fn, _fake(name, captured))
    params = {"out_w": torch.zeros(4, 5)}
    videos = np.zeros((2, 3, 4), np.float32)
    for cell in ("GRU", "LSTM"):
        cfg = DecoderConfig(cell_type=cell)
        for use_pallas in (True, False):
            out = t_eval.decode_batch(params, cfg, videos, ("beam", 5), 4,
                                      use_pallas=use_pallas)
            assert captured.pop("fn") == "beam"
            assert captured["use_pallas_topk"] is use_pallas
            assert out.shape == (3, 2)
        out = t_eval.decode_batch(params, cfg, videos, "greedy", 4,
                                  use_pallas=True, greedy_segment=4)
        assert captured.pop("fn") == "segmented"
        assert captured["segment"] == 4 and captured["eos_stop"] is True
        assert out.shape == (3, 2)
        t_eval.decode_batch(params, cfg, videos, "greedy", 4,
                            use_pallas=True, greedy_segment=0)
        assert captured.pop("fn") == "whole"
        t_eval.decode_batch(params, cfg, videos, "greedy", 4,
                            use_pallas=False, greedy_segment=4)
        assert captured.pop("fn") == "greedy"
    # two layers: no whole-decode kernel, the plain greedy loop
    t_eval.decode_batch(params, DecoderConfig(n_layers=2), videos, "greedy",
                        4, use_pallas=True)
    assert captured.pop("fn") == "greedy"
    assert captured["device"] == torch.device("cpu")
    with pytest.raises(NotImplementedError):
        t_eval.decode_batch(params, DecoderConfig(), videos, "sample", 4)


def test_evaluate_on_an_in_memory_corpus(tmp_path):
    """evaluate needs only score_batcher, vocab and the test pairs; n_test
    cuts the <PAD> vids of batch padding."""
    from recnet_tpu.config import TrainConfig
    from recnet_tpu.data.vocab import Vocab
    from recnet_tpu_torch.models.decoder import config_from_train
    from recnet_tpu_torch.weights import params_from_jax, random_params

    tc = TrainConfig(embedding_size=12, encoder_output_size=16,
                     encoder_output_len=5, decoder_hidden_size=16,
                     decoder_attn_size=8, caption_max_len=6)
    vocab = Vocab(tc.init_word2idx_dict).build(["a cat runs fast"],
                                               str.split)
    params = params_from_jax(random_params(
        config_from_train(tc, vocab.n_vocabs), 0))
    rng = np.random.default_rng(0)
    vids = [f"v{i}" for i in range(5)]
    batches = [(vids[:4], rng.standard_normal((4, 5, 16)).astype(np.float32)),
               (vids[4:] + ["PAD"] * 3,
                rng.standard_normal((4, 5, 16)).astype(np.float32))]
    corpus = types.SimpleNamespace(
        score_batcher=batches, vocab=vocab,
        test_dataset=types.SimpleNamespace(
            video_caption_pairs=[(v, "a cat runs") for v in vids]))
    pred = tmp_path / "predictions.txt"
    scores = t_eval.evaluate(tc, corpus, params,
                             config_from_train(tc, vocab.n_vocabs),
                             ("beam", 3), predictions_fpath=str(pred),
                             n_test=5)
    lines = pred.read_text().splitlines()
    assert [line.split("\t\t")[0] for line in lines] == vids
    assert all(np.isfinite(v) for v in scores.values())
    assert t_eval.evaluate(tc, corpus, params,
                           config_from_train(tc, vocab.n_vocabs), "greedy",
                           predictions_fpath=None, score_on_host=False) == {}


def test_eval_and_caption_imports_leave_jax_out():
    code = ("import sys\n"
            "import recnet_tpu_torch.evaluation, recnet_tpu_torch.cli.eval\n"
            "import recnet_tpu_torch.cli.caption\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
