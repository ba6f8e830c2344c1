"""The training loop: the reference's train.py main() (train.py:200-427).

Port of ``recnet_tpu.training.loop`` around the eager train step, the
prefetching batcher and the device feature cache. The cadences are the
reference's: log every ``log_every`` iterations with the loss summed over
them and divided by log_every * batch_size (train.py:281-306), a full val
pass with ground-truth-against-predicted caption text every
``validate_every`` (train.py:310-372), a test-set decode and score for
every search method every ``test_every`` (train.py:376-394), a checkpoint
every ``save_every`` (train.py:397-420). With ``steps_per_dispatch`` k > 1
a dispatch runs k steps and every cadence lands on a multiple of k
(``TrainConfig.validate``). Also from the JAX package: resume from a
checkpoint, the emergency checkpoint and abort on a non-finite loss,
checkpoint retention and a ``torch.profiler`` window.

One device, one process: the mesh and multi-host paths are not ported yet
(ROADMAP Queue 1, item 9) and raise.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from recnet_tpu_torch import checkpoint as ckpt
from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.data import Corpus, cycle, prefetch_to_device
from recnet_tpu_torch.data.bundle import as_tensor
from recnet_tpu_torch.decoding import tokens_to_sentences
from recnet_tpu_torch.evaluation import evaluate
from recnet_tpu_torch.training.step import (
    build_train_multi_step, build_train_multi_step_cached, build_train_step,
    build_train_step_cached, build_val_step, build_val_step_cached,
    check_device, init_train_state)
from recnet_tpu_torch.utils.logging import MetricWriter
from recnet_tpu_torch.utils.misc import tree_fill, tree_leaves
from recnet_tpu_torch.utils.profiling import start_trace, stop_trace

# time to the first iteration of the latest train() call in this process
# (corpus, state init, cache uploads); benchmark scripts read it
LAST_SETUP_SECONDS: float = float("nan")

_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def train(tc: TrainConfig, debug: bool = False, loss_only: bool = False,
          resume_from: Optional[str] = None, use_mesh: bool = False,
          log_dir: Optional[str] = None, save_dir: Optional[str] = None,
          profile_dir: Optional[str] = None,
          profile_window: tuple = (10, 14), keep_last_k: int = 0,
          corpus=None, device="cuda"):
    """Run the training loop on ``device`` (the card unless the caller asks
    for "cpu"); returns the final ``TrainState``. ``corpus`` defaults to
    ``Corpus(tc)``, read from the raw files or, with ``tc.data_bundle``,
    from the preprocessed bundle; any object with the same attributes (an
    in-memory ``Corpus``) does."""
    if use_mesh:
        raise NotImplementedError(
            "mesh and multi-host training are not ported yet (ROADMAP "
            "Queue 1, item 9, multi-GPU); train on one device")
    device = check_device(device)
    tc.validate(debug=debug)
    k = int(tc.steps_per_dispatch)
    t_setup = time.time()
    stages, t_mark = [], t_setup

    def mark(name):
        nonlocal t_mark
        now = time.time()
        stages.append((name, now - t_mark))
        t_mark = now

    print(f"MODEL ID: {tc.id}")
    print(f"DEBUG MODE: {'ON' if debug else 'OFF'}")
    log_dir = log_dir or tc.log_dpath
    save_dir = save_dir or tc.save_dpath
    writer = None if debug else MetricWriter(log_dir)

    corpus = corpus if corpus is not None else Corpus(tc)
    vocab = corpus.vocab
    print("#vocabs: {}, #words: {}. Trim words which appear less than {} "
          "times.".format(vocab.n_vocabs, vocab.n_words, tc.min_count))
    mark("corpus")

    use_cache = bool(tc.device_feature_cache)
    cache_dtype = _CACHE_DTYPES[tc.feature_cache_dtype]

    def device_cache(dataset, what):
        # half-width storage halves the upload and the residency; the
        # steps widen gathered rows back to float32 (step.gather_f32); a
        # bundle built for this config stores the dtype already
        x = as_tensor(dataset.feature_cache()).to(cache_dtype)
        if (cache_dtype == torch.float16
                and not bool(torch.isfinite(x).all())):
            raise ValueError(
                "feature_cache_dtype='float16' overflowed: features exceed "
                "the f16 range (+-65504); use 'bfloat16' instead")
        print(f"device feature cache ({what}): {tuple(x.shape)} "
              f"{tc.feature_cache_dtype} "
              f"({x.numel() * x.element_size() / 2 ** 20:.0f} MiB on "
              f"{device})")
        return x.to(device)

    state, dcfg, rcfg = init_train_state(tc.seed, tc, vocab.n_vocabs, device)
    mark("state-init")
    if resume_from:
        state, meta = ckpt.load_checkpoint(resume_from, tc, vocab.n_vocabs,
                                           device)
        print(f"Resumed from {resume_from} at step {meta['step']}")

    if use_cache:
        cache = device_cache(corpus.train_dataset, "train")
        cached = (build_train_step_cached(tc, dcfg, rcfg) if k == 1
                  else build_train_multi_step_cached(tc, dcfg, rcfg, k))
        # the same call shape as the uncached step: "videos" are the (B,)
        # or (k, B) row indices; the cache never leaves the card
        train_step = lambda s, rows, caps: cached(s, cache, rows, caps)
    else:
        train_step = (build_train_step(tc, dcfg, rcfg) if k == 1
                      else build_train_multi_step(tc, dcfg, rcfg, k))
    if use_cache and corpus.val_batcher is not None:
        val_cache = device_cache(corpus.val_dataset, "val")
        val_cached = build_val_step_cached(tc, dcfg, rcfg)
        val_step = lambda dp, rp, rows, caps: val_cached(dp, rp, val_cache,
                                                         rows, caps)
    else:
        val_step = build_val_step(tc, dcfg, rcfg)
    mark("caches")

    def device_batches():
        pairs = ((videos, captions)
                 for _, videos, captions in cycle(corpus.train_batcher))
        if k > 1:
            def chunked(src):
                while True:
                    chunk = [next(src) for _ in range(k)]
                    yield (np.stack([p[0] for p in chunk]),
                           np.stack([p[1] for p in chunk]))
            pairs = chunked(pairs)
        return prefetch_to_device(pairs, tc.prefetch_depth, device)

    global LAST_SETUP_SECONDS
    LAST_SETUP_SECONDS = time.time() - t_setup
    mark("rest")
    print(f"[setup] corpus + state ready in {LAST_SETUP_SECONDS:.1f}s (" +
          " | ".join(f"{n} {dt:.1f}s" for n, dt in stages if dt >= 0.05)
          + ")")

    train_loss = train_dec = train_rec = 0.0
    t_start = time.time()
    iteration = state.step
    batches = device_batches()
    prof = None
    try:
        for videos, captions in batches:
            # the torch.profiler window; with k > 1 it snaps to dispatches
            if (profile_dir and prof is None
                    and iteration < profile_window[0] <= iteration + k):
                prof = start_trace()
            elif (profile_dir and prof is not None
                    and profile_window[1] <= iteration + k):
                print(f"[profile] {stop_trace(prof, profile_dir)}")
                prof = None
            metrics = train_step(state, videos, captions)
            iteration += k
            # summed on the card; only the log cadence waits for it (the
            # reference's loss.item() synced every iteration)
            reduce = (lambda x: x) if k == 1 else torch.sum
            train_loss = train_loss + reduce(metrics["loss"])
            train_dec = train_dec + reduce(metrics["dec_loss"])
            train_rec = train_rec + reduce(metrics["rec_loss"])

            if debug or iteration % tc.log_every == 0:
                n = tc.log_every * tc.batch_size
                train_loss = float(train_loss) / n
                train_dec = float(train_dec) / n
                train_rec = float(train_rec) / n
                if not np.isfinite(train_loss):
                    path = ckpt.save_checkpoint(
                        save_dir, iteration, state, tc, vocab,
                        extra={"emergency": True, "loss": train_loss})
                    raise FloatingPointError(
                        f"non-finite training loss {train_loss} at "
                        f"iteration {iteration}; emergency checkpoint saved "
                        f"to {path}")
                dt = time.time() - t_start
                steps_sec = (tc.log_every if not debug else 1) / max(dt, 1e-9)
                if writer:
                    writer.scalar(tc.tx_train_loss, train_loss, iteration)
                    writer.scalar(tc.tx_lambda_decoder, tc.decoder_lambda_reg,
                                  iteration)
                    writer.scalar("perf/steps_per_sec", steps_sec, iteration)
                    if tc.use_recon:
                        writer.scalar(tc.tx_train_loss_decoder, train_dec,
                                      iteration)
                        writer.scalar(tc.tx_train_loss_reconstructor,
                                      train_rec, iteration)
                        writer.scalar(tc.tx_lambda_reconstructor,
                                      tc.reconstructor_lambda_reg, iteration)
                        writer.scalar(tc.tx_lambda, tc.lambda_recon,
                                      iteration)
                msg = "Iter {} / {} ({:.1f}%): loss {:.5f}".format(
                    iteration, tc.n_iterations,
                    iteration / tc.n_iterations * 100, train_loss)
                if tc.use_recon:
                    msg += " (dec {:.5f} + rec {:.5f})".format(train_dec,
                                                               train_rec)
                print(msg + " [{:.1f} it/s]".format(steps_sec))
                train_loss = train_dec = train_rec = 0.0
                t_start = time.time()

            if debug or iteration % tc.validate_every == 0:
                _validate(tc, corpus, state, val_step, writer, iteration,
                          device)
            if not loss_only and (debug or iteration % tc.test_every == 0):
                _test(tc, corpus, state, dcfg, writer, iteration)
            if iteration % tc.save_every == 0:
                path = ckpt.save_checkpoint(save_dir, iteration, state, tc,
                                            vocab)
                if keep_last_k:
                    ckpt.prune_old(save_dir, keep_last_k)
                print(f"Saved checkpoint: {path}")
            if iteration >= tc.n_iterations:
                break
    finally:
        if prof is not None:
            stop_trace(prof, profile_dir)
        batches.close()
    if writer:
        writer.close()
    return state


def _validate(tc, corpus, state, val_step, writer, iteration, device):
    val_loss = val_dec = val_rec = 0.0
    gt_captions, pd_captions = [], []
    n_batches = 0
    eos = corpus.vocab.word2idx["<EOS>"]
    put = lambda x: torch.from_numpy(np.asarray(x)).to(device)
    for _, videos, captions in corpus.val_batcher:
        m = val_step(state.dec_params, state.rec_params, put(videos),
                     put(captions))
        val_loss += float(m["loss"]) * tc.batch_size
        val_dec += float(m["dec_loss"]) * tc.batch_size
        val_rec += float(m["rec_loss"]) * tc.batch_size
        n_batches += 1
        gt_captions += tokens_to_sentences(captions, corpus.vocab.idx2word,
                                           eos)
        pd_captions += tokens_to_sentences(m["greedy_tokens"].cpu().numpy(),
                                           corpus.vocab.idx2word, eos)
    n_vals = max(n_batches * tc.batch_size, 1)
    val_loss /= n_vals
    val_dec /= n_vals
    val_rec /= n_vals
    msg = "[Validation] Iter {} / {} ({:.1f}%): loss {:.5f}".format(
        iteration, tc.n_iterations, iteration / tc.n_iterations * 100,
        val_loss)
    if tc.use_recon:
        msg += " (dec {:.5f} + rec {:5f})".format(val_dec, val_rec)
    print(msg)
    if writer:
        writer.scalar(tc.tx_val_loss, val_loss, iteration)
        if tc.use_recon:
            writer.scalar(tc.tx_val_loss_decoder, val_dec, iteration)
            writer.scalar(tc.tx_val_loss_reconstructor, val_rec, iteration)
        writer.text(tc.tx_predicted_captions, "\n\n".join(
            "[GT] {}  \n[PD] {}".format(gt, pd)
            for gt, pd in zip(gt_captions, pd_captions)), iteration)


def _test(tc, corpus, state, dcfg, writer, iteration):
    print("[Test] Iter {} / {} ({:.1f}%)".format(
        iteration, tc.n_iterations, iteration / tc.n_iterations * 100))
    # the decoders read the params without autograd
    params = tree_fill(state.dec_params,
                       iter([p.detach() for p in tree_leaves(
                           state.dec_params)]))
    for search_method in tc.search_methods:
        sm_id = tc.search_method_id(search_method)
        scores = evaluate(tc, corpus, params, dcfg, search_method,
                          predictions_fpath="predictions.txt")
        print("\t{}: {}".format(sm_id, " ".join(
            "{}: {:.3f}".format(s, scores[s]) for s in tc.scores
            if s in scores)))
        if writer:
            for s in tc.scores:
                if s in scores:
                    writer.scalar(tc.tx_score(sm_id, s), scores[s], iteration)
