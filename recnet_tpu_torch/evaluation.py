"""Test-set decoding and scoring: the reference's evaluate() (eval.py:123-169).

Port of ``recnet_tpu.evaluation``. Decodes the score batches with greedy or
beam search on the device the decoder params lie on, truncates to the first
``n_test`` videos, writes predictions.txt and scores with the port's
copy of the JAX package's scorer (``recnet_tpu_torch.metrics``). ``use_pallas`` routes greedy to the
whole-decode kernels (K1, or K2 with ``greedy_segment``) and beam to the
projection + top-K kernel (K3), as in the JAX package. With
``device_feature_cache`` and uniform frame sampling, the score split goes
to the params' device once (``Corpus.score_batches_device``) and every
later call decodes from there.

On a process group's mesh every rank decodes the whole split on its own
device, as the JAX package's replicated program does (the params' vocabulary
shards gathered over 'model' first), and only the primary scores; the
device feature cache stays off there.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from recnet_tpu_torch.decoding import (beam_decode, greedy_decode,
                                       greedy_decode_whole,
                                       greedy_decode_whole_segmented,
                                       kernels_supported, tokens_to_sentences)
from recnet_tpu_torch.metrics import (CaptionScorer, gts_from_pairs,
                                     res_from_dict)
from recnet_tpu_torch.parallel import mesh as mesh_lib


def decode_batch(decoder_params, dcfg, videos, search_method, max_len: int,
                 use_pallas: bool = False, mesh=None,
                 greedy_segment: int = 0) -> np.ndarray:
    """Decode one batch of videos (B, L, F), numpy or a tensor, on the
    params' device and in their dtype. Returns (n_steps, B) int tokens,
    truncated like the reference.

    ``mesh``: a process group's mesh; the rank decodes the whole batch,
    its vocabulary shards gathered over 'model' first (every rank of the
    group calls it)."""
    decoder_params = mesh_lib.gather_params(decoder_params, mesh,
                                            dcfg.vocab_size)
    out_w = decoder_params["out_w"]
    videos = torch.as_tensor(videos).to(out_w.device, out_w.dtype)
    if isinstance(search_method, str) and search_method == "greedy":
        if use_pallas and kernels_supported(dcfg, "greedy_whole"):
            if greedy_segment:
                # eos_stop is sentence-exact: every consumer cuts a row at
                # its first <EOS>, and greedy rows are independent
                res = greedy_decode_whole_segmented(
                    decoder_params, dcfg, videos, max_len,
                    segment=greedy_segment, eos_stop=True)
            else:
                res = greedy_decode_whole(decoder_params, dcfg, videos,
                                          max_len)
        else:
            res = greedy_decode(decoder_params, dcfg, videos, max_len)
        return res.tokens[: res.n_steps].cpu().numpy()
    if isinstance(search_method, (tuple, list)) and search_method[0] == "beam":
        res = beam_decode(
            decoder_params, dcfg, videos, int(search_method[1]), max_len,
            use_pallas_topk=(use_pallas
                             and kernels_supported(dcfg, "beam_topk")))
        # the reference transposes the (B, n) beam output (eval.py:148-149)
        return res.tokens[:, : res.n_steps].T.cpu().numpy()
    raise NotImplementedError(f"Unknown search method: {search_method}")


def evaluate(tc, corpus, decoder_params, dcfg, search_method,
             predictions_fpath: Optional[str] = "predictions.txt",
             n_test: Optional[int] = None, mesh=None,
             score_on_host: bool = True) -> Dict[str, float]:
    """Decode the whole score set and score it (reference eval.py:123-169).

    ``corpus`` needs ``score_batcher`` (an iterable of (vids, videos)
    batches), ``vocab`` and ``test_dataset.video_caption_pairs``, as
    ``recnet_tpu_torch.data.Corpus`` has. ``score_on_host=False`` writes the
    predictions and returns ``{}`` without scoring: the non-primary ranks
    of a process group's ``mesh``, which decode the split as well."""
    n_test = n_test if n_test is not None else tc.n_test
    eos = corpus.vocab.word2idx["<EOS>"]
    decoder_params = mesh_lib.gather_params(decoder_params, mesh,
                                            dcfg.vocab_size)

    # device-resident score features: one upload reused across the
    # periodic test passes (deterministic sampling only; not on a mesh)
    batches = corpus.score_batcher
    if (getattr(tc, "device_feature_cache", False) and mesh is None
            and tc.frame_sampling_method == "uniform"
            and hasattr(corpus, "score_batches_device")):
        batches = corpus.score_batches_device(
            decoder_params["out_w"].device)

    total_vids, total_pd = [], []
    for vids, videos in batches:
        tokens = decode_batch(decoder_params, dcfg, videos, search_method,
                              tc.caption_max_len,
                              use_pallas=getattr(tc, "use_pallas", False),
                              mesh=mesh,
                              greedy_segment=getattr(tc, "greedy_segment", 0))
        total_vids += list(vids)
        total_pd += tokens_to_sentences(tokens, corpus.vocab.idx2word, eos)

    total_vids = total_vids[:n_test]
    total_pd = total_pd[:n_test]

    if predictions_fpath:
        with open(predictions_fpath, "w") as fout:
            for vid, caption in zip(total_vids, total_pd):
                fout.write("{}\t\t{}\n".format(vid, caption))

    if not score_on_host:
        return {}

    pd_dict = defaultdict(list)
    for vid, caption in zip(total_vids, total_pd):
        if vid != "PAD":                     # batch padding (Batcher)
            pd_dict[vid].append(caption)

    gts = gts_from_pairs(
        [(vid, cap) for vid, cap in corpus.test_dataset.video_caption_pairs])
    res = res_from_dict(pd_dict)
    ids = [i for i in gts.keys() if i in res]
    scorer = CaptionScorer(gts, res, image_ids=ids,
                           meteor_version=getattr(tc, "meteor_version",
                                                  "2007"))
    return scorer.evaluate()
