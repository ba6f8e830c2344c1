"""Traffic of kind "caption": closed-loop captioning of feature batches
resident on the card through the program's Captioner.

Set-up builds a ``serving.Captioner`` from the configuration (its dtype,
``use_pallas``, ``greedy_segment``; the exact beam search), seeded decoder
weights, and a pool of feature batches on the card; one batch warms up.
Each call decodes one batch: greedy through ``Captioner._decode``, beam
through ``decoding.beam_decode`` with the Captioner's parameters and
settings (what ``_decode`` runs, keeping the beams' scores), and brings
the tokens (and scores) to the host. A call's latency is read from CUDA
events around it on the device's clock. After the window a sample of the
finished rows, drawn from the seed and holding the longest served row, is
checked against the reference along its served tokens.

The configuration's ``dtype`` has to be float32, the reference's. Traffic
keys: batch_size, beam_width (0: greedy), pool_batches, sample_rows,
trace_calls.
"""

from __future__ import annotations

import gc
import time
import types
from typing import Dict, List

import numpy as np
import torch

from h100_bench import oracle, seeded
from h100_bench.reference.decode import logits_along, path_score
from h100_bench.reference.recnet import Products, tf32_off


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device,
                 vocab: int):
        if config["dtype"] != "float32":
            raise ValueError("the caption generator checks float32 decoding "
                             "against its float32 reference only")
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.vocab = torch.device(device), vocab
        self.B, self.K = traffic["batch_size"], traffic["beam_width"]
        self.T = config["caption_max_len"] + 1
        self.eos = dict(map(tuple, config["init_word2idx"]))["<EOS>"]
        self.done: List = []           # (pool index, tokens, scores)
        self.timings: List = []        # CUDA event pairs, or ms on the CPU
        self.window_work = self.trace_work = {}

    def setup(self, parts) -> None:
        with parts("imports"):
            from recnet_tpu_torch import decoding
            from recnet_tpu_torch.config import TrainConfig
            from recnet_tpu_torch.serving import Captioner
        self.decoding = decoding
        c, dev = self.config, self.device
        tc = TrainConfig.from_dict(c)
        with parts("weights"):
            dec = seeded.to_numpy(seeded.decoder_params(
                c, self.vocab, self.seed, dev))
            self.cap = Captioner(
                tc, types.SimpleNamespace(n_vocabs=self.vocab), dec,
                dtype=tc.dtype, batch_size=self.B,
                use_pallas=tc.use_pallas,
                greedy_segment=tc.greedy_segment or None,
                beam_length_margin=None, device=dev)
        with parts("features"):
            self.pool = self._pool()
        with parts("warm_up"):
            self._call(0)
            self.done, self.timings = [], []

    def _pool(self) -> List[torch.Tensor]:
        return [seeded.features(self.config, self.B, self.seed, f"batch{i}",
                                self.device)
                for i in range(self.traffic["pool_batches"])]

    def _decode(self, videos: torch.Tensor):
        """One batch through the program; tokens (B, steps) and, for beams,
        the scores (B, K), on the host."""
        cap = self.cap
        if not self.K:
            return cap._decode(videos, None).T, None
        d = self.decoding
        res = d.beam_decode(
            cap.params, cap.dcfg, videos, self.K, cap.tc.caption_max_len,
            use_pallas_topk=(cap.use_pallas
                             and d.kernels_supported(cap.dcfg, "beam_topk")),
            length_cutoff_margin=cap.beam_length_margin)
        return (res.tokens[:, : res.n_steps].cpu().numpy(),
                res.scores.cpu().numpy())

    def _call(self, i: int) -> None:
        j = i % len(self.pool)
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tokens, scores = self._decode(self.pool[j])
            end.record()
            self.timings.append((start, end))
        else:
            t0 = time.perf_counter()
            tokens, scores = self._decode(self.pool[j])
            self.timings.append((time.perf_counter() - t0) * 1e3)
        self.done.append((j, tokens, scores))

    def _latencies(self) -> List[float]:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return [s.elapsed_time(e) for s, e in self.timings]
        return list(self.timings)

    def window(self, seconds: float) -> Dict[str, float]:
        self.done, self.timings = [], []
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self._call(n)
            n += 1
        elapsed = time.perf_counter() - t0
        lat = self._latencies()
        self.window_work = dict(self._work(), elapsed_s=elapsed)
        return {"captions_per_s": n * self.B / elapsed,
                "caption_batch_p95_ms": float(np.percentile(lat, 95)),
                "batches": n, "batch_p50_ms": float(np.median(lat))}

    def traced_calls(self) -> None:
        self.done, self.timings = [], []
        for i in range(self.traffic["trace_calls"]):
            self._call(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.trace_work = self._work()

    def attempted(self) -> int:
        return len(self.done) * self.B

    def failed(self) -> int:
        return sum(self.B for _, tokens, _ in self.done
                   if tokens.shape[0] != self.B or tokens.shape[1] == 0)

    def counts(self) -> Dict[str, Dict]:
        """The work of the untimed window and of the traced calls."""
        return {"window": self.window_work, "trace": self.trace_work}

    def _work(self) -> Dict:
        """Over the finished calls: captions, the row-steps the decodes
        needed (every row of a batch runs until the batch stops:
        greedy at the step where every row has served its <EOS>, beam at the
        all-<PAD> step), and the projection + top-K calls of the beams'
        steps."""
        steps = []
        for _, tokens, _ in self.done:
            if self.K:
                steps.append(tokens.shape[1])
            else:
                lengths = oracle.served_lengths(tokens, self.eos)
                steps.append(int(min(lengths.max(), tokens.shape[1])))
        rows = self.B * max(self.K, 1)
        return {"captions": len(self.done) * self.B,
                "decode_batch": self.B,
                "decode_batch_steps": steps,
                "decode_row_steps": sum(s * rows for s in steps),
                "topk_calls": sum(steps) if self.K else 0,
                "topk_rows": rows, "beam_width": self.K}

    def free_program(self) -> None:
        self.cap = self.pool = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self):
        """(batch, row) pairs of the finished calls drawn from the seed, the
        longest served row among them."""
        rng = np.random.default_rng(seeded.stream_seed(self.seed, "sample"))
        lengths = np.stack([oracle.served_lengths(t, self.eos)
                            for _, t, _ in self.done])        # (calls, B)
        n = min(self.traffic["sample_rows"], lengths.size)
        flat = rng.choice(lengths.size, n, replace=False)
        longest = int(lengths.argmax())
        if longest not in flat:
            flat[0] = longest
        return [divmod(int(x), self.B) for x in flat]

    def _gathered(self, pairs):
        """Features, served tokens (S, T) (padded with <PAD> past a batch's
        last step), the steps each row's batch ran, and the top beams'
        scores of the sampled rows."""
        feats, rows, tokens, steps = {}, [], [], []
        for b, r in pairs:
            j, toks, _ = self.done[b]
            if j not in feats:
                feats[j] = seeded.features(self.config, self.B, self.seed,
                                           f"batch{j}", self.device)
            rows.append(feats[j][r])
            row = np.full(self.T, seeded.PAD, np.int64)
            row[: toks.shape[1]] = toks[r]
            tokens.append(row)
            steps.append(toks.shape[1])
        scores = (torch.from_numpy(np.stack(
            [self.done[b][2][r, 0] for b, r in pairs])).to(self.device)
            if self.K else None)
        return (torch.stack(rows), torch.from_numpy(np.stack(tokens)).to(
            self.device), np.array(steps), scores)

    def _logits(self, precision: str, enc, tokens) -> torch.Tensor:
        dec = seeded.decoder_params(self.config, self.vocab, self.seed,
                                    self.device)
        with tf32_off():
            return logits_along(dec, self.config, enc, tokens,
                                Products(precision))

    def numbers(self) -> Dict[str, float]:
        """The served rows of the sample against the reference."""
        enc, tokens, steps, scores = self._gathered(self._sample())
        ref = self._logits("float32", enc, tokens)
        served = np.minimum(oracle.served_lengths(tokens.cpu().numpy(),
                                                  self.eos), steps)
        self.checked = (enc, tokens, served, scores, ref)
        if not self.K:
            return {"token_gap": oracle.greedy_gap(ref, tokens, served)}
        if (steps != self.T).any():        # the exact search runs every step
            return {"topk_gap": float("inf"), "score_gap": float("inf")}
        return {"topk_gap": oracle.topk_gap(ref, tokens, self.K),
                "score_gap": oracle.score_gap(
                    scores, path_score(ref, tokens, self.eos))}

    def control_numbers(self) -> Dict[str, Dict[str, float]]:
        """The control (the reference in TF32 at the same rows and
        tokens) and a served token altered where it is produced."""
        enc, tokens, served, scores, ref = self.checked
        ctl = self._logits("tf32", enc, tokens)
        altered = tokens.clone()
        altered[:, 0] = (altered[:, 0] + 1) % self.vocab
        if not self.K:
            return {"control_tf32": {"token_gap": oracle.greedy_gap(
                        ref, ctl.argmax(-1), served)},
                    "fault_token_altered": {"token_gap": oracle.greedy_gap(
                        ref, altered, served)}}
        ref_score = path_score(ref, tokens, self.eos)
        return {"control_tf32": {
                    "topk_gap": oracle.control_topk_gap(ref, ctl, self.K),
                    "score_gap": oracle.score_gap(
                        path_score(ctl, tokens, self.eos), ref_score)},
                "fault_token_altered": {
                    "topk_gap": oracle.topk_gap(ref, altered, self.K),
                    "score_gap": oracle.score_gap(
                        scores, path_score(ref, altered, self.eos))}}
