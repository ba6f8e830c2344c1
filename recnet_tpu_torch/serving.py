"""Serving API: load a checkpoint, caption feature batches at throughput.

Port of ``recnet_tpu.serving``: a ``Captioner`` that pads requests to
power-of-two buckets and decodes them on an explicit ``device``, and a
``MicroBatcher`` that coalesces concurrent requests into shared batches.

``use_pallas`` keeps its name because ``TrainConfig`` and the CLI carry it;
here it selects the hand-written decode kernels: K1, or K2 with
``greedy_segment``, for greedy requests, and K3 for beam requests.

With a ``mesh`` of this process's devices (``parallel.mesh.make_mesh(
devices=[...])``) the Captioner serves data parallel: each device holds
its own copy of the params (with its kernels' weight layouts), and each
chunk is split into equal shards, one a device, decoded side by side, one
thread each, then put back in order. The shards' decode loops meet at
every batch-wide stop and freeze (``decoding.whole_batch``'s
``across``), so the captions are those of the whole chunk on one device.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import List, Optional, Sequence

import numpy as np
import torch

from recnet_tpu_torch.data import transforms
from recnet_tpu_torch import checkpoint as ckpt
from recnet_tpu_torch.decoding import (beam_decode, greedy_decode,
                                       greedy_decode_whole,
                                       greedy_decode_whole_segmented,
                                       kernels_supported, tokens_to_sentences,
                                       whole_batch)
from recnet_tpu_torch.models import decoder as dec_mod
from recnet_tpu_torch.parallel import mesh as mesh_lib
from recnet_tpu_torch.utils.profiling import span
from recnet_tpu_torch.weights import params_from_jax, torch_dtype


class _ShardJoin:
    """The batch-wide values of a chunk decoded in shards, one thread a
    shard: each shard's loop hands in its value, waits for the others and
    gets the reduction over all of them on its own device."""

    def __init__(self, n: int):
        self._barrier = threading.Barrier(n)
        self._parts: List[Optional[torch.Tensor]] = [None] * n

    def across(self, i: int):
        """The ``across`` of shard ``i`` (see ``decoding.whole_batch``)."""
        def join(x: torch.Tensor, op) -> torch.Tensor:
            self._parts[i] = x
            self._barrier.wait()
            out = op(torch.stack([p.to(x.device) for p in self._parts]),
                     dim=0)
            self._barrier.wait()      # every shard has read every value
            return out
        return join

    def abort(self) -> None:
        """Release the other shards of a failed one (they raise
        ``threading.BrokenBarrierError``)."""
        self._barrier.abort()


class Captioner:
    """Batched caption service over pre-extracted video features."""

    def __init__(self, tc, vocab, dec_params, *, dtype: str = "bfloat16",
                 batch_size: int = 1024, use_pallas: bool = False,
                 mesh=None, beam_length_margin: Optional[int] = None,
                 greedy_segment: Optional[int] = None, device="cuda"):
        """``dec_params``: the decoder params in the JAX layout (nested
        dict/list of arrays or tensors), cast to ``dtype`` on ``device``,
        or on each device of ``mesh`` (a 'data' mesh of local devices;
        ``batch_size`` must divide by its size).
        ``greedy_segment``: with ``use_pallas``, decode in K2 segments of
        this many steps and stop once every row has an <EOS>.
        ``beam_length_margin``: the approximate beam cutoff of
        ``decoding.beam_decode``'s ``length_cutoff_margin``; None runs the
        exact search."""
        self.mesh = mesh
        if mesh is None:
            self.devices = [torch.device(device)]
        else:
            if mesh.distributed or mesh.size("model") > 1:
                raise ValueError(
                    "a Captioner splits batches over a 'data' mesh of this "
                    f"process's devices (make_mesh(devices=...)); got {mesh}")
            if batch_size % mesh.size("data"):
                raise ValueError(
                    f"batch_size {batch_size} does not divide over the "
                    f"mesh's 'data' axis of size {mesh.size('data')}")
            self.devices = mesh.local_devices()
        for dev in self.devices:
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"device {str(dev)!r} requested but CUDA "
                                   "is not available")
        self.device = self.devices[0]
        self.tc = tc
        self.vocab = vocab
        self.dcfg = dec_mod.config_from_train(tc, vocab.n_vocabs)
        self.batch_size = batch_size
        self.use_pallas = bool(use_pallas)
        self.greedy_segment = greedy_segment
        self.beam_length_margin = beam_length_margin
        self._dtype = torch_dtype(dtype)
        decoders = {}                 # one copy of the params a device
        for dev in self.devices:
            if dev not in decoders:
                decoders[dev] = dec_mod.Decoder(self.dcfg, params_from_jax(
                    dec_params, dev, self._dtype))
        self.param_sets = [decoders[dev].params() for dev in self.devices]
        self.decoder = decoders[self.device]
        self.params = self.param_sets[0]

    @classmethod
    def from_checkpoint(cls, step_dir: str, **kw) -> "Captioner":
        tc, vocab = ckpt.load_config_and_vocab(step_dir)
        params = ckpt.load_decoder_params(step_dir, tc, vocab.n_vocabs)
        return cls(tc, vocab, params, **kw)

    def _decode(self, videos: torch.Tensor, beam_width: Optional[int],
                params=None, across=whole_batch) -> np.ndarray:
        """videos (B, L, F) on the params' device -> tokens (n_steps, B)."""
        params = params if params is not None else self.params
        max_len = self.tc.caption_max_len
        if beam_width:
            # only a margin stops early (and pays a host sync per step):
            # the all-<PAD> stop rarely fires
            res = beam_decode(
                params, self.dcfg, videos, beam_width, max_len,
                use_pallas_topk=(self.use_pallas
                                 and kernels_supported(self.dcfg,
                                                       "beam_topk")),
                length_cutoff_margin=self.beam_length_margin,
                across=across)
            with span("decode.to_host", waits=True):
                return res.tokens[:, : res.n_steps].T.cpu().numpy()
        if self.use_pallas and kernels_supported(self.dcfg, "greedy_whole"):
            if self.greedy_segment:
                # eos_stop: the sentences are exact and the all-<PAD> break
                # almost never fires on a trained model
                res = greedy_decode_whole_segmented(
                    params, self.dcfg, videos, max_len,
                    segment=self.greedy_segment, eos_stop=True,
                    across=across)
            else:
                res = greedy_decode_whole(params, self.dcfg, videos,
                                          max_len, across=across)
        else:
            res = greedy_decode(params, self.dcfg, videos, max_len,
                                early_exit=True, across=across)
        with span("decode.to_host", waits=True):
            return res.tokens[: res.n_steps].cpu().numpy()

    def _decode_chunk(self, chunk: np.ndarray,
                      beam_width: Optional[int]) -> np.ndarray:
        """A padded chunk (B, L, F) -> tokens (n_steps, B): on the one
        device, or split into equal shards decoded side by side on the
        mesh's devices (every shard issued before any waits for its
        results) and put back in order."""
        if self.mesh is None:
            videos = torch.from_numpy(chunk).to(self.device, self._dtype)
            return self._decode(videos, beam_width)
        slices = mesh_lib.batch_sharding(self.mesh).slices(len(chunk))
        join = _ShardJoin(len(slices))

        def shard(i: int) -> np.ndarray:
            try:
                videos = torch.from_numpy(chunk[slices[i]]).to(
                    self.devices[i], self._dtype)
                return self._decode(videos, beam_width, self.param_sets[i],
                                    join.across(i))
            except BaseException:
                join.abort()
                raise
        with ThreadPoolExecutor(len(slices)) as pool:
            parts = list(pool.map(shard, range(len(slices))))
        return np.concatenate(parts, axis=1)

    def validate_features(self, features: Sequence[np.ndarray]) -> None:
        """Raise ValueError unless every entry is a non-empty
        (frames, encoder_size) array."""
        want = self.dcfg.encoder_size
        for i, f in enumerate(features):
            f = np.asarray(f)
            if f.ndim != 2 or f.shape[0] == 0 or f.shape[1] != want:
                raise ValueError(f"features[{i}] has shape {f.shape}; "
                                 f"expected (frames, {want})")

    def prepare(self, features: Sequence[np.ndarray]) -> np.ndarray:
        """(frames, feat) arrays -> (n, encoder_output_len, feat) float32,
        sampled uniformly and zero-padded."""
        pipe = transforms.frame_pipeline("uniform",
                                         self.tc.encoder_output_len)
        return np.stack([pipe(np.asarray(f)) for f in features])

    def caption(self, features: Sequence[np.ndarray],
                beam_width: Optional[int] = None) -> List[str]:
        """features: list of (frames, feat) arrays. One caption each."""
        prepared = self.prepare(features)
        eos = self.vocab.word2idx["<EOS>"]
        out: List[str] = []
        for start in range(0, len(prepared), self.batch_size):
            chunk = prepared[start: start + self.batch_size]
            # pad to a power-of-two bucket by repeating the last row, so
            # the batch shapes the device sees stay few
            pad = self._bucket_size(len(chunk)) - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, chunk[-1:].repeat(pad, 0)])
            tokens = self._decode_chunk(chunk, beam_width)
            sents = tokens_to_sentences(tokens, self.vocab.idx2word, eos)
            out.extend(sents[: len(sents) - pad] if pad else sents)
        return out

    def _bucket_size(self, n: int) -> int:
        """Smallest power of two >= n (at least 8), capped at batch_size;
        on a mesh, rounded up to a multiple of its 'data' size, so that
        chunks split evenly (batch_size divides, so the cap holds)."""
        b = 8
        while b < n:
            b *= 2
        b = min(b, self.batch_size)
        if self.mesh is not None:
            d = self.mesh.size("data")
            b = min(-(-b // d) * d, self.batch_size)
        return b


class ServiceOverloaded(RuntimeError):
    """The MicroBatcher queue is full; the HTTP layer answers 503."""


class DeadlineExceeded(TimeoutError):
    """The request missed the MicroBatcher's deadline; HTTP 504."""


class MicroBatcher:
    """Coalesce concurrent caption requests into shared device batches.

    One dispatch thread drains a request queue: after ``flush_ms`` (which
    lets concurrent requests pile in), every queued request with the same
    decode key (greedy or a beam width) is concatenated, up to ``max_batch``
    videos, into one ``Captioner.caption`` call, and the results are split
    back per request. ``caption()`` blocks and is thread-safe.

    Overload is bounded: ``max_queue`` caps the requests waiting (a full
    queue raises ``ServiceOverloaded`` in the caller); ``deadline_s`` fails
    a request still queued past it with ``DeadlineExceeded`` before it
    reaches the device, and the waiting caller enforces it on its future
    too. ``close()`` stops intake, drains the queue and fails whatever a
    wedged device call leaves behind. Each expired request is counted once
    in ``n_expired``.
    """

    def __init__(self, captioner, flush_ms: float = 6.0,
                 max_batch: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 deadline_s: Optional[float] = None):
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None = unbounded)")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 (or None = no deadline)")
        self.captioner = captioner
        self.flush_s = max(0.0, flush_ms) / 1000.0
        self.max_batch = max_batch or captioner.batch_size
        self.max_queue = max_queue
        self.deadline_s = deadline_s
        self._cond = threading.Condition()
        self._queue: List = []    # [(key, features, future, deadline), ...]
        self._closed = False
        self.n_requests = 0
        self.n_dispatches = 0
        self.n_coalesced = 0            # dispatches that merged >1 request
        self.n_rejected = 0             # shed at enqueue (queue full)
        self.n_expired = 0              # deadline expiries, once each
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="recnet-microbatcher")
        self._thread.start()

    def caption(self, features: Sequence[np.ndarray],
                beam_width: Optional[int] = None) -> List[str]:
        """Captioner.caption, coalesced with concurrent callers. Raises
        ServiceOverloaded when the queue is full and DeadlineExceeded when
        deadline_s elapses first."""
        features = list(features)
        # a malformed request fails here, in its own thread, and never
        # poisons the coalesced batch it would have joined
        validate = getattr(self.captioner, "validate_features", None)
        if validate is not None:
            validate(features)
        deadline = (time.monotonic() + self.deadline_s
                    if self.deadline_s else None)
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if (self.max_queue is not None
                    and len(self._queue) >= self.max_queue):
                self.n_rejected += 1
                raise ServiceOverloaded(
                    f"request queue full ({self.max_queue} waiting); "
                    "retry with backoff")
            self._queue.append((beam_width, features, fut, deadline))
            self.n_requests += 1
            self._cond.notify()
        if deadline is None:
            return fut.result()
        # the dispatch thread fails QUEUED requests at their deadline; this
        # wait only covers a dispatched call that overruns it
        try:
            return fut.result(timeout=self.deadline_s + self.flush_s + 0.05)
        except FutureTimeout:
            # concurrent.futures.TimeoutError is the builtin TimeoutError,
            # so an exception stored on a done future lands here as well:
            # surface it as it is
            if fut.done():
                return fut.result()
            with self._cond:
                # take the request out of the queue if it is still there,
                # so the dispatch thread neither runs nor counts it again
                self._queue = [it for it in self._queue if it[2] is not fut]
                self.n_expired += 1
            raise DeadlineExceeded(
                f"request not completed within {self.deadline_s}s") from None

    def close(self, timeout: float = 10.0):
        """Stop intake, drain the queue, unblock anyone still waiting."""
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout=timeout)
        with self._cond:
            leftovers, self._queue = self._queue, []
        for _, _, fut, _ in leftovers:
            if not fut.done():
                fut.set_exception(
                    RuntimeError("MicroBatcher closed before dispatch"))

    def _expire_locked(self, now: float) -> None:
        """Drop queued requests past their deadline (caller holds _cond)."""
        live = []
        for item in self._queue:
            deadline = item[3]
            if deadline is not None and now >= deadline:
                self.n_expired += 1
                if not item[2].done():
                    item[2].set_exception(DeadlineExceeded(
                        f"queued past the {self.deadline_s}s deadline"))
            else:
                live.append(item)
        self._queue = live

    def _loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
            if self.flush_s:
                time.sleep(self.flush_s)    # let concurrent requests arrive
            with self._cond:
                self._expire_locked(time.monotonic())
                if not self._queue:
                    continue
                key = self._queue[0][0]
                group, keep, total = [], [], 0
                for item in self._queue:
                    k, feats, fut, _ = item
                    fits = total + len(feats) <= self.max_batch
                    # an oversized lone request still dispatches (caption()
                    # chunks it); everything else respects the cap
                    if k == key and (fits or not group):
                        group.append((feats, fut))
                        total += len(feats)
                    else:
                        keep.append(item)
                self._queue = keep
            feats_all = [f for feats, _ in group for f in feats]
            try:
                res = self.captioner.caption(feats_all, beam_width=key)
            except Exception as e:  # noqa: BLE001 — deliver to the waiters
                for _, fut in group:
                    if not fut.done():
                        fut.set_exception(e)
            else:
                i = 0
                for feats, fut in group:
                    if not fut.done():
                        fut.set_result(res[i:i + len(feats)])
                    i += len(feats)
            self.n_dispatches += 1
            if len(group) > 1:
                self.n_coalesced += 1
