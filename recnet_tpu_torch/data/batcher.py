"""Fixed-shape batching and host-to-device prefetch.

A copy of ``recnet_tpu.data.batcher``'s ``Batcher`` and ``cycle``, with
the same numpy shuffle stream, so both packages see the same batches:
videos (B, frames, feat) batch-first and captions time-major (T, B) (the
reference transposes at dataset/MSVD.py:72); a short last batch repeats its
last example under the vid "PAD" (dataset/MSVD.py:57-61,80-84).
``index_mode`` yields each video's row in the device feature cache instead
of its features.

``prefetch_to_device`` is a thread that turns each batch's arrays into
tensors in pinned host memory and copies them to the device with
``non_blocking=True``, so the host assembles batch N+1 while the card runs
batch N. On a mesh (``sharding``) each rank copies only its slice of the
global batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from recnet_tpu_torch.parallel.distributed import to_device


class Batcher:
    """Iterates a CaptionDataset/ScoreDataset in fixed-size batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, has_captions: bool = True,
                 index_mode: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.has_captions = has_captions
        # index_mode: yield (vids, video_row_idx (B,) int32, captions), the
        # same shuffle stream as the materialising mode
        self.index_mode = index_mode
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1
        for start in range(0, n, self.batch_size):
            yield self._collate(order[start:start + self.batch_size])

    def _collate(self, idxs: Sequence[int]):
        get = (self.dataset.get_indexed if self.index_mode
               else self.dataset.get)
        items = [get(int(i)) for i in idxs]
        pad_len = self.batch_size - len(items)
        vids = [it[0] for it in items] + ["PAD"] * pad_len
        items += [items[-1]] * pad_len
        if self.index_mode:
            rows = np.asarray([it[1] for it in items], np.int32)
            videos = rows
        else:
            videos = np.stack([np.asarray(it[1], np.float32) for it in items])
            if not self.has_captions:
                return vids, videos
        captions = np.stack([np.asarray(it[2], np.int32) for it in items])
        return vids, videos, captions.T   # captions (T, B), time-major


def cycle(iterable: Iterable) -> Iterator:
    """Infinite epoch loop (reference: utils.py:5-8)."""
    while True:
        for x in iterable:
            yield x


class Prefetcher:
    """Iterator over ``iterator``'s batches with their numpy arrays on
    ``device``; other leaves (vid lists) pass through. ``sharding``, one
    ``parallel.mesh`` sharding per leaf, cuts each array to this rank's
    part first. A worker thread keeps up to ``size`` batches ready. An
    error in the producer is raised in the consumer; ``close()`` stops the
    thread."""

    _DONE = object()

    def __init__(self, iterator: Iterator, size: int = 2, device="cuda",
                 sharding: Optional[Sequence] = None):
        self.device = torch.device(device)
        self.sharding = sharding
        self._q: queue.Queue = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._ended = False
        self.thread = threading.Thread(target=self._work, args=(iterator,),
                                       daemon=True, name="prefetch_to_device")
        self.thread.start()

    def _work(self, iterator: Iterator) -> None:
        try:
            for batch in iterator:
                if self.sharding is not None:
                    batch = [s.part(x) if isinstance(x, np.ndarray) else x
                             for x, s in zip(batch, self.sharding)]
                item = tuple(to_device(x, self.device)
                             if isinstance(x, np.ndarray) else x
                             for x in batch)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            item = self._DONE
        except BaseException as e:  # noqa: BLE001 -- raised in the consumer
            item = e
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        if self._ended:
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._ended = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._ended = True
            raise RuntimeError("prefetch worker failed") from item
        return item

    def close(self) -> None:
        """Stop the worker and wait for it (5 s at most)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self.thread.join(timeout=5)


def prefetch_to_device(iterator: Iterator, size: int = 2, device="cuda",
                       sharding: Optional[Sequence] = None) -> Prefetcher:
    """Overlap host batch assembly and the host-to-device copy with the
    device's compute (replaces DataLoader(num_workers=4),
    reference: config.py:53). ``sharding``: per leaf, the
    ``parallel.mesh.batch_sharding`` (or ``replicated``) whose part of the
    global batch this rank keeps; a batch that does not divide over 'data'
    raises ValueError naming both sizes."""
    return Prefetcher(iterator, size, device, sharding)
