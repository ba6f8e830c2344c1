"""Metric logging: JSONL always, TensorBoard where it imports.

A copy of ``recnet_tpu.utils.logging``. It keeps the reference's tag schema
(config.py:136-157, written via tensorboardX at train.py:288-306,365-372,
392-394), so existing dashboards read the runs unchanged. The JSONL stream
is the primary artifact.
"""

from __future__ import annotations

import json
import os
import threading
import time


class MetricWriter:
    """JSONL metric stream and an optional TensorBoard mirror.

    The TensorBoard ``SummaryWriter`` import is slow, so it is constructed
    in a background thread; the first scalar/text/close call joins it.
    Where it does not import, only the JSONL stream is written.
    """

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        self._tb_thread = None
        if use_tensorboard:
            self._tb_thread = threading.Thread(
                target=self._construct_tb, daemon=True,
                name="metricwriter-tb-init")
            self._tb_thread.start()

    def _construct_tb(self) -> None:
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(self.log_dir)
        except Exception:  # noqa: BLE001 -- no TensorBoard: JSONL only
            self._tb = None

    def _tb_ready(self):
        """Join the background construction (idempotent); the
        SummaryWriter or None."""
        if self._tb_thread is not None:
            self._tb_thread.join()
            self._tb_thread = None
        return self._tb

    def scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"t": time.time(), "step": int(step), "tag": tag,
               "value": float(value)}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        tb = self._tb_ready()
        if tb is not None:
            tb.add_scalar(tag, value, step)

    def text(self, tag: str, text: str, step: int) -> None:
        rec = {"t": time.time(), "step": int(step), "tag": tag, "text": text}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        tb = self._tb_ready()
        if tb is not None:
            tb.add_text(tag, text, step)

    def close(self) -> None:
        self._jsonl.close()
        tb = self._tb_ready()
        if tb is not None:
            tb.close()
