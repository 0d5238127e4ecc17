"""Metric sinks: append-only JSONL and, when it imports, TensorBoard
(counterpart of ``vision_mtl_tpu/tracking/tb.py``, one process).

Run dirs are ``{root}/{name}/version_{n}``. The metric names are the JAX
package's: ``step/{stage}/{k}``, ``epoch/{stage}/{k}``. Figures and
parameter histograms go to TensorBoard only, best-effort, as in JAX.
"""

from __future__ import annotations

import json
import os
import typing as t


class MetricsLogger:
    def __init__(self, root_dir: str, name: str):
        base = os.path.join(root_dir, name)
        os.makedirs(base, exist_ok=True)
        # claim a version dir atomically (makedirs without exist_ok), so
        # two loggers started at once never share one
        version = 0
        while True:
            self.log_dir = os.path.join(base, f"version_{version}")
            try:
                os.makedirs(self.log_dir)
                break
            except FileExistsError:
                version += 1
        self._jsonl = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        self._tb: t.Optional[t.Any] = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is optional
            SummaryWriter = None
        if SummaryWriter is not None:
            self._tb = SummaryWriter(self.log_dir)

    def log_metrics(self, metrics: t.Mapping[str, float], step: int) -> None:
        record: t.Dict[str, float] = {"step": step}
        record.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def log_figure(self, tag: str, figure: t.Any, step: int = 0) -> None:
        if self._tb is not None:
            try:
                self._tb.add_figure(tag, figure, step)
            except Exception:
                pass

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
