"""Metric sinks: append-only JSONL and, when it imports, TensorBoard
(counterpart of ``vision_mtl_tpu/tracking/tb.py``).

Run dirs are ``{root}/{name}/version_{n}``. The metric names are the JAX
package's: ``step/{stage}/{k}``, ``epoch/{stage}/{k}``. Figures and
parameter histograms go to TensorBoard only, best-effort, as in JAX.

Under several ranks every rank resolves the same run dir: rank 0 claims it
and broadcasts it with the caller's tag and its construction ordinal, and
only rank 0 opens the sinks. The checkpoints go to the one dir as well.
"""

from __future__ import annotations

import json
import os
import typing as t

from vision_mtl_tpu_torch.parallel.multihost import Comm, current

_FAIL_SENTINEL = "__FAILED__"


def publish_logger_failure(reason: str, comm: t.Optional[Comm] = None) -> None:
    """Rank 0, about to fail before constructing its next
    :class:`MetricsLogger`: hand the ranks waiting in that logger's
    rendezvous the failure, so they raise at once instead of waiting for a
    run dir that never comes. A no-op in one process and on other ranks."""
    comm = comm if comm is not None else current()
    if comm is None or comm.world <= 1 or comm.rank != 0:
        return
    comm.broadcast_object((comm.next_call("logger"), _FAIL_SENTINEL, reason))


class MetricsLogger:
    def __init__(
        self,
        root_dir: str,
        name: str,
        rendezvous_tag: str = "main",
        comm: t.Optional[Comm] = None,
    ):
        comm = comm if comm is not None else current()
        rank, world = (comm.rank, comm.world) if comm is not None else (0, 1)
        self._writer = rank == 0
        if rank == 0:
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
        if world > 1:
            # every rank constructs its loggers in the same order: the
            # ordinal checks that the ranks agree on which logger a
            # broadcast run dir belongs to
            seq = comm.next_call("logger")
            payload = (seq, self.log_dir, rendezvous_tag) if rank == 0 else None
            remote_seq, log_dir, remote_tag = comm.broadcast_object(payload)
            if log_dir == _FAIL_SENTINEL:
                raise RuntimeError(
                    f"MetricsLogger rendezvous: rank 0 failed before constructing logger "
                    f"{seq}: {remote_tag}"
                )
            if (remote_seq, remote_tag) != (seq, rendezvous_tag):
                # the ranks constructed their loggers in different orders:
                # adopting the dir would cross-wire two runs' metrics and
                # checkpoints
                raise RuntimeError(
                    f"MetricsLogger rendezvous desync: rank 0 published logger {remote_seq} "
                    f"tagged {remote_tag!r}, this rank is constructing logger {seq} tagged "
                    f"{rendezvous_tag!r}. Loggers must be constructed in the same order on "
                    "every rank."
                )
            self.log_dir = log_dir
        self._jsonl = (
            open(os.path.join(self.log_dir, "metrics.jsonl"), "a") if self._writer else None
        )
        self._tb: t.Optional[t.Any] = None
        if self._writer:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard is optional
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(self.log_dir)

    def log_metrics(self, metrics: t.Mapping[str, float], step: int) -> None:
        if self._jsonl is not None:
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
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
