"""Metric sinks (``logger``), comet experiment tracking (``comet``) and
trained runs: the comet download and the local run registry
(``artifacts``)."""

from vision_mtl_tpu_torch.tracking.logger import MetricsLogger

__all__ = ["MetricsLogger"]
