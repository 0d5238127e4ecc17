"""Metric sinks of the port. Experiment tracking (comet) waits for a later
slice (ROADMAP.md A9)."""

from vision_mtl_tpu_torch.tracking.logger import MetricsLogger

__all__ = ["MetricsLogger"]
