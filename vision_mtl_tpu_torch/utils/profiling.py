"""Tracing and throughput (counterpart of
``vision_mtl_tpu/utils/profiling.py``): a ``torch.profiler`` trace around a
block of work, written as a Chrome trace; named regions in it; a step timer
for images per second."""

from __future__ import annotations

import contextlib
import itertools
import os
import time
import typing as t

import torch

_trace_ids = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str) -> t.Iterator[None]:
    """Profile the block with ``torch.profiler`` (host activity, and the
    card's when CUDA is available) and write its Chrome trace as
    ``{log_dir}/trace_{pid}_{n}.json`` (open it in Perfetto or
    ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{next(_trace_ids)}.json"))


class StepTimer:
    """Wall-clock throughput over a sliding window of steps.

    Call ``tick(n_images)`` once per step; ``images_per_sec`` reports the
    windowed rate. It does not synchronise the device itself: pair it with
    a read of a step's result where exact step boundaries matter.
    """

    def __init__(self, window: int = 50):
        self.window = window
        self._times: t.List[float] = []
        self._images: t.List[int] = []

    def tick(self, n_images: int) -> None:
        self._times.append(time.perf_counter())
        self._images.append(n_images)
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._images.pop(0)

    @property
    def images_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return sum(self._images[1:]) / max(dt, 1e-9)


@contextlib.contextmanager
def annotate(name: str) -> t.Iterator[None]:
    """Named region in the profiler timeline."""
    with torch.profiler.record_function(name):
        yield
