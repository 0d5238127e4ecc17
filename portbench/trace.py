"""The traced sub-window: one short ``torch.profiler`` session over a few
steps or batches, read back from its Chrome trace.

A run with ``--trace 1`` measures its window as an untraced run does and
then opens one sub-window under the profiler. It traces the device's
operations and the host's CUDA runtime calls, not the host's PyTorch
operators: recording every operator slowed MTAN's train step by a third
on the host (H100, 221 against 163 ms a step), so the card idled in the
trace where it did not in the window. From the trace come the device's
busy time (the union of every device operation's interval, so that
operations that overlap on several streams count once), the idle gaps
between those intervals with the runtime call the host was in at each,
the device time by category of kernel, and the device operations the
per-layer metrics read. The sub-window runs from the host's first runtime
call in it to the end of its last (a device sync).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import typing as t

#: device kernels by name, first match wins (the port's own profiling
#: categories, with copies and collectives apart)
CATEGORIES = (
    ("gate kernels (eval and train)", ("gate_kernel<", "gate_train_kernel<", "fold_kernel(")),
    ("confusion matrix", ("confmat_kernel",)),
    ("small conv (B3)", ("conv3x3_small_kernel", "conv3x3_small_tc_kernel")),
    ("collectives (NCCL)", ("nccl",)),
    ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "cudnn")),
    ("matrix products (cuBLAS)", ("gemm", "gemv")),
    ("batch norm", ("batch_norm",)),
    ("optimizer (foreach)", ("multi_tensor_apply", "foreach")),
    ("reductions", ("reduce_kernel",)),
    ("memcpy and memset", ("Memcpy", "Memset")),
    ("elementwise and copies", ("elementwise", "copy", "Functor", "fill")),
)
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cuda_runtime", "cuda_driver", "cpu_op"}
WINDOW = "portbench.window"


@dataclasses.dataclass
class Trace:
    """The sub-window's device operations, ``(name, start us, duration
    us)`` clipped to the window, and the host's operations ``(name, start,
    duration)``."""

    device: t.List[t.Tuple[str, float, float]]
    host: t.List[t.Tuple[str, float, float]]
    start_us: float
    end_us: float

    @property
    def window_us(self) -> float:
        return self.end_us - self.start_us

    def busy_intervals(self) -> t.List[t.Tuple[float, float]]:
        spans = sorted((s, s + d) for _, s, d in self.device)
        merged: t.List[t.Tuple[float, float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def time_us(self, patterns: t.Sequence[str]) -> t.Tuple[float, int]:
        """Device time and count of the operations whose name holds any of
        ``patterns``."""
        hits = [d for name, _, d in self.device if any(p in name for p in patterns)]
        return sum(hits), len(hits)

    def categories(self) -> t.List[t.List[t.Any]]:
        by: t.Dict[str, float] = {}
        for name, _, d in self.device:
            cat = next((c for c, keys in CATEGORIES if any(k in name for k in keys)), "other")
            by[cat] = by.get(cat, 0.0) + d
        return [[c, us / 1e6] for c, us in sorted(by.items(), key=lambda kv: -kv[1])][:10]

    def idle_gaps(self, top: int = 10) -> t.List[t.List[t.Any]]:
        """The longest gaps in which no device operation ran, each named by
        the innermost host call running at its start ("no host operation":
        the host was in Python, between runtime calls)."""
        edges = [self.start_us] + [x for iv in self.busy_intervals() for x in iv] + [self.end_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            inside = [(d, name) for name, hs, d in self.host if hs <= s < hs + d]
            out.append([min(inside)[1] if inside else "no host operation", (e - s) / 1e6])
        return out


@contextlib.contextmanager
def sub_window() -> t.Iterator[t.Dict[str, Trace]]:
    """Profiles the body; afterwards ``box["trace"]`` holds its
    :class:`Trace`. The body ends in a device sync."""
    box: t.Dict[str, Trace] = {}
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield box
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            box["trace"] = parse(json.load(f))
    finally:
        os.remove(path)


def parse(chrome: t.Mapping[str, t.Any]) -> Trace:
    """A :class:`Trace` from a Chrome trace: the sub-window is the host's
    ``portbench.window`` annotation where the trace holds one, else the
    span of its CUDA runtime calls, else of its device operations."""
    events = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
    marks = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    runtime = [e for e in events if e.get("cat") in HOST_CATS]
    if marks:
        start = float(marks[0]["ts"])
        end = start + float(marks[0]["dur"])
    elif runtime or any(e.get("cat") in DEVICE_CATS for e in events):
        spans = runtime or [e for e in events if e.get("cat") in DEVICE_CATS]
        start = min(float(e["ts"]) for e in spans)
        end = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in spans)
    else:
        raise RuntimeError("the trace holds no annotation, runtime call or device operation")
    device, host = [], []
    for e in events:
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_CATS:
            lo, hi = max(s, start), min(s + d, end)
            if hi > lo:
                device.append((e["name"], lo, hi - lo))
        elif e.get("cat") in HOST_CATS:
            host.append((e["name"], s, d))
    return Trace(device=device, host=host, start_us=start, end_us=end)
