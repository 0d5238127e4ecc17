"""Cells at a size a CPU test can hold: the cell's configuration and mix
with small images, batches and pools, run on the CPU with the program's
plain kernels. The harness's look for a card is skipped; everything else
of a run is driven as on the card."""

from __future__ import annotations

import time
import typing as t
from pathlib import Path

import torch

from portbench import harness
from portbench.kinds import serve

ROOT = Path(__file__).resolve().parents[2]
#: a seed past 32 signed bits, as the benchmark's runs may be given
SEED = 2**31 + 7
TRAIN = {"batch": 2, "trace_steps": 1}
SERVE = {"rate": 20.0, "buckets": [1, 2, 4]}
# a served run's seconds of load in set-up and in its traced sub-window,
# cut for the CPU
serve.WARM_SECONDS, serve.TRACE_SECONDS = 0.2, 0.5


def config(name: str, height: int = 32) -> t.Dict[str, t.Any]:
    """The configuration ``name`` with small images."""
    return dict(harness.load_json("configs", name), height=height, width=2 * height)


def run(cell: str, seed: int = SEED, seconds: float = 0.5, trace: bool = False,
        height: int = 32, **config: t.Any) -> harness.Run:
    bench = harness.load_benchmark(ROOT)
    r = harness.make_run(bench, cell, seed, seconds, trace, torch.device("cpu"),
                         time.perf_counter())
    r.config = dict(r.config, height=height, width=2 * height, **config)
    r.traffic = dict(r.traffic, **(TRAIN if r.traffic["kind"] == "train" else SERVE))
    return r


def result(r: harness.Run, outcome: harness.Outcome) -> t.Dict[str, t.Any]:
    bench = harness.load_benchmark(ROOT)
    info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return harness.result(bench, r, outcome, info)
