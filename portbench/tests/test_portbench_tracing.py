"""The readers of the program's spans and serving counters
(``portbench/spans.py`` and its nine metrics) on a made trace, made spans
and made counters: each reads its hand-computed value in its cells, and
nothing outside them, on a wrong count of spans, or on spans that miss the
sub-window."""

from __future__ import annotations

import pytest
import torch

from portbench import harness, spans
from portbench.readings import Readings
from portbench.tests import tiny
from portbench.trace import Trace
from vision_mtl_tpu_torch.utils.profiling import Span

BENCH = harness.load_benchmark(tiny.ROOT)
MTAN, BASIC = "mtan-cityscapes.train-b32", "basic-cityscapes.train-b256"
SERVE = "mtan-cityscapes.serve-over"
TRAIN_METRICS = ("host_ms.train", "forward_ms.train", "backward_ms.train",
                 "optimizer_ms.train", "paced_idle.train", "gate_backward_ms.train")
SERVE_METRICS = ("dispatch_ms.serve", "inflight_wait.serve", "paced_idle.serve")
GATES = 16  # MTAN's 8 gate shapes x 2 tasks


def read(name, r):
    return harness.metric_module(name).read(r)


def trace(busy):
    """A 1,000 us sub-window."""
    return Trace(device=[("k", s, e - s) for s, e in busy], host=[], start_us=0.0,
                 end_us=1000.0)


def readings(cell, busy, steps=2, **extra):
    r = harness.make_run(BENCH, cell, 1, 1.0, True, None, 0.0)
    kind = r.traffic["kind"]
    return Readings(kind=kind, config=r.config, traffic=r.traffic, chips=1, rate=100.0,
                    trace=trace(busy), launches={}, steps=steps if kind == "train" else 0,
                    **extra)


def span(name, start_us, end_us, thread, ids, device_ms):
    """A recorded span whose interval on the trace's clock is [start_us,
    end_us]."""
    return Span(name, 0, int(start_us * 1e3), thread, None, ids, int(end_us * 1e3), device_ms)


def train_spans(gates=GATES):
    """Two steps, [10, 400] and [410, 900] us on the host: forward 0.1 ms,
    backward 0.3 ms (its gates 0.01 ms each) and optimizer 0.02 ms of device
    time each."""
    out = []
    for lo, hi in ((10.0, 400.0), (410.0, 900.0)):
        out.append(span("train.step", lo, hi, 1, {}, 0.5))
        out.append(span("train.forward", lo + 5, lo + 100, 1, {}, 0.1))
        out.append(span("train.backward", lo + 100, lo + 300, 1, {}, 0.3))
        out += [span("gate.backward", lo + 110 + 10 * i, lo + 115 + 10 * i, 2, {}, 0.01)
                for i in range(gates)]
        out.append(span("train.optimizer", lo + 310, lo + 380, 1, {}, 0.02))
    return out


def shifted(found, by_us):
    return [span(s.name, s.start_ns / 1e3 + by_us, s.end_ns / 1e3 + by_us, s.thread, s.ids,
                 s.device_ms) for s in found]


@pytest.fixture
def program(monkeypatch):
    """Sets the spans the program recorded."""
    box = {"spans": []}
    monkeypatch.setattr(spans, "recorded", lambda: box["spans"])
    return box


# the card idle over [300, 350] and [950, 1000]: 50 us of it inside a step
BUSY = [(0.0, 300.0), (350.0, 950.0)]
WANT_TRAIN = {"host_ms.train": (390.0 + 490.0) / 2 / 1e3, "forward_ms.train": 0.1,
              "backward_ms.train": 0.3, "optimizer_ms.train": 0.02,
              "paced_idle.train": 5.0, "gate_backward_ms.train": 0.16}


@pytest.mark.parametrize("name", TRAIN_METRICS)
def test_train_readers(program, name):
    program["spans"] = train_spans()
    mtan = readings(MTAN, BUSY)
    assert read(name, mtan) == pytest.approx(WANT_TRAIN[name])
    basic = readings(BASIC, BUSY)
    if name == "gate_backward_ms.train":  # basic has no gate
        assert read(name, basic) is None
    else:
        assert read(name, basic) == pytest.approx(WANT_TRAIN[name])
    serve = readings(SERVE, BUSY, serve_window={"batches": 1})
    assert read(name, serve) is None
    program["spans"] = train_spans()[:-1]  # a step's optimizer span missing
    if name == "optimizer_ms.train":
        assert read(name, mtan) is None
    else:
        assert read(name, mtan) == pytest.approx(WANT_TRAIN[name])
    program["spans"] = train_spans(gates=GATES - 1)
    if name == "gate_backward_ms.train":
        assert read(name, mtan) is None
    mtan.steps = 3  # a step without its spans
    assert read(name, mtan) is None
    mtan.steps = 2
    program["spans"] = shifted(train_spans(), 5e6)  # the clocks mapped wrong
    assert read(name, mtan) is None
    # a third step's spans outside: two in three fall inside
    program["spans"] = train_spans() + shifted(train_spans()[:4 + GATES], 5e6)
    assert read(name, mtan) is None
    program["spans"] = None  # a program that records no spans
    assert read(name, mtan) is None


def dispatches(first=7, n=9):
    """``n`` served batches from ``first``, each dispatched over 50 us, one
    every 100 us from [100, 150] on."""
    return [span("serve.dispatch", 100.0 + 100 * i, 150.0 + 100 * i, 9, {"batch": first + i},
                 None) for i in range(n)]


STATS = {"requests": 400, "batches": 4, "batched_images": 400, "padded_slots": 112,
         "dispatch_s": 0.2, "inflight_wait_s": 5.0, "seconds": 20.0}
WANT_SERVE = {"dispatch_ms.serve": 50.0, "inflight_wait.serve": 25.0,
              # idle [125, 175] and [525, 575]: 25 us of each inside [100, 150]
              # and [500, 550]
              "paced_idle.serve": 5.0}


@pytest.mark.parametrize("name", SERVE_METRICS)
def test_serve_readers(program, name):
    program["spans"] = dispatches()
    busy = [(0.0, 125.0), (175.0, 525.0), (575.0, 1000.0)]
    r = readings(SERVE, busy, serve_window=dict(STATS), serve_traced={})
    assert read(name, r) == pytest.approx(WANT_SERVE[name])
    assert read(name, readings(MTAN, busy)) is None
    if name == "paced_idle.serve":
        program["spans"] = [s for s in dispatches() if s.ids["batch"] != 8]  # one missing
        assert read(name, r) is None
        program["spans"] = shifted(dispatches(), -5e6)
        assert read(name, r) is None
        # a tenth batch dispatched from the sub-window's end on is not the
        # sub-window's; with an eleventh, under 90% fall inside
        program["spans"] = dispatches(n=10)
        assert read(name, r) == pytest.approx(WANT_SERVE[name])
        program["spans"] = dispatches(n=11)
        assert read(name, r) is None
    else:  # a server without the counter (before it was added)
        key = {"dispatch_ms.serve": "dispatch_s", "inflight_wait.serve": "inflight_wait_s"}
        r.serve_window = {k: v for k, v in STATS.items() if k != key[name]}
        assert read(name, r) is None
        r.serve_window = dict(STATS, batches=0, seconds=0.0)
        assert read(name, r) is None


def test_idle_by_innermost_span(program):
    """Each idle instant goes to the latest started span running then, on
    any thread: idle [300, 350] lies in the first step's backward to 310,
    then in the step alone to 320, then in its optimizer; idle [950, 1000]
    in no span."""
    program["spans"] = train_spans()
    got = spans.idle_by_span(readings(MTAN, BUSY))
    assert got == pytest.approx({"train.backward": 10e-6, "train.step": 10e-6,
                                 "train.optimizer": 30e-6, spans.NO_SPAN: 50e-6})


def test_recorded_reads_the_program_s_buffer():
    """After a profiler session the program's spans come back on the trace's
    clock, and a span of the program before it was recorded is not."""
    from vision_mtl_tpu_torch.utils import profiling

    profiling.clear_spans()
    with profiling.span("outside"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("inside", batch=3):
            torch.ones(4).sum()
    got = spans.recorded()
    profiling.clear_spans()
    assert [(s.name, s.ids, s.device_ms) for s in got] == [("inside", {"batch": 3}, None)]
    assert 0.0 < spans.host_us(got[0]) < 1e6
