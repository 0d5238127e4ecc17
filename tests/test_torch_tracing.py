"""The port's spans (``utils/profiling.span``) and the batcher's time
counters, on the CPU: a span records nothing without a profiler session and
everything with one, nested by thread, on the clock of the session's Chrome
trace, in a buffer that keeps the newest; only a span asked for its device
time makes CUDA events; a train step records its four spans and B4's
backward one a gate; ``BatchingServer.stats()`` times its dispatches, their
CPU time and its waits."""

import concurrent.futures
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vision_mtl_tpu_torch.metrics import init_metrics
from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
from vision_mtl_tpu_torch.serving import BatchingServer
from vision_mtl_tpu_torch.train.state import create_train_state
from vision_mtl_tpu_torch.train.step import make_train_step
from vision_mtl_tpu_torch.utils import profiling

H = W = 16
CLASSES = 5


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _model() -> MTANMiniUnet:
    """A small MTAN: 2 levels, so 4 gates a task, 8 a forward."""
    return MTANMiniUnet({"depth": 1, "segm": CLASSES}, task_subnets_hidden_channels=8,
                        encoder_first_channel=8, encoder_num_channels=2,
                        dtype=torch.float32, seed=0)


def test_span_without_a_session_does_nothing(monkeypatch):
    """No record_function entered, no CUDA event made, nothing kept."""

    def refuse(*a, **k):
        raise AssertionError("touched while no session is on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with profiling.span("a", batch=1):
        with profiling.span("b"):
            pass
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_span_records_name_thread_parent_and_ids():
    def worker():
        with profiling.span("other.thread", batch=7):
            pass

    with _session():
        with profiling.span("outer"):
            with profiling.span("inner", batch=3):
                torch.ones(8).sum()
            with profiling.span("second"):
                pass
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(timeout=30)
    assert not thread.is_alive()
    got = profiling.spans()
    assert [(s.name, s.number, s.parent, s.ids) for s in got] == [
        ("outer", 0, None, {}), ("inner", 1, 0, {"batch": 3}), ("second", 2, 0, {}),
        ("other.thread", 3, None, {"batch": 7})]
    main = threading.get_ident()
    assert [s.thread == main for s in got] == [True, True, True, False]
    outer, inner, second, _ = got
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= second.start_ns
    assert second.end_ns <= outer.end_ns
    assert all(s.device_ms is None for s in got)  # no CUDA here
    with profiling.span("after"):  # the session has ended
        pass
    assert len(profiling.spans()) == 4


def test_span_buffer_is_bounded(monkeypatch):
    """Past ``CAPACITY`` the oldest spans go and are counted, so a later
    session is still recorded."""
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    with _session():
        for i in range(5):
            with profiling.span("s", i=i):
                with profiling.span("child"):
                    pass
    got = profiling.spans()
    assert [(s.name, s.number, s.parent, s.ids) for s in got] == [
        ("child", 7, 6, {}), ("s", 8, None, {"i": 4}), ("child", 9, 8, {})]
    assert profiling.dropped() == 7
    with _session():
        with profiling.span("later"):
            pass
    assert [s.name for s in profiling.spans()] == ["s", "child", "later"]
    assert profiling.dropped() == 8


def test_span_makes_cuda_events_only_for_device_time(monkeypatch):
    """Only a span asked for its ``device_time`` records the two events, at
    its start and its end, and reads their elapsed time."""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.recorded = 0
            made.append(self)

        def record(self):
            self.recorded += 1

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 2.5

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    with _session():
        with profiling.span("host.only", batch=1):
            with profiling.span("timed", device_time=True):
                assert len(made) == 2 and [e.recorded for e in made] == [1, 0]
    assert [e.recorded for e in made] == [1, 1]
    host_only, timed = profiling.spans()
    assert (host_only.device_ms, host_only.ids, timed.device_ms) == (None, {"batch": 1}, 2.5)


def test_span_lies_on_the_chrome_trace_s_clock(tmp_path):
    """``trace_us`` of a span's start is within 100 us of the ``ts`` of its
    ``record_function`` twin in the Chrome trace ``profiling.trace`` wrote
    (the second session: a process's first ``record_function`` pays a
    one-time set-up)."""
    for attempt in range(2):
        profiling.clear_spans()
        with profiling.trace(str(tmp_path / str(attempt))):
            with profiling.span("vmtl.outer"):
                with profiling.span("vmtl.inner"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "1").glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    ts = {e["name"]: float(e["ts"]) for e in events if e.get("cat") == "user_annotation"}
    got = profiling.spans()
    assert [s.name for s in got] == ["vmtl.outer", "vmtl.inner"]
    for s in got:
        assert abs(profiling.trace_us(s.start_ns) - ts[s.name]) < 100.0


def test_train_step_records_its_spans():
    """One train step: one each of ``train.step``, ``train.forward``,
    ``train.backward`` and ``train.optimizer``, the last three inside the
    first; B4's backward once a gate and task, inside the backward (on the
    CPU autograd runs on the caller's thread)."""
    state = create_train_state(_model(), 1e-3, device="cpu")
    step = make_train_step(device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"img": torch.rand(2, H, W, 3, generator=g),
             "mask": torch.randint(0, CLASSES, (2, H, W), generator=g),
             "depth": torch.rand(2, H, W, 1, generator=g)}
    mstate = init_metrics(CLASSES, "cpu")
    state, mstate, _ = step(state, batch, mstate)  # outside a session: nothing
    assert profiling.spans() == []
    with _session():
        step(state, batch, mstate)
    got = profiling.spans()
    names = [s.name for s in got]
    for name in ("train.step", "train.forward", "train.backward", "train.optimizer"):
        assert names.count(name) == 1
    root = names.index("train.step")
    assert root == 0 and got[root].parent is None
    backward = names.index("train.backward")
    for s in got[1:]:
        assert s.parent == (backward if s.name == "gate.backward" else root)
    assert names.count("gate.backward") == 8
    assert names == ["train.step", "train.forward", "train.backward"] + [
        "gate.backward"] * 8 + ["train.optimizer"]


def test_batching_server_times_dispatch_and_waits():
    """``dispatch_s``, ``dispatch_cpu_s``, ``inflight_wait_s`` and
    ``seconds`` rise while it serves and start again at ``reset_stats``;
    under a session each batch dispatched records one ``serve.dispatch``
    span with its number."""
    model = _model().eval()
    imgs = np.random.default_rng(0).integers(0, 256, (12, H, W, 3), dtype=np.uint8)
    with BatchingServer(model, H, W, buckets=(1, 4), max_wait_ms=5.0, dtype=np.uint8,
                        max_in_flight=1, device="cpu") as server:
        server.warmup()
        server.reset_stats()
        zero = server.stats()
        with _session():
            with concurrent.futures.ThreadPoolExecutor(12) as pool:
                list(pool.map(server.predict, imgs))
        served = server.stats()
        server.reset_stats()
        again = server.stats()
    assert zero["dispatch_s"] == zero["dispatch_cpu_s"] == zero["inflight_wait_s"] == 0.0
    assert served["batches"] >= 3 and served["dispatch_s"] > 0.0
    # the worker's CPU time lies within its wall time (the two clocks are
    # read a few calls apart)
    assert 0.0 < served["dispatch_cpu_s"] <= served["dispatch_s"] + 1e-3
    assert served["inflight_wait_s"] >= 0.0
    assert served["seconds"] > zero["seconds"] >= 0.0
    assert served["dispatch_s"] + served["inflight_wait_s"] <= served["seconds"]
    assert again["batches"] == again["dispatch_s"] == again["dispatch_cpu_s"] == 0
    assert again["inflight_wait_s"] == 0
    assert again["seconds"] < served["seconds"]
    got = [s for s in profiling.spans() if s.name == "serve.dispatch"]
    assert len(got) == served["batches"]
    first = got[0].ids["batch"]
    assert [s.ids["batch"] for s in got] == list(range(first, first + len(got)))
    assert len({s.thread for s in got}) == 1 and got[0].thread != threading.get_ident()


def test_trace_writes_its_file_per_session(tmp_path):
    """``profiling.trace`` writes one Chrome trace a session, named by the
    process and a counter."""
    for _ in range(2):
        with profiling.trace(str(tmp_path)):
            torch.ones(4).sum()
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 2 and all(n.startswith(f"trace_{os.getpid()}_") for n in names)
