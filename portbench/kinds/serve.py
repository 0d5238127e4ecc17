"""Serving traffic: the program's ``BatchingServer`` under an open loop of
single-frame requests at a rate fixed in the mix, on one card.

``serve_img_per_s`` counts the requests answered by the window's close,
over the window: at a rate above what the server sustains (the knee that
``portbench/sweep.py`` finds) it is the served path's capacity, and the
backlog grows all through the window.

Requests arrive as independent users send them: at ``rate`` a second on
average, the gaps between arrivals exponential. Every seed gets the same
set of gaps (drawn once from a fixed generator and scaled to fill the
window exactly) in another order, and its own frames. One sender thread
submits each request when it is due, or at once when it is late. Set-up
builds the server on the seeded weights (their BatchNorm statistics set
by the reference, ``served_weights``), runs each bucket once
(``BatchingServer.warmup``), the first work after the model is placed,
then sends ``WARM_SECONDS`` of the same load.

Each request is timed from when it was due to its answer on the host, so a
stall counts against every request that waited behind it; one that fails,
or does not come within a minute of the window's close, counts as
infinitely late. The median and 95th percentile (nearest rank) of every
request due in the window go to the run's notes: below the knee they are
what a user feels, above it they grow with the backlog and swing with the
smallest change. So do the seconds the interpreter spent collecting
garbage in the window, which every thread waits for. A seeded sample of the window's answers is held against
the reference once the window has closed.

Mix keys: ``rate`` (requests a second), ``buckets``, ``max_wait_ms``,
``max_in_flight``, ``compact_out``.
"""

from __future__ import annotations

import gc
import math
import random
import threading
import time
import typing as t

import numpy as np
import torch

from portbench import compare, reference, seeded
from portbench.harness import Outcome, Run, program_model
from portbench.readings import Readings
from portbench.reference.common import F32, calibrate_
from portbench.reference.steps import decode, full_f32, serve_outputs
from portbench.trace import sub_window
from vision_mtl_tpu_torch import kernels
from vision_mtl_tpu_torch.serving import BatchingServer

#: how long past the close a request may still come
GRACE_S = 60.0
#: the fixed generator of the arrival gaps every seed shares
GAPS_SEED = 20240601
#: how long a traced run's schedule runs on past the window's close
TRACE_TAIL_S = 60.0
#: distinct seeded frames the requests carry
FRAMES = 256
#: the window's answers held against the reference: every limit in
#: ``workloads/*.json`` and every reading of ``control.py`` was taken on
#: this many
SAMPLE = 64
#: frames that set the served weights' BatchNorm statistics
CALIBRATION_FRAMES = 16
#: seconds of load at the cell's rate in set-up
WARM_SECONDS = 1.0
#: seconds of the traced sub-window
TRACE_SECONDS = 1.5


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's open) of ``round(rate * seconds)``
    requests: exponential gaps from a fixed generator, scaled to end at
    ``seconds``, in the order ``seed`` draws."""
    n = max(1, round(rate * seconds))
    gaps = np.random.default_rng(GAPS_SEED).exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    gaps = np.random.default_rng(seed).permutation(gaps)
    return np.cumsum(gaps) - gaps[0]


class OpenLoop:
    """Sends ``frames[order[i]]`` at ``open + due[i]``; requests due before
    ``close`` are the window's."""

    def __init__(self, server: BatchingServer, frames: np.ndarray, due: np.ndarray,
                 close_s: float, seed: int, sample: int):
        self.server, self.frames, self.due, self.close_s = server, frames, due, close_s
        #: no request is sent at or after this time (perf_counter); a traced
        #: run moves it to the end of its sub-window
        self.stop = math.inf
        self.order = np.random.default_rng(seed).integers(0, len(frames), len(due))
        self.rng = random.Random(seed)
        self.sample, self.kept = sample, []  # (frame index, answer)
        self.lock = threading.Lock()
        self.idle = threading.Condition(self.lock)
        self.in_flight = 0
        self.latencies: t.List[float] = []  # ms, of the window's requests
        self.late: t.List[float] = []  # s the sender ran behind, window's requests
        self.failed = 0
        self.answered_by_close = 0
        self.seen = 0  # window answers offered to the sample
        self.open = math.inf
        self.thread = threading.Thread(target=self._send_all, name="portbench-sender",
                                       daemon=True)

    @property
    def close(self) -> float:
        return self.open + self.close_s

    def start(self, stop_s: float = math.inf) -> None:
        self.open = time.perf_counter()
        self.stop = self.open + stop_s
        self.thread.start()

    def _send_all(self) -> None:
        for i, at in enumerate(self.due):
            due = self.open + float(at)
            if due >= self.stop:
                return
            now = time.perf_counter()
            if now < due:
                time.sleep(due - now)
                now = time.perf_counter()
            in_window = at < self.close_s
            if in_window:
                self.late.append(max(0.0, now - due))
            idx = int(self.order[i])
            with self.lock:
                self.in_flight += 1
            try:
                fut = self.server.submit(self.frames[idx])
            except RuntimeError as e:  # the server refused: a failed request
                self._finish(idx, due, in_window, None, e)
                continue
            fut.add_done_callback(
                lambda f, idx=idx, due=due, w=in_window: self._finish(idx, due, w, f, None))

    def _finish(self, idx, due, in_window, fut, exc) -> None:
        done = time.perf_counter()
        if fut is not None:
            exc = fut.exception()
        with self.lock:
            self.in_flight -= 1
            if in_window:
                if exc is not None:
                    self.failed += 1
                    self.latencies.append(math.inf)
                else:
                    self.latencies.append((done - due) * 1e3)
                    self.answered_by_close += done < self.close
                    self._offer(idx, fut.result())
            self.idle.notify_all()

    def _offer(self, idx: int, answer: t.Dict[str, np.ndarray]) -> None:
        """Reservoir sampling (algorithm R) of the window's answers."""
        self.seen += 1
        if len(self.kept) < self.sample:
            self.kept.append((idx, answer))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.sample:
                self.kept[j] = (idx, answer)

    def drain(self) -> int:
        """Waits for the sender and every request in flight, a minute past
        the window's close or the sub-window's end at most; returns how many
        never came."""
        deadline = min(self.stop, self.open + float(self.due[-1])) + GRACE_S
        deadline = max(deadline, self.close + GRACE_S)
        self.thread.join(timeout=max(0.0, deadline - time.perf_counter()))
        with self.lock:
            while self.in_flight and time.perf_counter() < deadline:
                self.idle.wait(timeout=max(0.0, deadline - time.perf_counter()))
            unsent = len([a for a in self.due if a < self.close_s]) - len(self.late)
            return self.in_flight + unsent


class GcClock:
    """The seconds the interpreter spent in its cyclic garbage collector
    while this is entered, and the full collections among them: every
    thread of the process waits for a collection."""

    def __init__(self) -> None:
        self.seconds, self.full, self._start = 0.0, 0, None

    def _callback(self, phase: str, info: t.Dict[str, int]) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.seconds += time.perf_counter() - self._start
            self.full += info["generation"] == 2
            self._start = None

    def __enter__(self) -> "GcClock":
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc: t.Any) -> None:
        gc.callbacks.remove(self._callback)


def percentile(values: t.Sequence[float], q: float) -> float:
    """Nearest rank: the smallest value that ``q`` percent of ``values``
    meet."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)] if v else math.inf


def served_weights(r: Run, frames: torch.Tensor) -> t.Dict[str, torch.Tensor]:
    """The run's drawn weights with every BatchNorm's running statistics
    calibrated by the reference on the first ``CALIBRATION_FRAMES`` frames
    (``reference.common.calibrate_``), on the device: drawn weights with
    unit statistics would serve nearly constant maps, on which any
    precision gives the same classes."""
    model = seeded.reference_model(r.config, r.seed, r.device)
    img = decode({"img": frames[:CALIBRATION_FRAMES]}, r.device)["img"]
    with full_f32():
        calibrate_(model, img)
    return model.state_dict()


def build_server(r: Run) -> t.Tuple[BatchingServer, np.ndarray, t.Dict[str, torch.Tensor]]:
    """The cell's server on the run's weights, every bucket run once; the
    run's frames; the weights, on the host."""
    cfg, mix, dev = r.config, r.traffic, r.device
    h, w = cfg["height"], cfg["width"]
    frames = seeded.frames(r.seed, FRAMES, h, w, dev)
    weights = served_weights(r, frames)
    model = program_model(cfg, dev)
    model.load_state_dict(weights)
    weights = {k: v.cpu() for k, v in weights.items()}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    server = BatchingServer(model, h, w, buckets=mix["buckets"], max_wait_ms=mix["max_wait_ms"],
                            dtype=np.uint8, max_in_flight=mix["max_in_flight"],
                            compact_out=mix["compact_out"], device=dev)
    del model  # the server serves its own snapshot
    server.warmup()
    frames = frames.numpy()
    # a short load at the cell's rate: the host's pinned buffers and the
    # card's allocator reach the sizes the window needs before it opens
    warm = OpenLoop(server, frames, arrivals(mix["rate"], WARM_SECONDS, r.seed + 1),
                    WARM_SECONDS, r.seed, 0)
    warm.start(WARM_SECONDS)
    warm.drain()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return server, frames, weights


def run(r: Run) -> Outcome:
    cfg, mix, dev = r.config, r.traffic, r.device
    server, frames, weights = build_server(r)
    setup_s = time.perf_counter() - r.t0

    # a traced run goes on sending past the close, through its sub-window
    # (whose profiler takes a while to start): the schedule runs a minute on
    extra = TRACE_TAIL_S if r.trace else 0.0
    due = arrivals(mix["rate"], r.seconds + extra, r.seed)
    load = OpenLoop(server, frames, due, r.seconds, r.seed, SAMPLE)
    server.reset_stats()
    with GcClock() as collector:
        load.start(r.seconds + extra)
        time.sleep(max(0.0, load.close - time.perf_counter()))
    window_stats = server.stats()
    readings = None
    if r.trace:
        before, stats0 = kernels.launch_counts(), server.stats()
        with sub_window() as box:
            time.sleep(TRACE_SECONDS)
            load.stop = time.perf_counter()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        after, stats1 = kernels.launch_counts(), server.stats()
    never = load.drain()
    server.close()
    if r.trace:
        readings = Readings(kind="serve", config=cfg, traffic=mix, chips=r.chips,
                            rate=load.answered_by_close / r.seconds, trace=box["trace"],
                            launches={n: after[n] - before[n] for n in after},
                            serve_window=window_stats,
                            serve_traced={k: stats1[k] - stats0[k] for k in stats1})
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lat = load.latencies + [math.inf] * never
    r.notes.update(requests=len(lat), p50_ms=percentile(lat, 50), p95_ms=percentile(lat, 95),
                   sender_late_p95_ms=percentile(load.late, 95) * 1e3,
                   window_gc_s=collector.seconds, window_full_gcs=collector.full)
    del server
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compared = reference_gaps(r, cfg, load.kept, frames, weights, dev)
    return Outcome(values={"serve_img_per_s": load.answered_by_close / r.seconds,
                           "setup_s": setup_s},
                   compared=compared, attempted=len(lat), failed=load.failed + never,
                   memory_peak_bytes=peak, readings=readings)


def reference_gaps(r: Run, cfg, kept, frames: np.ndarray, weights, dev: torch.device,
                   precision=F32) -> t.Dict[str, float]:
    """The reference's forward on the sampled requests' frames, from the
    run's weights, held against the answers they were served."""
    if not kept:
        return {}
    with torch.device(dev):
        model = reference.build(cfg, precision)
    model.load_state_dict(weights)
    idx = [i for i, _ in kept]
    logits, depth = serve_outputs(model, torch.from_numpy(frames[idx]), dev)
    segm = torch.from_numpy(np.stack([a["segm"] for _, a in kept]))
    served_depth = torch.from_numpy(np.stack([a["depth"] for _, a in kept]).astype(np.float32))
    r.notes.update(sampled=len(kept))
    return compare.serve_gaps(segm, served_depth[..., 0], logits, depth)
