"""The program's spans read against the traced sub-window, for the
per-layer metrics that read them (``metrics/*.py``).

The program records a span (``vision_mtl_tpu_torch.utils.profiling.span``)
only while a profiler session is on, so after a traced run its buffer holds
the spans of the sub-window's session: each with its host interval on
``time.time_ns()``, which ``profiling.trace_us`` maps onto the trace's
clock, its thread, its ids and, where asked for, its CUDA-event
milliseconds. A span falls inside the sub-window when its mapped interval
overlaps it (a served batch dispatched across an edge is the sub-window's),
and is clipped to it. A reader finds nothing (``None``) where the program
records no spans (a checkout without them), where the count of its spans
inside is not what the sub-window ran, or where under ``INSIDE`` of its
spans fall inside: the clocks were mapped wrong.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs one traced run of the cell (whatever ``--trace`` says) with
``run.py``'s arguments and checks, and prints, in place of a result line,
the sub-window's idle split by the innermost span running on the host at
each instant (``idle_by_span``), the spans recorded, and for a served cell
the worker's wall and CPU milliseconds a dispatched batch.
"""

from __future__ import annotations

import sys
import typing as t
from pathlib import Path

if __name__ == "__main__":  # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.trace import Trace  # noqa: E402

#: the least share of a reader's spans that fall inside the sub-window
INSIDE = 0.9
#: where the host was inside no span
NO_SPAN = "no span"


def recorded() -> t.Optional[t.List[t.Any]]:
    """The program's closed spans (``profiling.Span``), or None where the
    program records none."""
    try:
        from vision_mtl_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return [s for s in spans() if s.end_ns]


def on_trace(s: t.Any) -> t.Tuple[float, float]:
    """A span's host interval on the trace's clock (microseconds)."""
    from vision_mtl_tpu_torch.utils.profiling import trace_us

    return trace_us(s.start_ns), trace_us(s.end_ns)


def host_us(s: t.Any) -> float:
    return (s.end_ns - s.start_ns) / 1e3


def overlaps(s: t.Any, trace: Trace) -> bool:
    start, end = on_trace(s)
    return start < trace.end_us and end > trace.start_us


def named(r: t.Any, name: str, count: t.Optional[int] = None) -> t.Optional[t.List[t.Any]]:
    """The spans called ``name`` that fall inside the sub-window; None where
    there are none, where they are not ``count`` (when given), or where
    under ``INSIDE`` of those recorded fall inside."""
    found = [s for s in recorded() or [] if s.name == name]
    hits = [s for s in found if overlaps(s, r.trace)]
    if not hits or len(hits) < INSIDE * len(found):
        return None
    if count is not None and len(hits) != count:
        return None
    return hits


def device_ms_per_step(r: t.Any, name: str, per_step: int = 1) -> t.Optional[float]:
    """A training cell's CUDA-event milliseconds of the spans ``name`` a
    step, where the sub-window holds ``per_step`` of them a step."""
    if r.kind != "train":
        return None
    hits = named(r, name, per_step * r.steps)
    if hits is None or any(s.device_ms is None for s in hits):
        return None
    return sum(s.device_ms for s in hits) / r.steps


def idle_under_us(trace: Trace, intervals: t.Iterable[t.Tuple[float, float]]) -> float:
    """Microseconds of the sub-window in which no device operation ran and
    the host was inside one of ``intervals``: the union of the device's
    operations and the intervals (clipped to the sub-window) less the
    device's own."""
    lo, hi = trace.start_us, trace.end_us
    host = [("host", max(s, lo), min(e, hi) - max(s, lo)) for s, e in intervals
            if min(e, hi) > max(s, lo)]
    both = Trace(device=trace.device + host, host=[], start_us=lo, end_us=hi)
    return both.busy_us() - trace.busy_us()


def paced_idle(r: t.Any, hits: t.Sequence[t.Any]) -> float:
    """The share (%) of the sub-window in which no device operation ran while
    the host was inside one of ``hits``."""
    return 100.0 * idle_under_us(r.trace, map(on_trace, hits)) / r.trace.window_us


def whole_batches(hits: t.Sequence[t.Any]) -> bool:
    """The spans' ``batch`` ids run without a gap: every batch the
    sub-window dispatched has its span."""
    ids = sorted(s.ids.get("batch", -1) for s in hits)
    return ids == list(range(ids[0], ids[0] + len(ids)))


def idle_by_span(r: t.Any) -> t.Dict[str, float]:
    """The sub-window's idle seconds by the innermost span (the latest
    started of those running, on any thread) at each instant."""
    lo, hi = r.trace.start_us, r.trace.end_us
    inside = [(s.name,) + on_trace(s) for s in recorded() or [] if overlaps(s, r.trace)]
    cuts = sorted({lo, hi} | {x for _, a, b in inside for x in (a, b) if lo < x < hi})
    pieces: t.Dict[str, t.List[t.Tuple[float, float]]] = {}
    for a, b in zip(cuts, cuts[1:]):
        running = [x for x in inside if x[1] <= (a + b) / 2 < x[2]]
        name = max(running, key=lambda x: x[1])[0] if running else NO_SPAN
        pieces.setdefault(name, []).append((a, b))
    out = {name: idle_under_us(r.trace, p) / 1e6 for name, p in pieces.items()}
    return dict(sorted(((k, v) for k, v in out.items() if v > 0), key=lambda kv: -kv[1]))


def main(argv: t.Optional[t.Sequence[str]] = None) -> int:
    import json
    import time

    t0 = time.perf_counter()
    from portbench import harness, run

    args = run.parse(argv)
    bench = harness.load_benchmark(run.ROOT)
    entry = harness.cell_entry(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"spans: {args.workload} needs {entry['chips']} CUDA card(s)", file=sys.stderr)
        return 2
    cell = harness.make_run(bench, args.workload, args.seed, args.seconds, True,
                            torch.device("cuda", 0), t0)
    r = harness.kind_module(cell.traffic["kind"]).run(cell).readings
    found = harness.forbidden_modules()
    if found:
        print(f"spans: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    spans = recorded() or []
    inside = [s for s in spans if overlaps(s, r.trace)]
    line: t.Dict[str, t.Any] = {
        "cell": cell.cell, "window_s": r.trace.window_us / 1e6,
        "window_ms_per_step": r.trace.window_us / 1e3 / r.steps if r.steps else None,
        "idle_s": (r.trace.window_us - r.trace.busy_us()) / 1e6,
        "idle_s_by_span": idle_by_span(r),
        "recorded": {n: sum(s.name == n for s in spans) for n in sorted({s.name for s in spans})},
        "in_sub_window": {n: sum(s.name == n for s in inside)
                          for n in sorted({s.name for s in inside})}}
    stats = r.serve_window or {}
    if stats.get("batches") and "dispatch_cpu_s" in stats:
        line["dispatch_ms_per_batch"] = 1e3 * stats["dispatch_s"] / stats["batches"]
        line["dispatch_cpu_ms_per_batch"] = 1e3 * stats["dispatch_cpu_s"] / stats["batches"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
