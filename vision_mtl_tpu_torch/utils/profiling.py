"""Tracing (counterpart of ``vision_mtl_tpu/utils/profiling.py``): a
``torch.profiler`` trace around a block of work, written as a Chrome trace;
and the program's spans, named regions at its layer boundaries that record
themselves while a profiler session is on.

``span(name, device_time=False, **ids)`` marks a region. With no profiler
session on it reads one flag and does nothing else. While a session is on
(:func:`trace`, or any ``torch.profiler.profile``) it enters
``torch.profiler.record_function(name)``, so the session's trace shows the
region in place, and keeps a :class:`Span` in a bounded buffer in memory
(the newest :data:`CAPACITY`): its name, its start and end on
``time.time_ns()`` (the clock of the session's trace, :func:`trace_us`), its
thread, the enclosing span on that thread, the ``ids`` it was given, and,
for a span asked for its ``device_time`` where the program runs on CUDA, two
timing events on the current stream at its start and end. :func:`spans`
returns the buffer with each such span's device milliseconds read from its
events. Tracing is on exactly while a session is: there is no other switch.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
import typing as t

import torch
from torch.autograd import profiler as _autograd_profiler

_trace_ids = itertools.count()
#: spans the buffer keeps, the newest; older ones are counted by :func:`dropped`
CAPACITY = 1 << 16
#: the profiler trace's clock counts microseconds from unix time rounded
#: down to a multiple of this many seconds (Kineto's base time, the Chrome
#: trace's ``baseTimeNanoseconds``)
_TRACE_BASE_NS = 7889238 * 10**9


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


@dataclasses.dataclass
class Span:
    """One recorded region. ``number`` counts the spans started since
    :func:`clear_spans`; ``parent`` is the number of the span that enclosed
    it on the same thread. ``start_ns``/``end_ns`` are ``time.time_ns()``
    (``end_ns`` 0 while it is open); ``device_ms`` the time between its two
    CUDA events, None where it was not asked for or there is no CUDA."""

    name: str
    number: int
    start_ns: int
    thread: int
    parent: t.Optional[int]
    ids: t.Dict[str, t.Any]
    end_ns: int = 0
    device_ms: t.Optional[float] = None
    events: t.Optional[t.Tuple[torch.cuda.Event, torch.cuda.Event]] = dataclasses.field(
        default=None, repr=False)


class _Buffer:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.local = threading.local()  # .open: this thread's open spans' numbers
        self.clear()

    def clear(self) -> None:
        with self.lock:
            self.spans: t.Deque[Span] = collections.deque()
            self.started = self.dropped = 0


_BUFFER = _Buffer()


class _Recording:
    """The context of one span while a session is on."""

    __slots__ = ("name", "device_time", "ids", "span", "function")

    def __init__(self, name: str, device_time: bool, ids: t.Dict[str, t.Any]):
        self.name, self.device_time, self.ids = name, device_time, ids
        self.span: t.Optional[Span] = None
        self.function = None

    def __enter__(self) -> None:
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        start = time.time_ns()
        events = None
        if self.device_time and torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        stack = getattr(_BUFFER.local, "open", None)
        if stack is None:
            stack = _BUFFER.local.open = []
        with _BUFFER.lock:
            s = Span(self.name, _BUFFER.started, start, threading.get_ident(),
                     stack[-1] if stack else None, self.ids, events=events)
            _BUFFER.started += 1
            if len(_BUFFER.spans) >= CAPACITY:
                _BUFFER.spans.popleft()
                _BUFFER.dropped += 1
            _BUFFER.spans.append(s)
        stack.append(s.number)
        self.span = s

    def __exit__(self, *exc: t.Any) -> None:
        s = self.span
        if s.events is not None:
            s.events[1].record()
        s.end_ns = time.time_ns()
        _BUFFER.local.open.pop()
        self.function.__exit__(*exc)


_OFF = contextlib.nullcontext()


def span(name: str, device_time: bool = False, **ids: t.Any) -> t.ContextManager[None]:
    """A named region of the program, recorded only while a profiler
    session is on (see the module's docstring). ``device_time`` records its
    two CUDA events, for a span whose device milliseconds are read; ``ids``
    tie the spans of one unit of work together, e.g. a served batch's
    number."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, device_time, ids)


def spans() -> t.List[Span]:
    """The recorded spans in the order they started, each closed one's
    ``device_ms`` read from its events (which waits for them)."""
    with _BUFFER.lock:
        out = list(_BUFFER.spans)
    for s in out:
        if s.events is not None and s.end_ns:
            s.events[1].synchronize()
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
    return out


def dropped() -> int:
    """Spans pushed out of the buffer, the oldest, since the last
    :func:`clear_spans`: it keeps the newest ``CAPACITY``."""
    return _BUFFER.dropped


def clear_spans() -> None:
    _BUFFER.clear()


def trace_us(ns: int) -> float:
    """A ``time.time_ns()`` reading on the clock of a profiler session's
    Chrome trace: the ``ts`` (microseconds) an event at that instant has."""
    return (ns % _TRACE_BASE_NS) / 1e3
