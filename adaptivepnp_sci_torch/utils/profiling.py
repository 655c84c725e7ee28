"""Profiling and tracing (port of ``adaptivepnp_sci_tpu.utils.profiling``).

The reference's only observability is ad-hoc ``time.time()`` spans and a
globally enabled ``torch.autograd.set_detect_anomaly(True)`` that slows every
backward (``packages/ffdnet/test_ffdnet_ipol.py:26``, deliberately not
replicated). Here: :func:`trace`, a ``torch.profiler`` trace of the host and
the CUDA device written as a Chrome trace (Perfetto, ``chrome://tracing``);
:func:`annotate`, the one span primitive, and :func:`count`, a counter of
the request a span is in, both recording only while ``torch.profiler``
records; :func:`spans`, the recorded spans; and :class:`StepTimer`, a
host-clock step timer that waits for the device.

The solvers open spans at their layer boundaries: ``apnp.solve`` (the
entries ``end_to_end.reconstruct_single_dispatch``, ``gap_tv.gap_tv`` and
``two_stage_admm.two_stage_admm``), ``apnp.warmstart``
(``gap_tv._gap_tv_packed``), ``apnp.admm.iter`` (each iteration of
``two_stage_admm.run_admm``) and, inside it, ``apnp.demosaic``,
``apnp.adapt`` (one trigger of ``adapt.online.make_adapt_fn``'s ``adapt``,
which counts ``apnp.adam_steps``) and ``apnp.prior``. Inside
``apnp.demosaic``, ``apnp.dm_adapt`` is the in-scan adaptation of the deep
demosaicker (``two_stage_admm.DmState.update``, which counts
``apnp.dm_adam_steps``) and ``apnp.ddnet`` each DDnet forward
(``priors.ddnet_demosaic_param``, which counts the windows in
``apnp.ddnet_windows``).

The JAX package's ``utils.enable_compile_cache`` has no counterpart: the CUDA
kernels are built once into ``adaptivepnp_sci_torch/_build/`` and loaded from
there by every later process.
"""

from __future__ import annotations

import functools
import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile

from adaptivepnp_sci_torch.utils.logging import _cuda_devices

#: the file :func:`trace` writes in its ``log_dir``
TRACE_NAME = "trace.json"


@contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the host and, when CUDA is available, the device:
    ``with trace(d) as prof: run_step()`` writes ``d/trace.json`` (Chrome
    trace format) on exit, also when the body raises; ``prof.key_averages()``
    gives the per-operator table."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


#: the most spans kept; past it the oldest go, counted by :func:`dropped`
MAX_SPANS = 50_000
#: the most closed spans whose events one span's entry takes back
RECLAIM = 8


class Span:
    """One recorded span. ``index`` numbers every span the process recorded,
    dropped ones included; ``parent`` is the index of the span it opened in
    (-1: an outermost span); ``request`` is shared by an outermost span and
    every span inside it. ``start_ns`` and ``end_ns`` are ``time.time_ns()``
    at entry and exit, the profiler's clock (``end_ns`` is None while the
    span is open). ``device_ms`` is the elapsed time between the CUDA events
    recorded at entry and exit on the stream current at entry: the span's
    length on the device's timeline, the time the device waited on the host
    inside it included (None without CUDA). ``counters`` holds an outermost
    span's request counters (:func:`count`)."""

    __slots__ = ("index", "name", "parent", "request", "start_ns", "end_ns", "device_ms",
                 "counters", "_events")

    def __init__(self, index: int, name: str, parent: int, request: int):
        self.index, self.name, self.parent, self.request = index, name, parent, request
        self.start_ns = self.end_ns = self.device_ms = None
        self.counters: dict[str, int] = {}
        self._events = None


class _Recorder:
    """The spans of the process: the newest :data:`MAX_SPANS` closed or open
    ones, and each thread's stack of open spans; the closed spans whose CUDA
    events are not read yet, and the events read and free to record again
    (creating an event costs two to four times the host time of recording
    one)."""

    def __init__(self):
        self.kept: deque[Span] = deque(maxlen=MAX_SPANS)
        self.dropped = 0
        self.indices = itertools.count()
        self.requests = itertools.count()
        self.local = threading.local()
        self.timed: deque[Span] = deque()
        self.free: list[torch.cuda.Event] = []

    def stack(self) -> list[Span]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def event(self) -> "torch.cuda.Event":
        """A timing event: a free one, else one taken back from the oldest
        closed spans that the device has passed, else a new one."""
        if not self.free:
            self.read(RECLAIM, wait=False)
        return self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)

    def read(self, n: int, wait: bool) -> None:
        """Resolve the device milliseconds of up to ``n`` of the oldest
        closed spans, in the order they closed, and free their events;
        without ``wait``, stop at the first whose end the device has not
        reached."""
        timed = self.timed
        while timed and n:
            start, end = timed[0]._events
            if not wait and not end.query():
                return
            span = timed.popleft()
            span.device_ms = start.elapsed_time(end)
            span._events = None
            self.free += (start, end)
            n -= 1


_RECORDER = _Recorder()
_STREAMS: dict[tuple, "torch.cuda.Stream"] = {}


def _current_stream() -> "torch.cuda.Stream":
    """The current CUDA stream, one object per stream: building one
    (``torch.cuda.current_stream``) costs more host time than recording an
    event on it."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.Stream(stream_id=key[0], device_index=key[1],
                                                   device_type=key[2])
    return stream


class _Live:
    """A span while the profiler records: a function-scope range (a host
    ``cpu_op`` in the profiler's events, never mirrored on the device), the
    host clock and, on CUDA, a pair of timing events on the stream current
    at entry."""

    __slots__ = ("name", "_range", "_span", "_stream")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Live":
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()
        rec = _RECORDER
        stack = rec.stack()
        parent = stack[-1] if stack else None
        span = Span(next(rec.indices), self.name, -1 if parent is None else parent.index,
                    next(rec.requests) if parent is None else parent.request)
        if len(rec.kept) == rec.kept.maxlen:
            rec.dropped += 1
        rec.kept.append(span)
        stack.append(span)
        self._span = span
        span.start_ns = time.time_ns()
        if torch.cuda.is_initialized():
            self._stream = _current_stream()
            start = rec.event()
            start.record(self._stream)
            span._events = (start, None)
        return self

    def __exit__(self, *exc) -> None:
        span = self._span
        if span._events is not None:
            rec = _RECORDER
            end = rec.event()
            end.record(self._stream)
            span._events = (span._events[0], end)
            rec.timed.append(span)
        span.end_ns = time.time_ns()
        _RECORDER.stack().pop()
        self._range.__exit__(*exc)

    def __call__(self, fn):
        return _decorated(self.name, fn)


class _Noop:
    """A span while the profiler is off: records nothing."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __call__(self, fn):
        return _decorated(self.name, fn)


_NOOPS: dict[str, _Noop] = {}


def _decorated(name: str, fn):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with annotate(name):
            return fn(*args, **kwargs)

    return spanned


def annotate(name: str) -> _Live | _Noop:
    """A named span, as a context (``with annotate("step"): ...``) or a
    decorator (``@annotate("step")``, which opens the span at each call).

    With ``torch.profiler`` off it costs one check and hands back the
    shared no-op of ``name``. While the profiler records, the span is a
    ``cpu_op`` in its events and in :func:`trace`'s timeline, and is kept in
    memory (:func:`spans`) with its host times, its CUDA events, its parent
    and its request."""
    if not _autograd_profiler._is_profiler_enabled:
        noop = _NOOPS.get(name)
        if noop is None:
            noop = _NOOPS[name] = _Noop(name)
        return noop
    return _Live(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open request (the outermost
    open span's ``counters``); nothing while the profiler is off or no span
    is open."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _RECORDER.stack()
    if stack:
        counters = stack[0].counters
        counters[name] = counters.get(name, 0) + n


def spans() -> list[Span]:
    """The kept spans, oldest first; the closed spans' device milliseconds
    not resolved while recording are resolved here, after one
    synchronize."""
    rec = _RECORDER
    if rec.timed:
        torch.cuda.synchronize()
        rec.read(len(rec.timed), wait=True)
    return list(rec.kept)


def dropped() -> int:
    """How many spans went past :data:`MAX_SPANS`."""
    return _RECORDER.dropped



class StepTimer:
    """Host-clock step timer; keeps every step's seconds."""

    def __init__(self):
        self.history: list[float] = []

    @contextmanager
    def measure(self) -> Iterator[dict]:
        """``with timer.measure() as h: h['out'] = step(...)``: the CUDA
        devices of the tensors in ``h['out']`` (a tensor, or nested lists,
        tuples and dicts of them) are synchronised before the clock stops."""
        holder: dict = {}
        t0 = time.perf_counter()
        yield holder
        for dev in _cuda_devices(holder.get("out")):
            torch.cuda.synchronize(dev)
        self.history.append(time.perf_counter() - t0)

    @property
    def best(self) -> float:
        return min(self.history)

    @property
    def mean(self) -> float:
        return sum(self.history) / len(self.history)
