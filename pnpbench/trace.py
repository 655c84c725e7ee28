"""Reading a ``torch.profiler`` run from its raw events (no event tree is
built: a FastDVDnet snapshot leaves ~150,000 events).

The traced window is the time the profiled requests were in flight: the
union of their ``pnpbench.request`` ranges on the profiler's clock (the
client's own work between requests is not in it). Device time is the union
of the intervals of device events (kernels, copies, sets) inside it; an idle
gap is a stretch of it with no device event, named by the innermost host
event that covers at least half of it.
"""

from __future__ import annotations

from typing import NamedTuple

MARKER = "pnpbench.request"


class Event(NamedTuple):
    start: int   # ns
    end: int     # ns
    name: str


class Trace(NamedTuple):
    requests_ns: list          # (start, end) of each profiled request, ns, by start
    device: list[Event]        # device events clipped to the requests, by start
    host: list[Event]
    launches: dict             # the program's kernel launch counters, deltas over the window
    convpair_launches: dict    # K3's launches by (C, H, W), deltas

    @property
    def window_s(self) -> float:
        return sum(b - a for a, b in self.requests_ns) / 1e9


def collect(prof, launches: dict, convpair_launches: dict) -> Trace:
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        ev = Event(start, start + e.duration_ns(), e.name())
        if e.device_type() == DeviceType.CPU:
            host.append(ev)
        elif not ev.name.startswith("pnpbench."):  # range annotations mirrored on the device
            dev.append(ev)
    marks = sorted((e.start, e.end) for e in host if e.name == MARKER)
    if not marks:
        raise RuntimeError("the profiler recorded no request")
    dev = sorted((Event(max(e.start, a), min(e.end, b), e.name) for e in dev for a, b in marks
                  if e.end > a and e.start < b), key=lambda e: e.start)
    return Trace(marks, dev, host, launches, convpair_launches)


def busy_intervals(trace: Trace) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for e in trace.device:
        if out and e.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e.end)
        else:
            out.append([e.start, e.end])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace)) / 1e9


def kernel_s(trace: Trace, name: str) -> float:
    """Device seconds of the kernels whose name holds ``name`` and ``_kernel``
    (every design and form of one of the program's kernels)."""
    return sum(e.end - e.start for e in trace.device
               if name in e.name and "_kernel" in e.name) / 1e9


def _gaps(trace: Trace) -> list[tuple[int, int]]:
    busy = busy_intervals(trace)
    gaps = []
    for r0, r1 in trace.requests_ns:
        t = r0
        for a, b in busy:
            if b <= r0 or a >= r1:
                continue
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if r1 > t:
            gaps.append((t, r1))
    return gaps


def _host_doing(trace: Trace, a: int, b: int) -> str:
    best, best_len = None, None
    for e in trace.host:
        if e.name == MARKER or e.end <= a or e.start >= b:
            continue
        cover = min(e.end, b) - max(e.start, a)
        if 2 * cover >= b - a and (best_len is None or e.end - e.start < best_len):
            best, best_len = e.name, e.end - e.start
    return best or "no profiled host op"


def breakdown(trace: Trace, n: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    by what the host was doing; seconds."""
    by_name: dict[str, int] = {}
    for e in trace.device:
        by_name[e.name] = by_name.get(e.name, 0) + e.end - e.start
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(_gaps(trace), key=lambda g: g[0] - g[1])[:n]
    return {"device_ops": [[k[:120], v / 1e9] for k, v in ops],
            "idle_gaps": [[_host_doing(trace, a, b)[:120], (b - a) / 1e9] for a, b in gaps]}
