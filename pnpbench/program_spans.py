"""The program's own spans (``adaptivepnp_sci_torch.utils.profiling``), for
the per-layer readers: the spans that lie inside the profiled requests of
the traced window, by their host times on the profiler's clock, each with
the device milliseconds of its CUDA events. Those are the span's length on
the device's timeline, from the stream reaching its entry to the stream
reaching its exit: the time the device waited on the host inside the span
is in them, so a span paced by the host reads longer than its kernels.

A program without the recorder, or a run without a device, gives no spans:
the readers then return None and the metric is left out of the line. So
does a window some of whose spans the recorder's bounded store dropped.
"""

from __future__ import annotations


def in_window(ctx) -> list:
    """The closed spans with device times inside ``ctx.trace.requests_ns``."""
    tr = ctx.trace
    if tr is None:
        return []
    from adaptivepnp_sci_torch.utils import profiling

    recorded = getattr(profiling, "spans", None)
    if recorded is None:
        return []
    kept = recorded()
    if kept and profiling.dropped() and kept[0].start_ns >= tr.requests_ns[0][0]:
        return []
    return [s for s in kept if s.end_ns is not None and s.device_ms is not None
            and any(a <= s.start_ns and s.end_ns <= b for a, b in tr.requests_ns)]


def _mean(values: list) -> float | None:
    return sum(values) / len(values) if values else None


def mean_ms(ctx, name: str) -> float | None:
    """The mean device milliseconds of the spans ``name``."""
    return _mean([s.device_ms for s in in_window(ctx) if s.name == name])


def mean_self_ms(ctx, name: str) -> float | None:
    """The mean self time of the spans ``name``: each span's device
    milliseconds less those of the spans opened directly inside it."""
    spans = in_window(ctx)
    children: dict[int, float] = {}
    for s in spans:
        children[s.parent] = children.get(s.parent, 0.0) + s.device_ms
    return _mean([s.device_ms - children.get(s.index, 0.0) for s in spans if s.name == name])


def ms_per_count(ctx, name: str, counter: str) -> float | None:
    """The device milliseconds of the spans ``name`` over the counter
    ``counter``, both summed over the requests of the window: each request
    is an outermost span, which holds the request's counters."""
    spans = in_window(ctx)
    requests = {s.request: s for s in spans if s.parent == -1}
    n = sum(r.counters.get(counter, 0) for r in requests.values())
    ms = sum(s.device_ms for s in spans if s.name == name and s.request in requests)
    return ms / n if n else None
