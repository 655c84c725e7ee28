"""The benchmark harness: one run of one cell.

A cell (``BENCHMARK.json``'s ``workloads``) is a configuration
(``configs/<config>.json``) under a traffic mix (``traffic/<traffic>.json``).
The harness finds everything by name: the entry the traffic drives
(``entries/<entry>.py``), the configuration's model (``models/<model>.py``),
each metric's reader (``metrics/<name>.py``) and the cell's limits of the
comparison with the reference (``limits/<cell>.json``).

A run:

1. set-up: the kernels built or loaded, the weights, the camera's masks and
   the scene pool made from the seed, the cell's own shapes warmed up by
   ``warmup`` requests (``setup_s`` ends here);
2. the window: one client in a closed loop hands a measurement over on the
   host, waits for the reconstruction on the host and hands over the next,
   for ``seconds`` (the request running at the close finishes; the window
   ends with it). With ``trace``, the benchmark's CUDA-event span is around
   every prior call, and ``trace_requests`` requests from the window's
   second on run under ``torch.profiler``;
3. after the window: the peak memory read, the program's state freed, then
   the plain reference recomputes the requests drawn from the seed and the
   numbers of the comparison are held to the cell's limits.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any

import torch

from pnpbench import trace as trace_mod
from pnpbench import traffic as traffic_mod

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "adaptivepnp_sci_tpu")


def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def load_module(kind: str, name: str) -> ModuleType:
    """``pnpbench/<kind>/<name>.py``; a dotted name is a file in subfolders
    (``a.b``: ``<kind>/a/b.py``)."""
    return importlib.import_module(f"pnpbench.{kind}.{name}")


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, overrides: dict | None = None,
              benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``benchmark``; ``overrides`` (``{"config": ...,
    "traffic": ...}``) replace values, for tests at a small size."""
    bench = load_json(benchmark)
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in {benchmark.name}")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    overrides = overrides or {}
    config = _merge(load_json(ROOT / entry["file"]), overrides.get("config", {}))
    traffic = _merge(load_json(PKG / "traffic" / f"{wl['traffic']}.json"),
                     overrides.get("traffic", {}))

    def mine(m: dict) -> bool:
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, int(wl["chips"]), config, traffic, load_json(PKG / "limits" / f"{name}.json"),
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


class Spans:
    """The benchmark's span around each call of the prior's ``apply`` (CUDA
    events; no timing on the CPU), and counts of the prior's calls and of
    the adaptation's forwards."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.reset()

    def reset(self) -> None:
        self.events: list = []
        self.apply_calls = 0
        self.adapt_calls = 0

    def wrap_prior(self, prior):
        """``prior`` with ``apply`` in the span and ``apply_adapt`` counted;
        the adaptation keeps its own forward (``apply`` unwrapped where it
        had none)."""
        apply = prior.apply
        adapt = prior.apply_adapt or prior.apply

        def timed(net, rgb, sigma):
            self.apply_calls += 1
            if not self.cuda:
                return apply(net, rgb, sigma)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = apply(net, rgb, sigma)
            e.record()
            self.events.append((s, e))
            return out

        def counted(net, rgb, sigma):
            self.adapt_calls += 1
            return adapt(net, rgb, sigma)

        return prior._replace(apply=timed, apply_adapt=counted)

    @property
    def apply_ms(self) -> list[float]:
        if self.events:
            torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


@dataclass
class Context:
    """What the metric readers read."""

    cell: Cell
    model: ModuleType | None
    peaks: dict
    setup_s: float
    window_s: float
    completed: int
    latencies: list
    peak_bytes: int | None
    spans: Spans | None
    trace: trace_mod.Trace | None
    tv_iterations: float | None

    def kernel_s(self, name: str) -> float:
        return trace_mod.kernel_s(self.trace, name)

    @property
    def busy_s(self) -> float:
        return trace_mod.busy_s(self.trace)


def forbidden_modules() -> list[str]:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _launch_counters():
    from adaptivepnp_sci_torch.ops import cuda_kernels

    return dict(cuda_kernels.launches), dict(cuda_kernels.convpair_launches)


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


@dataclass
class Outcome:
    result: dict          # the result line
    checks: list[str]     # each number compared beside its limit
    numbers: dict         # every number the entry computes, the worst over the checked requests
    forbidden: list[str]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device | str,
        t_process: float, log=sys.stderr) -> Outcome:
    """One run of ``cell``; ``t_process`` is the process's start on
    ``time.perf_counter``'s clock."""
    device = torch.device(device)
    marks = [("imports", time.perf_counter())]

    def mark(what: str) -> None:
        marks.append((what, time.perf_counter()))

    entry = load_module("entries", cell.traffic["entry"])
    model = load_module("models", cell.config["model"]) if entry.NEEDS_MODEL else None
    peaks = load_json(PKG / "peaks.json")
    if device.type == "cuda":
        from adaptivepnp_sci_torch.ops import cuda_kernels

        cuda_kernels.build()
    mark("kernels built or loaded")
    plan = traffic_mod.make(cell.traffic, seed, device)
    mark("masks and scene pool")
    params = model.weights(cell.config, seed, device) if model is not None else None
    spans = Spans(device) if trace else None
    serve = entry.program(cell, model, params, plan, device, spans)
    mark("weights and program")
    pool = len(plan.measurements)
    host: list = []  # the client's result buffer, page-locked on a card, reused

    def to_host(x: torch.Tensor) -> torch.Tensor:
        if not host or host[0].shape != x.shape or host[0].dtype != x.dtype:
            host[:] = [torch.empty(x.shape, dtype=x.dtype, pin_memory=device.type == "cuda")]
        return host[0].copy_(x)

    for k in range(int(cell.traffic["warmup"])):
        to_host(serve(plan.measurements[plan.order[k % pool]],
                      traffic_mod.noise_seed(seed, -1 - k))[0])
        mark(f"warm-up request {k + 1}")
    profiling = trace and device.type == "cuda"
    if profiling:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=activities):  # the profiler's own first start
            torch.zeros(1, device=device).add_(1)
        mark("profiler warm-up")
    _sync(device)
    setup_s = time.perf_counter() - t_process
    parts = [f"{what} {b - a:.3f}" for (_, a), (what, b) in zip(marks, marks[1:])]
    print(f"setup_s {setup_s:.3f}: process start to run {marks[0][1] - t_process:.3f}, "
          + ", ".join(parts), file=log)

    # ---------------------------------------------------------- the window
    if spans is not None:
        spans.reset()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sample = set(plan.sample)
    first, last = 1, 1 + int(cell.traffic["trace_requests"])
    latencies: list[float] = []
    kept: dict[int, tuple] = {}
    attempted = failed = 0
    prof = profiled = None
    counters0 = counters1 = None
    paused = 0.0
    t0 = time.perf_counter()
    i = 0
    while True:
        if trace and i == first and profiling:
            tp = time.perf_counter()  # the profiler's start and stop are left out of the window
            counters0 = _launch_counters()
            prof = profile(activities=activities)
            prof.start()
            paused += time.perf_counter() - tp
        idx = int(plan.order[i % pool])
        ns = traffic_mod.noise_seed(seed, i)
        attempted += 1
        ts = time.perf_counter()
        try:
            with (torch.profiler.record_function(trace_mod.MARKER) if prof is not None
                  else contextlib.nullcontext()):
                x, variables = serve(plan.measurements[idx], ns)
                x = to_host(x)
        except Exception:  # a request that fails is counted, and the run goes on
            failed += 1
            if failed == 1:
                traceback.print_exc(file=log)
            x = variables = None
        te = time.perf_counter()
        if x is not None:
            latencies.append(te - ts)
        if prof is not None and i == last - 1:
            tp = time.perf_counter()
            _sync(device)
            prof.stop()
            counters1 = _launch_counters()
            profiled, prof = prof, None
            paused += time.perf_counter() - tp
        i += 1
        end = i >= (last if trace else 1) and time.perf_counter() - t0 >= seconds
        if end:
            t_end = time.perf_counter()
        # the checked requests' results; the last one stands in for those a
        # window too short never reached
        if x is not None and (i - 1 in sample or end and len(kept) < len(sample)):
            tk = time.perf_counter()
            kept[i - 1] = (idx, ns, x.clone(), None if variables is None else {
                k: v.detach().cpu() for k, v in variables.items()})
            if not end:
                paused += time.perf_counter() - tk
        del x, variables
        if end:
            break
    window_s = t_end - t0 - paused
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    completed = len(latencies)
    tr = None if profiled is None else trace_mod.collect(
        profiled, _delta(counters1[0], counters0[0]), _delta(counters1[1], counters0[1]))
    print(f"window: {completed} of {attempted} requests in {window_s:.3f} s; latency samples "
          f"{completed}", file=log)
    if latencies:
        med = sorted(latencies)[len(latencies) // 2]
        slow = [(j, round(t, 3)) for j, t in enumerate(latencies) if t > 1.5 * med]
        print(f"latency s: min {min(latencies):.4f} median {med:.4f} max {max(latencies):.4f}; "
              f"over 1.5x the median: {slow}", file=log)
    del serve
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ------------------------------------------------------ the comparison
    stated = entry.stated_precision(cell)
    numbers: dict[str, float] = {}
    tv_its = []
    for _, (idx, ns, x, host_vars) in sorted(kept.items()):
        ref = entry.reference(cell, model, params, plan.masks, plan.measurements[idx], ns,
                              device, stated)
        for k, v in entry.numbers(cell, model, params, x, host_vars, ref).items():
            numbers[k] = max(numbers.get(k, v), v)
        if ref.get("tv_iterations") is not None:
            tv_its.append(ref["tv_iterations"])
    correct = bool(kept) and failed == 0 and all(
        numbers.get(k, float("nan")) <= lim for k, lim in cell.limits.items())
    checks = [f"check {k} {numbers.get(k, float('nan'))!r} limit {lim!r}"
              for k, lim in cell.limits.items()]
    print(f"checked requests {sorted(kept)}", file=log)

    # --------------------------------------------------------- the metrics
    ctx = Context(cell, model, peaks, setup_s, window_s, completed, latencies, peak, spans, tr,
                  sum(tv_its) / len(tv_its) if tv_its else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end) if device.type == "cuda" else ():
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if tr is not None:
        dev["busy_s"] = ctx.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = trace_mod.breakdown(tr)
    result["check"] = {k: {"value": numbers.get(k), "limit": lim}
                       for k, lim in cell.limits.items()}
    return Outcome(result, checks, numbers, forbidden_modules())
