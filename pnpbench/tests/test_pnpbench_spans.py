"""The readers of the program's spans (``program_spans.py`` and the six
metrics that use it): on the CPU with synthetic spans and a synthetic trace;
on the card with a traced adaptive run at 256^2."""

from types import SimpleNamespace

import pytest

from pnpbench import harness, program_spans
from pnpbench import trace as trace_mod
from pnpbench.metrics import (adapt_ms_per_step, adapt_ms_per_trigger, admm_self_ms_per_iter,
                              demosaic_ms_per_call, solve_self_ms, warmstart_ms)

READERS = {"warmstart_ms": warmstart_ms, "solve_self_ms": solve_self_ms,
           "admm_self_ms_per_iter": admm_self_ms_per_iter,
           "demosaic_ms_per_call": demosaic_ms_per_call,
           "adapt_ms_per_trigger": adapt_ms_per_trigger, "adapt_ms_per_step": adapt_ms_per_step}


def span(index, name, parent, start, end, ms, request=0, **counters):
    return SimpleNamespace(index=index, name=name, parent=parent, request=request,
                           start_ns=start, end_ns=end, device_ms=ms, counters=counters)


#: one request inside the profiled window (100..200 ns), one outside it, and
#: a span without device time
SPANS = [
    span(0, "apnp.solve", -1, 110, 190, 10.0, **{"apnp.adam_steps": 2}),
    span(1, "apnp.warmstart", 0, 111, 120, 2.0),
    span(2, "apnp.admm.iter", 0, 121, 150, 3.0),
    span(3, "apnp.demosaic", 2, 122, 125, 0.5),
    span(4, "apnp.adapt", 2, 126, 130, 1.0),
    span(5, "apnp.prior", 2, 131, 140, 1.0),
    span(6, "apnp.admm.iter", 0, 151, 180, 2.0),
    span(7, "apnp.prior", 6, 152, 170, 1.0),
    span(8, "apnp.solve", -1, 210, 290, 100.0, 1, **{"apnp.adam_steps": 4}),
    span(9, "apnp.warmstart", 8, 211, 250, 50.0, 1),
    span(11, "apnp.adapt", 8, 251, 260, 9.0, 1),
    span(10, "apnp.demosaic", 6, 171, 175, None),
]
WANT = {"warmstart_ms": 2.0, "solve_self_ms": 10.0 - 2.0 - 3.0 - 2.0,
        "admm_self_ms_per_iter": ((3.0 - 2.5) + (2.0 - 1.0)) / 2, "demosaic_ms_per_call": 0.5,
        "adapt_ms_per_trigger": 1.0, "adapt_ms_per_step": 1.0 / 2}


def ctx_of(requests):
    return SimpleNamespace(trace=SimpleNamespace(requests_ns=requests))


@pytest.fixture
def recorded(monkeypatch):
    from adaptivepnp_sci_torch.utils import profiling

    def put(spans, dropped=0):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
        monkeypatch.setattr(profiling, "dropped", lambda: dropped)

    return put


def test_readers_keep_the_profiled_requests_and_subtract_children(recorded):
    recorded(SPANS)
    ctx = ctx_of([(100, 200), (300, 400)])
    assert {k: r.read(ctx) for k, r in READERS.items()} == pytest.approx(WANT)
    assert [s.index for s in program_spans.in_window(ctx)] == list(range(8))


def test_readers_read_nothing_without_spans(recorded, monkeypatch):
    recorded(SPANS)
    assert all(r.read(ctx_of([(300, 400)])) is None for r in READERS.values())
    assert all(r.read(SimpleNamespace(trace=None)) is None for r in READERS.values())
    recorded([])
    assert all(r.read(ctx_of([(100, 200)])) is None for r in READERS.values())
    # the store dropped spans older than the first one it kept: a window
    # that starts before it is left unread, one that starts after it is read
    recorded(SPANS, dropped=3)
    assert all(r.read(ctx_of([(100, 200)])) is None for r in READERS.values())
    assert warmstart_ms.read(ctx_of([(200, 300)])) == 50.0
    assert adapt_ms_per_step.read(ctx_of([(200, 300)])) == 9.0 / 4
    # a program without the recorder
    from adaptivepnp_sci_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert all(r.read(ctx_of([(100, 200)])) is None for r in READERS.values())


@pytest.mark.cuda
def test_traced_run_reports_the_span_metrics(cuda_device, monkeypatch):
    collected, real = [], trace_mod.collect

    def collect(*args):
        collected.append(real(*args))
        return collected[-1]

    monkeypatch.setattr(trace_mod, "collect", collect)
    cell = harness.load_cell("ffdnet_color.adaptive512", {"traffic": {
        "height": 256, "width": 256, "pool": 2, "warmup": 1, "check_requests": 1,
        "check_among_first": 2}})
    out = harness.run(cell, 2 ** 31 + 303, 1.0, True, cuda_device, 0.0)
    assert out.result["correct"], out.checks
    metrics = {k: v["value"] for k, v in out.result["metrics"].items()}
    assert set(READERS) <= set(metrics), sorted(metrics)
    tr = collected[0]
    assert not [e.name for e in tr.device if e.name.startswith("apnp.")]
    spans = program_spans.in_window(SimpleNamespace(trace=tr))
    solves = [s for s in spans if s.name == "apnp.solve"]
    iters = [s for s in spans if s.name == "apnp.admm.iter"]
    assert len(solves) == len(tr.requests_ns)
    solve_ms = sum(s.device_ms for s in solves) / len(solves)
    parts = (metrics["solve_self_ms"] + metrics["warmstart_ms"]
             + sum(s.device_ms for s in iters) / len(solves))
    assert parts == pytest.approx(solve_ms, rel=0.01)
    adapts = [s for s in spans if s.name == "apnp.adapt"]
    steps = sum(s.counters.get("apnp.adam_steps", 0) for s in solves)
    assert adapts and steps >= len(adapts)
    assert metrics["adapt_ms_per_step"] * steps == pytest.approx(
        metrics["adapt_ms_per_trigger"] * len(adapts))
    prior = [s.device_ms for s in spans if s.name == "apnp.prior"]
    assert sum(prior) / len(prior) == pytest.approx(metrics["prior_ms_per_call"], rel=0.02)
