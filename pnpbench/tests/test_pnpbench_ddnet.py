"""The deep-demosaicking cell ``fastdvdnet_ddnet.ddnet512``: on the CPU at
32x32x8 with a cut schedule, a sound run is correct and each fault that
reaches the cell (``faults.ADAPTIVE``, ``faults_ddnet.DDNET``) is not (the
DDnet faults by the demosaicker's probe alone), the
reference loads nothing of the program, DDnet's operation count is the
convolutions a forward runs, and the readers of its spans and counters; on
the card at 256^2 with the cell's schedule, the control and the faults fail
the cell's limits and a traced run of the program passes them and reads the
DDnet metrics."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from pnpbench import control, faults, faults_ddnet, harness
from pnpbench.counts import ddnet as ddnet_counts
from pnpbench.metrics import (ddnet_mfu_pct, ddnet_ms_per_call, ddnet_row_mfu_pct,
                              snapshot_mfu_pct)

ROOT = Path(__file__).resolve().parents[2]
NAME = "fastdvdnet_ddnet.ddnet512"
SMALL = {"height": 32, "width": 32, "pool": 2, "warmup": 1, "check_requests": 2,
         "check_among_first": 2}
SCHEDULE = {"iters": [4, 2], "adapt": {"interval_iter": 2}, "warm_iters": 5}
#: the limits at this size. The program's one-ulp bf16 roundings carried
#: through 6 iterations read x_rms 1.4e-3 to 1.6e-3 on four seeds, and
#: Adam's first step (lr * sign(g)) flips the weights whose gradients are
#: near zero: the median leaf's gap read 0.18 to 0.27, the gradients summed
#: over 256x fewer pixels than at 512^2. The fp8 control read x_rms 0.022 to
#: 0.024 and the leaf median 0.74 to 0.79 here. The last demosaic's gap to
#: the bf16 reference on the same input read 3.2e-4 to 4.2e-4 on three
#: seeds (the CPU's bf16 convolutions round more than the card's), the fp8
#: control 0.0157, DDnet without its neighbour frames 0.033 to 0.034. The
#: demosaicker on the probe weights read 4.5e-3 to 4.7e-3 of the reference's
#: rms on four seeds, the fp8 control 0.086 to 0.087, DDnet without its
#: neighbours 0.169, on half the windows 0.709, without its second branch
#: 0.667 (whose last demosaic read 9.0e-4, under that limit).
SMALL_LIMITS = {"x_rms": 6e-3, "dtheta_leaf_median": 0.45, "demosaic_rms": 2e-3,
                "ddnet_probe_rel": 0.02}


def small_cell() -> harness.Cell:
    cell = harness.load_cell(NAME, {"traffic": SMALL, "config": {"schedule": SCHEDULE}})
    return dataclasses.replace(cell, limits=SMALL_LIMITS)


def run_small(seed: int = 11) -> harness.Outcome:
    return harness.run(small_cell(), seed, 0.05, False, "cpu", 0.0, log=open(os.devnull, "w"))


def test_sound_run_is_correct_and_the_control_is_not():
    out = run_small(2 ** 31 + 11)
    assert out.result["correct"] and out.result["failed"] == 0, out.checks
    assert out.forbidden == []
    got = control.control_numbers(small_cell(), 2 ** 31 + 11, torch.device("cpu"))
    assert all(got[k] > lim for k, lim in SMALL_LIMITS.items()), got


FAULTS = [*faults.ADAPTIVE, *faults_ddnet.DDNET]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch.setattr)
    out = run_small()
    assert not out.result["correct"]
    if fault in faults_ddnet.DDNET:  # the demosaicker's probe sees it by itself
        assert out.numbers["ddnet_probe_rel"] > SMALL_LIMITS["ddnet_probe_rel"], out.numbers


def test_reference_loads_nothing_of_the_program():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); "
            "import pnpbench.reference.ddnet, pnpbench.reference.solver_demosaic; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not names & (set(harness.FORBIDDEN) | {"adaptivepnp_sci_torch"}), sorted(names)


@pytest.mark.parametrize("n,h,w", [(2, 16, 24), (1, 32, 32)])
def test_count_is_the_convolutions_a_forward_runs(n, h, w):
    from adaptivepnp_sci_torch.models.ddnet import DDnet

    net = DDnet().eval()
    flops = []

    def hook(conv, inputs, out):
        flops.append(2 * 9 * conv.in_channels // conv.groups * out.numel())

    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net(torch.rand(n, 5, h, w, 3))
    assert sum(flops) == ddnet_counts.flops_per_call(n, h, w)
    assert ddnet_counts.parameters() == sum(p.numel() for p in net.parameters())
    assert ddnet_counts.bytes_per_call(n, h, w) == 4 * (
        n * 6 * h * w * 3 + sum(p.numel() for p in net.parameters()))


def span(index, name, parent, ms, request=0, **counters):
    return SimpleNamespace(index=index, name=name, parent=parent, request=request, start_ns=110,
                           end_ns=190, device_ms=ms, counters=counters)


def test_readers_of_the_ddnet_spans(monkeypatch):
    from adaptivepnp_sci_torch.utils import profiling

    counters = {"apnp.ddnet_windows": 16, "apnp.adam_steps": 2}
    spans = [span(0, "apnp.solve", -1, 100.0, **counters),
             span(1, "apnp.admm.iter", 0, 40.0), span(2, "apnp.demosaic", 1, 25.0),
             span(3, "apnp.ddnet", 2, 20.0), span(4, "apnp.prior", 1, 10.0),
             span(5, "apnp.admm.iter", 0, 40.0), span(6, "apnp.demosaic", 5, 35.0),
             span(7, "apnp.ddnet", 6, 30.0), span(8, "apnp.prior", 5, 10.0)]
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    monkeypatch.setattr(profiling, "dropped", lambda: 0)
    cell = harness.load_cell(NAME)
    model = harness.load_module("models", cell.config["model"])
    peaks = harness.load_json(harness.PKG / "peaks.json")
    ctx = SimpleNamespace(trace=SimpleNamespace(requests_ns=[(100, 200)], window_s=0.5),
                          cell=cell, model=model, peaks=peaks, window_s=4.0,
                          spans=SimpleNamespace(apply_calls=5, adapt_calls=4))
    assert ddnet_ms_per_call.read(ctx) == 25.0
    per_window = ddnet_counts.flops_per_window(512, 512)
    bf16 = peaks["bf16_flops_per_s"]
    assert ddnet_mfu_pct.read(ctx) == pytest.approx(100 * per_window / (50e-3 / 16 * bf16))
    f = model.flops_per_call(cell.config, 8, 512, 512)
    # the window's 5 prior calls, 8 DDnet windows each as in the traced requests
    assert snapshot_mfu_pct.read(ctx) == pytest.approx(100 * (5 * f + 3 * 4 * f) / (4.0 * bf16))
    assert ddnet_row_mfu_pct.read(ctx) == pytest.approx(
        100 * (5 * f + 3 * 4 * f + 5 * 8 * per_window) / (4.0 * bf16))
    # a program without the counter (the parent of the spans' change)
    del spans[0].counters["apnp.ddnet_windows"]
    spans[:] = [s for s in spans if s.name != "apnp.ddnet"]
    assert all(r.read(ctx) is None for r in (ddnet_ms_per_call, ddnet_mfu_pct,
                                              ddnet_row_mfu_pct))
    assert ddnet_row_mfu_pct.read(SimpleNamespace(trace=None, model=model, spans=None)) is None


# ------------------------------------------------------------- the card

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202)


def card_cell() -> harness.Cell:
    return harness.load_cell(NAME, {"traffic": {"height": 256, "width": 256, "pool": 2,
                                                "warmup": 1, "check_requests": 2,
                                                "check_among_first": 2}})


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_a_limit(seed, cuda_device):
    cell = card_cell()
    got = control.control_numbers(cell, seed, cuda_device)
    assert any(got[k] > lim for k, lim in cell.limits.items()), got


@pytest.mark.cuda
def test_traced_program_passes_the_limits_and_reads_ddnet(cuda_device):
    out = harness.run(card_cell(), SEEDS[0], 1.0, True, cuda_device, 0.0)
    assert out.result["correct"] and out.forbidden == [], out.checks
    metrics = out.result["metrics"]
    assert {"ddnet_ms_per_call", "ddnet_mfu_pct", "ddnet_row_mfu_pct", "k1_roofline_pct",
            "k2_roofline_pct", "k3_roofline_pct", "device_idle_pct", "prior_ms_per_call",
            "warmstart_ms", "solve_self_ms", "admm_self_ms_per_iter", "demosaic_ms_per_call",
            "adapt_ms_per_trigger", "adapt_ms_per_step"} <= set(metrics), sorted(metrics)
    assert 0 < metrics["ddnet_mfu_pct"]["value"] < 100
    assert 0 < metrics["ddnet_row_mfu_pct"]["value"] < 100


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_fails_a_limit(fault, cuda_device, monkeypatch):
    fault(monkeypatch.setattr)
    cell = card_cell()
    out = harness.run(cell, SEEDS[1], 1.0, False, cuda_device, 0.0, log=open(os.devnull, "w"))
    assert not out.result["correct"], out.checks
    if fault in faults_ddnet.DDNET:
        assert out.numbers["ddnet_probe_rel"] > cell.limits["ddnet_probe_rel"], out.checks
