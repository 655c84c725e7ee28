"""On the card: the control (the plain reference in the nearest precision
below the configuration's, put in the program's place) fails a limit of
each cell, each fault of ``faults.py`` the cell can have fails one too, and
a sound run of the program passes them, at a size a test run holds (256^2
for the adaptive cells, 1024^2 for the warm start: 512^2 planes, the TV
kernel's block design as at full size), with the cells' schedules as they
are."""

import os

import pytest

from pnpbench import control, faults, harness

SIZES = {"ffdnet_color.adaptive512": 256, "fastdvdnet_bf16.adaptive512": 256,
         "ffdnet_color.warmstart2048": 1024}
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202)


def cell_at(name: str) -> harness.Cell:
    size = SIZES[name]
    return harness.load_cell(name, {"traffic": {"height": size, "width": size, "pool": 2,
                                                "warmup": 1, "check_requests": 2,
                                                "check_among_first": 2}})


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SIZES))
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_a_limit(name, seed, cuda_device):
    cell = cell_at(name)
    got = control.control_numbers(cell, seed, cuda_device)
    assert any(got[k] > lim for k, lim in cell.limits.items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SIZES))
def test_program_passes_the_limits(name, cuda_device):
    out = harness.run(cell_at(name), SEEDS[0], 1.0, True, cuda_device, 0.0)
    assert out.result["correct"], out.checks
    assert out.forbidden == []


FAULTS = ([(n, f) for n in ("ffdnet_color.adaptive512", "fastdvdnet_bf16.adaptive512")
           for f in faults.ADAPTIVE]
          + [("ffdnet_color.warmstart2048", f) for f in faults.WARM_START])


@pytest.mark.cuda
@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_fault_fails_a_limit(name, fault, cuda_device, monkeypatch):
    fault(monkeypatch.setattr)
    out = harness.run(cell_at(name), SEEDS[1], 1.0, False, cuda_device, 0.0,
                      log=open(os.devnull, "w"))
    assert not out.result["correct"], out.checks
