"""A run of each cell on the CPU at a small size, past the harness's look for
a card, with the program broken underneath (``pnpbench/faults.py``):
``correct`` has to come out false for each fault the cell can have, and
true without one."""

import pytest

from pnpbench import faults, harness

SMALL = {"height": 32, "width": 32, "pool": 2, "warmup": 1, "check_requests": 2,
         "check_among_first": 2}
SCHEDULES = {
    "ffdnet_color.adaptive512": {"iters": [3, 2, 1], "adapt": {"interval_iter": 2},
                                 "warm_iters": 5},
    "fastdvdnet_bf16.adaptive512": {"iters": [4, 2], "adapt": {"interval_iter": 2},
                                    "warm_iters": 5},
    "ffdnet_color.warmstart2048": {"warm_iters": 6},
}


def correct(name: str, seed: int = 11) -> bool:
    cell = harness.load_cell(name, {"traffic": SMALL, "config": {"schedule": SCHEDULES[name]}})
    out = harness.run(cell, seed, 0.05, False, "cpu", 0.0, log=open("/dev/null", "w"))
    return out.result["correct"]


CASES = ([(n, f) for n in ("ffdnet_color.adaptive512", "fastdvdnet_bf16.adaptive512")
          for f in faults.ADAPTIVE]
         + [("ffdnet_color.warmstart2048", f) for f in faults.WARM_START])


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_sound_run_is_correct(name):
    assert correct(name)


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{n}-{f.__name__}" for n, f in CASES])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch.setattr)
    assert not correct(name)
