"""Readings that set the limits of the comparison with the reference, on the
card at the cell's own size (not run by the benchmark's runs).

    python3 -m pnpbench.control --workload <cell> --program-seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 5 [--out readings.jsonl]

For each program seed, a whole run of the cell (a short window) in this
process, and every number the cell's entry computes between the program and
the reference: the lower readings. For each control seed, the same requests
recomputed by the reference in the configuration's precision and by the
reference in the nearest precision below it (the control, put in the
program's place): the upper readings. ``--faults`` runs the cell with each
named fault of ``faults.py`` planted, on the fault seeds; ``--witness``
reads, on the fault seeds, the reference against itself with each
measurement moved by one float32 ulp, and the program with its conv pairs on
the library in place of K3. One JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Callable

import torch

from pnpbench import faults, harness
from pnpbench import traffic as traffic_mod


def _against_reference(cell: harness.Cell, seed: int, device: torch.device,
                       other: Callable[..., dict]) -> dict:
    """Every number of the entry between ``other(entry, args)`` and the
    reference in the configuration's precision, the worst over the requests
    a run of ``seed`` checks; ``args`` are the reference's arguments but
    its precision."""
    entry = harness.load_module("entries", cell.traffic["entry"])
    model = harness.load_module("models", cell.config["model"]) if entry.NEEDS_MODEL else None
    plan = traffic_mod.make(cell.traffic, seed, device)
    params = model.weights(cell.config, seed, device) if model is not None else None
    out: dict[str, float] = {}
    for i in plan.sample:
        y = plan.measurements[int(plan.order[i % len(plan.measurements)])]
        args = (cell, model, params, plan.masks, y, traffic_mod.noise_seed(seed, i), device)
        ref = entry.reference(*args, entry.stated_precision(cell))
        got = other(entry, args)
        for k, v in entry.numbers(cell, model, params, got["x"], got.get("params"), ref).items():
            out[k] = max(out.get(k, v), v)
    return out


def control_numbers(cell: harness.Cell, seed: int, device: torch.device) -> dict:
    """The control (the reference a precision lower) against the reference."""
    return _against_reference(cell, seed, device,
                              lambda e, a: e.reference(*a, e.control_precision(cell)))


def perturbed_numbers(cell: harness.Cell, seed: int, device: torch.device) -> dict:
    """The reference against itself with every checked measurement moved by
    one float32 ulp (relative 2^-23): how far rounding alone carries the
    solve."""

    def moved(e, a):
        return e.reference(*a[:4], a[4] * (1 + 2.0 ** -23), *a[5:], e.stated_precision(cell))

    return _against_reference(cell, seed, device, moved)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--faults", default="", help="comma-separated names in faults.py")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cell = harness.load_cell(args.workload)
    sink = open(args.out, "a") if args.out else None

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    try:
        for s in filter(None, args.program_seeds.split(",")):
            t = time.perf_counter()
            out = harness.run(cell, int(s), args.seconds, False, device, t)
            emit({"cell": cell.name, "kind": "program", "seed": int(s),
                  "correct": out.result["correct"], "numbers": out.numbers,
                  "metrics": {k: v["value"] for k, v in out.result["metrics"].items()},
                  "s": time.perf_counter() - t})
        for s in filter(None, args.control_seeds.split(",")):
            t = time.perf_counter()
            emit({"cell": cell.name, "kind": "control", "seed": int(s),
                  "numbers": control_numbers(cell, int(s), device),
                  "s": time.perf_counter() - t})
        fault_seeds = [int(s) for s in filter(None, args.fault_seeds.split(","))]
        for name in filter(None, args.faults.split(",")):
            for s in fault_seeds:
                with faults.Patches() as patch:
                    faults.BY_NAME[name](patch)
                    out = harness.run(cell, s, args.seconds, False, device, time.perf_counter())
                emit({"cell": cell.name, "kind": "fault", "fault": name, "seed": s,
                      "correct": out.result["correct"], "numbers": out.numbers})
        if args.witness:
            for s in fault_seeds:
                emit({"cell": cell.name, "kind": "witness_moved_ulp", "seed": s,
                      "numbers": perturbed_numbers(cell, s, device)})
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main())
