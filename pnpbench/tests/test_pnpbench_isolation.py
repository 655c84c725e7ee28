"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the measured program. Checked in fresh
processes by the top-level name of every module in ``sys.modules``, each
compared whole (the port's name begins with the JAX package's)."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "adaptivepnp_sci_tpu"}

HARNESS = """
import sys, json
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from pathlib import Path
from pnpbench import control, harness, run, trace, traffic, weights
import pnpbench.reference.solver, pnpbench.reference.ffdnet, pnpbench.reference.fastdvdnet
for kind in ("entries", "models", "metrics", "counts"):
    for f in sorted((Path({root!r}) / "pnpbench" / kind).glob("*.py")):
        if f.stem != "__init__":
            harness.load_module(kind, f.stem)
small = {{"height": 16, "width": 16, "pool": 1, "warmup": 1, "check_requests": 1,
         "check_among_first": 1}}
for name in ("ffdnet_color.adaptive512", "fastdvdnet_bf16.adaptive512",
             "ffdnet_color.warmstart2048"):
    cell = harness.load_cell(name, {{"traffic": small, "config": {{"schedule": {{
        "iters": [2, 1, 1][:len(harness.load_cell(name).config["schedule"]["iters"])],
        "adapt": {{"interval_iter": 2}}, "warm_iters": 2}}}}}})
    out = harness.run(cell, 3, 0.01, False, "cpu", 0.0, log=open("/dev/null", "w"))
    assert out.result["correct"] is not None
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import sys, json
sys.path.insert(0, {root!r})
import pnpbench.reference, pnpbench.reference.solver, pnpbench.reference.ffdnet
import pnpbench.reference.fastdvdnet, pnpbench.reference.precision
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_names(code: str) -> set:
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_no_jax():
    names = top_level_names(HARNESS)
    assert "adaptivepnp_sci_torch" in names  # the run did reach the program
    assert not names & FORBIDDEN, sorted(names & FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = top_level_names(REFERENCE)
    assert "torch" in names
    assert not names & (FORBIDDEN | {"adaptivepnp_sci_torch"}), sorted(names)
