"""Run one cell of the benchmark of ``adaptivepnp_sci_torch`` on the card.

    python3 pnpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m pnpbench.run ...``) from the root of a checkout. Prints the
result as the last line of standard output (one JSON object), and each
number of the comparison with the plain reference beside its limit as the
last lines of standard error. Exits non-zero, printing no result, without a
CUDA device, with fewer devices than the cell asks for, or when a JAX module
was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
#: compile caches at fixed places inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "pnpbench" / ".cache" / "triton")
#: host threads of the one process
HOST_THREADS = 4


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from pnpbench import harness

    if not torch.cuda.is_available():
        print("pnpbench: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"pnpbench: {cell.name} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(HOST_THREADS)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      T_PROCESS)
    if out.forbidden:
        print(f"pnpbench: the run loaded {', '.join(out.forbidden)}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(out.result), flush=True)
    for line in out.checks:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
