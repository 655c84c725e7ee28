"""A request through ``solvers.gap_tv.gap_tv``: the GAP-TV warm start alone
(stage 1 of the reconstruction, as ``cli warmstart`` runs it), the
measurement handed over on the host, the result returned on the device (the
harness brings it back to the host), the masks on the device.

Compared: the reconstruction, ``x_max_abs`` (the largest absolute gap of a
pixel). The configuration's float32 warm start has the bf16 warm start for
its control.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

from pnpbench.reference import solver

NEEDS_MODEL = False


def program(cell, model, params, plan, device: torch.device, spans
            ) -> Callable[[Tensor, int], tuple[Tensor, None]]:
    from adaptivepnp_sci_torch.solvers import gap_tv

    s = cell.config["schedule"]
    cfg = gap_tv.GapTVConfig(iters=s["warm_iters"], lam=1.0, gamma=s["gamma"],
                             tv_weight=s["tv_weight"], tv_iters=s["tv_iters"])
    masks = plan.masks

    def serve(y: Tensor, noise_seed: int) -> tuple[Tensor, None]:
        del noise_seed  # nothing is drawn
        return gap_tv.gap_tv(y, masks, cfg, device=device).x_bayer, None

    return serve


def stated_precision(cell) -> str:
    return "float32"


def control_precision(cell) -> str:
    return "bfloat16"


def reference(cell, model, params, masks: Tensor, y: Tensor, noise_seed: int,
              device: torch.device, precision: str) -> dict:
    s = cell.config["schedule"]
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]
    warm = solver.gap_tv(y.to(device), masks, s["warm_iters"], s["tv_weight"], s["tv_iters"],
                         s["gamma"], dtype)
    return {"x": solver.unpack(warm.x_p).cpu(), "tv_iterations": warm.tv_iterations}


def numbers(cell, model, params, x: Tensor, variables, ref: dict) -> dict[str, float]:
    d = x.double() - ref["x"].double()
    return {"x_max_abs": float(d.abs().max()), "x_rms": float((d ** 2).mean().sqrt())}
