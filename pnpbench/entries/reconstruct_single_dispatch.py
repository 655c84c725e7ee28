"""A request through ``solvers.end_to_end.reconstruct_single_dispatch``: the
GAP-TV warm start and the two-stage adaptive ADMM of one snapshot, with the
configuration's prior. The program takes the measurement on the host and
returns the reconstruction on the device (the harness brings it back to the
host); the masks stay on the device; no ground
truth is passed. Each request seeds its own adaptation-noise generator on
the device, and the reference draws from one seeded alike.

Compared: the reconstruction (``x_max_abs``, the largest absolute gap of a
pixel) and the adapted parameters (``dtheta_rel``: the norm of the gap
between the program's and the reference's change of the parameters, over
the norm of the reference's change, all parameters together).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

from pnpbench.reference import solver

NEEDS_MODEL = True


def _schedule(config: dict) -> solver.Schedule:
    s = config["schedule"]
    a = s["adapt"]
    return solver.Schedule(tuple(v / 255 for v in s["sigma_255"]), tuple(s["iters"]), s["rho"],
                           s["tau"], s["alpha"], a["lr"], a["update_per_iter"],
                           a["interval_iter"], a["initial_iter"])


def program(cell, model, params: dict, plan, device: torch.device, spans
            ) -> Callable[[Tensor, int], tuple[Tensor, dict]]:
    from adaptivepnp_sci_torch.adapt.online import AdaptConfig
    from adaptivepnp_sci_torch.solvers import end_to_end
    from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig
    from adaptivepnp_sci_torch.solvers.two_stage_admm import ADMMConfig

    cfg = cell.config
    s = cfg["schedule"]
    a = s["adapt"]
    admm = ADMMConfig(sigma=tuple(v / 255 for v in s["sigma_255"]), iters=tuple(s["iters"]),
                      denoiser=cfg["denoiser"], demosaic_method=s["demosaic"],
                      tv_weight=s["tv_weight"], tv_iters=s["tv_iters"],
                      adapt=AdaptConfig(lr=a["lr"], update_per_iter=a["update_per_iter"],
                                        interval_iter=a["interval_iter"],
                                        initial_iter=a["initial_iter"]))
    if (admm.rho, admm.tau, admm.alpha) != (s["rho"], s["tau"], s["alpha"]):
        raise ValueError(f"the program's ADMM constants {(admm.rho, admm.tau, admm.alpha)} are "
                         f"not the configuration's {(s['rho'], s['tau'], s['alpha'])}")
    warm = GapTVConfig(iters=s["warm_iters"], lam=1.0, gamma=s["gamma"],
                       tv_weight=s["tv_weight"], tv_iters=s["tv_iters"])
    prior = model.program_prior(cfg, params, device)
    if prior.adapt_noise_std != cfg["adapt_noise_std_255"] / 255 or \
            prior.loss_mode != cfg["adapt_loss"]:
        raise ValueError("the program's prior adapts otherwise than the configuration states")
    if spans is not None:
        prior = spans.wrap_prior(prior)
    masks = plan.masks

    def serve(y: Tensor, noise_seed: int) -> tuple[Tensor, dict]:
        g = torch.Generator(device=device).manual_seed(noise_seed)
        res = end_to_end.reconstruct_single_dispatch(y, masks, warm, admm, prior, params,
                                                     device=device, generator=g)
        return res.x_bayer, res.variables

    return serve


def stated_precision(cell) -> str:
    return cell.config["precision"]


def control_precision(cell) -> str:
    return cell.config["control"]


def reference(cell, model, params: dict, masks: Tensor, y: Tensor, noise_seed: int,
              device: torch.device, precision: str) -> dict:
    cfg = cell.config
    g = torch.Generator(device=device).manual_seed(noise_seed)
    rec = solver.reconstruct(y.to(device), masks, cfg["schedule"]["warm_iters"],
                             _schedule(cfg), model.reference_denoiser(cfg, precision), params,
                             model.trainable(params), cfg["adapt_loss"],
                             cfg["adapt_noise_std_255"] / 255, g)
    return {"x": rec.x_bayer.cpu(), "params": {k: v.cpu() for k, v in rec.params.items()},
            "tv_iterations": rec.tv_iterations}


def numbers(cell, model, params: dict, x: Tensor, variables: dict | None, ref: dict
            ) -> dict[str, float]:
    out = {"x_max_abs": float((x.double() - ref["x"].double()).abs().max()),
           "x_rms": float(((x.double() - ref["x"].double()) ** 2).mean().sqrt())}
    keys = model.trainable(params)
    start = {k: params[k].detach().cpu().double() for k in keys}
    d_ref = torch.cat([(ref["params"][k].double() - start[k]).flatten() for k in keys])
    d_prog = torch.cat([(variables[k].detach().cpu().double() - start[k]).flatten()
                        for k in keys])
    out["dtheta_rel"] = float((d_prog - d_ref).norm() / d_ref.norm().clamp_min(1e-300))
    # by leaf, for the readings that set the limits
    leaf = []
    for k in keys:
        r = ref["params"][k].double() - start[k]
        g = variables[k].detach().cpu().double() - start[k]
        if r.norm() > 0:
            leaf.append(float((g - r).norm() / r.norm()))
    leaf.sort()
    out["dtheta_leaf_max"] = leaf[-1] if leaf else 0.0
    out["dtheta_leaf_median"] = leaf[len(leaf) // 2] if leaf else 0.0
    return out
