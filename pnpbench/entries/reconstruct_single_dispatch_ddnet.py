"""A request through ``solvers.end_to_end.reconstruct_single_dispatch`` with
the configuration's deep demosaicker as its ``demosaic_fn``: the GAP-TV warm
start and the two-stage adaptive ADMM of one snapshot, the demosaicker
(fixed weights) in every iteration, the prior adapting online. The
reference runs the same with its own demosaicker in the loop of
``reference/solver_demosaic.py``. Everything else is
:mod:`pnpbench.entries.reconstruct_single_dispatch`'s.

Compared: that entry's numbers, and two of the demosaicker's own. The
reconstruction alone cannot hold the demosaicker: the ADMM duals take up its
error.

* ``demosaic_rms``: the rms gap between the demosaicker's last output in the
  solve and the reference demosaicker (in the configuration's precision) on
  the same input. The request hands back, beside the adapted parameters, the
  input and output of its last demosaic (references to tensors the solve
  made, nothing recomputed on the timed path), and the reference does the
  same.
* ``ddnet_probe_rel``: the demosaicker built as the solve's, with the model's
  probe weights (``probe_params``, seeded random) in place of the trained
  ones, on the cell's masks as Bayer frames, against the reference
  demosaicker on the same weights and input: rms gap over the reference's
  rms. The program makes it once, at set-up. The trained weights leave
  DDnet's second branch near silent, so only this number sees that branch.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

from pnpbench.entries import reconstruct_single_dispatch as bayer_entry
from pnpbench.entries.reconstruct_single_dispatch import (_schedule, control_precision,
                                                          stated_precision)
from pnpbench.reference import solver_demosaic

NEEDS_MODEL = True
#: the keys of the last demosaic's input and output beside the parameters
LAST_IN, LAST_OUT = "last_demosaic.input", "last_demosaic.output"
#: the key of the demosaicker's output on the probe weights
PROBE = "ddnet_probe.output"
__all__ = ["NEEDS_MODEL", "program", "reference", "numbers", "stated_precision",
           "control_precision"]


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
    if admm.select_best or cfg["demosaicker"]["update"]:
        raise ValueError("the cell runs without the held-out guard and with fixed demosaicker "
                         "weights")
    warm = GapTVConfig(iters=s["warm_iters"], lam=1.0, gamma=s["gamma"],
                       tv_weight=s["tv_weight"], tv_iters=s["tv_iters"])
    prior = model.program_prior(cfg, params, device)
    if prior.adapt_noise_std != cfg["adapt_noise_std_255"] / 255 or \
            prior.loss_mode != cfg["adapt_loss"]:
        raise ValueError("the program's prior adapts otherwise than the configuration states")
    if spans is not None:
        prior = spans.wrap_prior(prior)
    demosaic_fn, last = _keeping_last(model.program_demosaicker(cfg, params, device))
    prior_params = model.prior_params(params)
    masks = plan.masks
    probe = {PROBE: model.program_demosaicker(cfg, model.probe_params(params), device)(
        masks.float()).cpu()}

    def serve(y: Tensor, noise_seed: int) -> tuple[Tensor, dict]:
        g = torch.Generator(device=device).manual_seed(noise_seed)
        res = end_to_end.reconstruct_single_dispatch(y, masks, warm, admm, prior, prior_params,
                                                     device=device, generator=g,
                                                     demosaic_fn=demosaic_fn)
        return res.x_bayer, {**res.variables, **last, **probe}

    return serve


def reference(cell, model, params: dict, masks: Tensor, y: Tensor, noise_seed: int,
              device: torch.device, precision: str) -> dict:
    cfg = cell.config
    g = torch.Generator(device=device).manual_seed(noise_seed)
    prior_params = model.prior_params(params)
    demosaic, last = _keeping_last(model.reference_demosaicker(cfg, params, precision))
    with torch.no_grad():
        probe = model.reference_demosaicker(cfg, model.probe_params(params), precision)(
            masks.float())
    rec = solver_demosaic.reconstruct(
        y.to(device), masks, cfg["schedule"]["warm_iters"], _schedule(cfg),
        model.reference_denoiser(cfg, precision), demosaic, prior_params,
        model.trainable(params), cfg["adapt_loss"], cfg["adapt_noise_std_255"] / 255, g)
    return {"x": rec.x_bayer.cpu(),
            "params": {k: v.cpu() for k, v in {**rec.params, **last, PROBE: probe}.items()},
            "tv_iterations": rec.tv_iterations}


def _keeping_last(demosaic: Callable[[Tensor], Tensor]
                  ) -> tuple[Callable[[Tensor], Tensor], dict[str, Tensor]]:
    """``demosaic``, and the dict in which it leaves its last input and
    output."""
    last: dict[str, Tensor] = {}

    def keeping(mosaic: Tensor) -> Tensor:
        out = demosaic(mosaic)
        last.update({LAST_IN: mosaic, LAST_OUT: out})
        return out

    return keeping, last


def numbers(cell, model, params: dict, x: Tensor, variables: dict | None, ref: dict
            ) -> dict[str, float]:
    out = bayer_entry.numbers(cell, model, params, x, variables, ref)
    device = next(iter(model.demosaicker_params(params).values())).device
    with torch.no_grad():
        want = model.reference_demosaicker(cell.config, params, stated_precision(cell))(
            variables[LAST_IN].to(device)).cpu()
    out["demosaic_rms"] = _rms(variables[LAST_OUT].double() - want.double())
    got, ref_probe = variables[PROBE].double(), ref["params"][PROBE].double()
    out["ddnet_probe_rel"] = _rms(got - ref_probe) / max(_rms(ref_probe), 1e-300)
    return out


def _rms(t: Tensor) -> float:
    return float((t ** 2).mean().sqrt())
