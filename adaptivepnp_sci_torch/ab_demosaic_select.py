"""Ground-truth-free demosaicker selection (Malvar against DDnet), against
the oracle (port of ``scripts/ab_demosaic_select.py``).

DDnet wins on dead-leaves statistics and loses on the photograph scene: the
better demosaicker depends on the scene. The rule under test
(``pipelines.probe_demosaic_residuals``, behind
``pipelines.select_demosaicker`` and ``reconstruct --auto-demosaic``): 5 %
of the snapshot's pixels leave the data term, both demosaicker paths solve
their scene's full fixed-weight schedule, and the one that better predicts
the held-out measurements wins.

Per scene stand-in: both held-out residuals, both full-schedule PSNRs with
fixed weights (the oracle), and whether the picks agree. FFDNet-color
(``--ffdnet``), DDnet in bf16 from ``weights/ddnet.npz``, 512^2x8.

Usage: python -m adaptivepnp_sci_torch.ab_demosaic_select --ffdnet PATH [h]
       [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from adaptivepnp_sci_torch import studies

#: scene -> (stand-in style, seed)
SCENES = {
    "Beauty": ("photo", 101),
    "Bosphorus": ("textured", 202),
    "Jockey": ("leaves", 303),
    "Runner": ("photo", 404),
    "ShakeNDry": ("leaves", 505),
    "Traffic": ("textured", 606),
}


def demosaic_row(scene: Any, prior, params: dict, dd: torch.nn.Module, dd_params: dict,
                 config_malvar, config_ddnet, device: torch.device | str
                 ) -> tuple[float, float, str, float, float, str, tuple[Any, Any]]:
    """``(resid malvar, resid ddnet, pick, PSNR malvar, PSNR ddnet, oracle,
    (result malvar, result ddnet))`` from the scene's GAP-TV warm start; ``config_ddnet`` is the
    DDnet row's schedule (its ``demosaic_method`` is set here)."""
    from adaptivepnp_sci_torch.pipelines import probe_demosaic_residuals
    from adaptivepnp_sci_torch.solvers.gap_tv import gap_tv
    from adaptivepnp_sci_torch.solvers.priors import ddnet_demosaic
    from adaptivepnp_sci_torch.solvers.two_stage_admm import two_stage_admm

    y, phi, orig = studies.on_device(scene, device)
    x0 = gap_tv(y, phi, studies.WARM, device=device).x_bayer
    r_m, r_d = probe_demosaic_residuals(y, phi, x0, prior, params, dd, dd_params,
                                        config_malvar, config_ddnet, device=device)
    pick = "malvar" if r_m <= r_d else "ddnet"
    # the oracle: the full schedules, fixed weights
    full_m = two_stage_admm(y, phi, config_malvar, prior, params, x0, orig, device)
    full_d = two_stage_admm(y, phi, dataclasses.replace(config_ddnet, demosaic_method="ddnet"),
                            prior, params, x0, orig, device,
                            demosaic_fn=ddnet_demosaic(dd, dd_params))
    p_m, p_d = float(full_m.psnr_per_frame.mean()), float(full_d.psnr_per_frame.mean())
    return r_m, r_d, pick, p_m, p_d, "malvar" if p_m >= p_d else "ddnet", (full_m, full_d)


def main(ffdnet: str | dict, h: int = 512, device: torch.device | str = "cuda", model=None,
         cut: int | None = None, weights: str = str(studies.REPO_WEIGHTS / "ddnet.npz"),
         scenes=tuple(SCENES)) -> list[tuple]:
    """Print the table; returns ``(scene, style, resid malvar, resid ddnet,
    pick, PSNR malvar, PSNR ddnet, oracle, agree, results)`` per scene. ``cut``
    shortens every stage of both rows' schedules to at most that many
    iterations."""
    from adaptivepnp_sci_torch.configs.scenes import FFDNET_SCENES
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.ddnet import DDnet
    from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color
    from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior
    from adaptivepnp_sci_torch.solvers.two_stage_admm import ADMMConfig
    from adaptivepnp_sci_torch.train.trainer import load_checkpoint_variables

    prior = ffdnet_prior(ffdnet_color() if model is None else model)
    params = studies.load_ffdnet_weights(ffdnet)
    dd = DDnet(dtype=torch.bfloat16)
    dd_params = load_checkpoint_variables(weights)
    print("| scene | stand-in | probe resid malvar | probe resid ddnet | "
          "pick | full malvar dB | full ddnet dB | oracle pick | agree |")
    print("|---|---|---|---|---|---|---|---|---|")
    rows, agree_all = [], True
    for name in scenes:
        style, seed = SCENES[name]
        scene = make_scene(b=8, h=h, w=h, seed=seed, style=style)
        row, row_dd = FFDNET_SCENES[name][False], FFDNET_SCENES[name][True]
        cm = ADMMConfig(sigma=row.sigma, iters=studies.cut_iters(row.iters, cut),
                        denoiser="ffdnet")
        cd = ADMMConfig(sigma=row_dd.sigma, iters=studies.cut_iters(row_dd.iters, cut),
                        denoiser="ffdnet")
        r_m, r_d, pick, p_m, p_d, oracle, fulls = demosaic_row(scene, prior, params, dd, dd_params,
                                                         cm, cd, device)
        agree = pick == oracle
        agree_all &= agree
        print(f"| {name} | {style} | {r_m:.3e} | {r_d:.3e} | {pick} | {p_m:.2f} | {p_d:.2f} "
              f"| {oracle} | {'YES' if agree else 'NO'} |", flush=True)
        rows.append((name, style, r_m, r_d, pick, p_m, p_d, oracle, agree, fulls))
    print(f"\nresidual pick == oracle pick on all scenes: {agree_all}")
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__, ffdnet=True)
    ap.add_argument("h", nargs="?", type=int, default=512)
    args = ap.parse_args()
    main(args.ffdnet, args.h, _check_device(args.device))
