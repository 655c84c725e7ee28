"""Ground-truth-free FastDVDnet weight-variant selection, against the oracle
(port of ``scripts/ab_weight_select.py``).

The shipped FastDVDnet checkpoints split by regime: ``weights/fastdvd.npz``
(distilled from FFDNet iterates, better on natural statistics) and
``weights/fastdvd_smooth.npz`` (smooth procedural training). The rule
under test (``pipelines.holdout_cv_residuals``, behind
``pipelines.select_prior_variables`` and ``reconstruct --ckpt auto``): 5 %
of the snapshot's pixels leave the data term, each variant solves the
scene's fixed-weight schedule, and the one that better predicts the
held-out measurements wins.

Per scene style (with a smooth synthetic scene): each variant's held-out
residual, each variant's full-schedule PSNR with the guard on (the oracle),
and whether the pick agrees (up to guard ties: a variant within 0.01 dB of
the best agrees). bf16 DenBlocks without recomputation, 512^2x8.

Usage: python -m adaptivepnp_sci_torch.ab_weight_select [h] [--device cuda|cpu]
"""

from __future__ import annotations

from typing import Any

import torch

from adaptivepnp_sci_torch import studies

#: style -> (scene whose schedule is used, seed); the smooth row takes the
#: old Beauty schedule
STYLES = {
    "smooth": ("Beauty", 42),
    "textured": ("Bosphorus", 202),
    "leaves": ("Jockey", 303),
    "photo": ("Runner", 404),
}
WEIGHTS = ("natural", "smooth")
WEIGHT_FILES = {"natural": "fastdvd.npz", "smooth": "fastdvd_smooth.npz"}


def select_row(scene: Any, prior, variants: dict[str, dict], config,
               device: torch.device | str
               ) -> tuple[list[float], str, list[float], str, bool, list[Any]]:
    """``(residuals, pick, PSNRs, oracle, agree, results)`` over
    :data:`WEIGHTS`: the held-out residuals (``config`` stripped of its
    guard and adaptation) and the guarded full solves, from the scene's
    GAP-TV warm start."""
    from adaptivepnp_sci_torch.pipelines import holdout_cv_residuals
    from adaptivepnp_sci_torch.solvers.gap_tv import gap_tv
    from adaptivepnp_sci_torch.solvers.two_stage_admm import two_stage_admm

    y, phi, orig = studies.on_device(scene, device)
    x0 = gap_tv(y, phi, studies.WARM, device=device).x_bayer
    resids = holdout_cv_residuals(
        y, phi, x0, [dict(config=config, prior=prior, variables=variants[k]) for k in WEIGHTS],
        device=device)
    pick = WEIGHTS[0] if resids[0] <= resids[1] else WEIGHTS[1]
    fulls = [two_stage_admm(y, phi, config, prior, variants[k], x0, orig, device)
             for k in WEIGHTS]
    psnrs = [float(r.psnr_per_frame.mean()) for r in fulls]
    oracle = WEIGHTS[0] if psnrs[0] >= psnrs[1] else WEIGHTS[1]
    agree = psnrs[WEIGHTS.index(pick)] >= max(psnrs) - 0.01
    return resids, pick, psnrs, oracle, agree, fulls


def main(h: int = 512, device: torch.device | str = "cuda", cut: int | None = None,
         weights_dir: str = str(studies.REPO_WEIGHTS), styles=tuple(STYLES)) -> list[tuple]:
    """Print the table; returns ``(style, schedule, residuals, pick, PSNRs,
    oracle, agree, results)`` per style. ``cut`` shortens every stage of the rows'
    schedules to at most that many iterations."""
    from adaptivepnp_sci_torch.configs.scenes import FASTDVD_SCENES
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior
    from adaptivepnp_sci_torch.solvers.two_stage_admm import ADMMConfig
    from adaptivepnp_sci_torch.train.trainer import load_checkpoint_variables

    prior = fastdvd_prior(FastDVDnet(dtype=torch.bfloat16, remat=False))
    variants = {k: load_checkpoint_variables(f"{weights_dir}/{WEIGHT_FILES[k]}")
                for k in WEIGHTS}
    print("| style | schedule | resid natural | resid smooth | pick | "
          "full natural dB | full smooth dB | oracle | agree |")
    print("|---|---|---|---|---|---|---|---|---|")
    rows, agree_all = [], True
    for style in styles:
        sched_scene, seed = STYLES[style]
        scene = make_scene(b=8, h=h, w=h, seed=seed, style=style)
        row = FASTDVD_SCENES[sched_scene][False]
        # the held-out residual strips the guard; the oracle keeps it, as
        # users run it
        cfg = ADMMConfig(sigma=row.sigma, iters=studies.cut_iters(row.iters, cut),
                         denoiser="fastdvd", select_best=True)
        resids, pick, psnrs, oracle, agree, fulls = select_row(scene, prior, variants, cfg, device)
        agree_all &= agree
        print(f"| {style} | {sched_scene} | {resids[0]:.3e} | {resids[1]:.3e} | {pick} | "
              f"{psnrs[0]:.2f} | {psnrs[1]:.2f} | {oracle} | {'YES' if agree else 'NO'} |",
              flush=True)
        rows.append((style, sched_scene, resids, pick, psnrs, oracle, agree, fulls))
    print(f"\nresidual pick == oracle pick on all styles: {agree_all}")
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__)
    ap.add_argument("h", nargs="?", type=int, default=512)
    args = ap.parse_args()
    main(args.h, _check_device(args.device))
