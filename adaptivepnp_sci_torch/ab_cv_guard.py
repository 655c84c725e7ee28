"""A/B the best-iterate guard: raw residual against held-out cross-validation
ranking (port of ``scripts/ab_cv_guard.py``).

``ADMMConfig.select_best`` ranks the iterates (the 40-iteration GAP-TV warm
start as candidate 0) by the raw measurement residual ``||A(theta) - y||^2``;
on clean measurements the warm start's raw residual is nearly unbeatable,
so the guard can discard better denoiser iterates. ``select_best_holdout``
removes a Bernoulli 5 % pixel subset from the solve's whole data term and
ranks iterates by their prediction of the true measurement at those pixels
(a pin still returns the full-data warm start).

Matrix: four scene/seed pairs x {no guard, raw guard, held-out guard} with
``weights/fastdvd.npz`` in the six-scene run's mode (bf16 DenBlocks, no
recomputation), adaptation on, at 512^2x8.

Usage: python -m adaptivepnp_sci_torch.ab_cv_guard [--size 512] [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from adaptivepnp_sci_torch import studies

#: (seed, style) of the four scenes
PAIRS = ((202, "textured"), (42, "textured"), (404, "photo"), (303, "leaves"))
#: (tag, select_best, select_best_holdout)
GUARDS = (("noguard ", False, 0.0), ("rawguard", True, 0.0), ("cvguard ", True, 0.05))


def guard_row(scene: Any, prior, params: dict, config, device: torch.device | str
              ) -> tuple[float, list[tuple[str, float, float, Any]]]:
    """The warm start's PSNR and, per guard of :data:`GUARDS`, ``(tag, PSNR,
    seconds, result)`` of the two-stage solve (``config`` with the guard's
    fields) from that warm start."""
    from adaptivepnp_sci_torch.ops import metrics
    from adaptivepnp_sci_torch.solvers.gap_tv import gap_tv
    from adaptivepnp_sci_torch.solvers.two_stage_admm import two_stage_admm

    y, phi, orig = studies.on_device(scene, device)
    warm = gap_tv(y, phi, studies.WARM, device=device)
    out = []
    for tag, guard, hf in GUARDS:
        cfg = dataclasses.replace(config, select_best=guard, select_best_holdout=hf)
        t0 = time.perf_counter()
        r = two_stage_admm(y, phi, cfg, prior, params, warm.x_bayer, orig, device)
        p = float(r.psnr_per_frame.mean())
        out.append((tag, p, time.perf_counter() - t0, r))
    return float(metrics.psnr(orig, warm.x_bayer)), out


def main(size: int = 512, device: torch.device | str = "cuda", config=None,
         weights: str = str(studies.REPO_WEIGHTS / "fastdvd.npz"), pairs=PAIRS
         ) -> list[tuple[int, str, float, list[tuple[str, float]]]]:
    """Print the matrix; returns ``(seed, style, warm dB, [(tag, dB), ...])``
    per scene."""
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior
    from adaptivepnp_sci_torch.train.trainer import load_checkpoint_variables

    params = load_checkpoint_variables(weights)
    prior = fastdvd_prior(FastDVDnet(dtype=torch.bfloat16, remat=False))
    config = studies.fastdvd_config() if config is None else config
    rows = []
    for seed, style in pairs:
        scene = make_scene(b=8, h=size, w=size, seed=seed, style=style)
        warm_db, arms = guard_row(scene, prior, params, config, device)
        print(f"-- seed {seed} {style}: warm {warm_db:.2f} dB", flush=True)
        for tag, p, secs, _ in arms:
            print(f"   {tag}: {p:.2f} dB ({secs:.0f}s)", flush=True)
        rows.append((seed, style, warm_db, [(tag.strip(), p) for tag, p, _, _ in arms]))
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args()
    main(args.size, _check_device(args.device))
