"""Sweep ``denoiser_relax`` (and ``select_best``) on the FastDVDnet scene
rows (port of ``scripts/sweep_fastdvd_relax.py``).

The FastDVDnet rows can end below their own GAP-TV warm start on hard
scenes. Two counter-levers of the solver, at 512x512x8 on every scene:

  * ``denoiser_relax`` r: the averaged step ``xhat = (1 - r) x + r D(x)``;
  * ``select_best``: the held-out best-iterate guard.

Each row runs through the command line's pieces: ``cli._build_denoiser``
(FastDVDnet from ``weights/fastdvd.npz`` in bf16),
``configs.scenes.admm_config_for`` and ``pipelines.run_warm_start`` /
``run_reconstruction``. The relax arms run without the guard (the table
row's guard is switched off); the last column runs the best r with it.
Prints a markdown table to stdout.

Usage: python -m adaptivepnp_sci_torch.sweep_fastdvd_relax [scene ...] [--size 512]
       [--device cuda|cpu]
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any

import torch

from adaptivepnp_sci_torch import studies

RELAXES = (1.0, 0.5, 0.3, 0.15)


def relax_row(scene: Any, prior, variables: dict, config, device: torch.device | str,
              relaxes=RELAXES) -> tuple[float, dict[float, float], float, float, list[Any]]:
    """``(warm dB, {r: dB}, best r, dB of the best r with the guard,
    results)`` for a scene of the pipelines (``SceneData``) under ``config``
    (the scene's table row); ``results``: one per r, then the guarded one."""
    from adaptivepnp_sci_torch.pipelines import run_reconstruction, run_warm_start

    warm = run_warm_start(scene, device=device)
    results, outs = {}, []
    for r in relaxes:
        cfg = replace(config, denoiser_relax=r, select_best=False)
        out = run_reconstruction(scene, prior, variables, denoiser="fastdvd",
                                 warm_start=warm.x_bayer, config=cfg, device=device)
        results[r] = float(out.psnr.mean())
        outs.append(out)
        print(f"  {scene.name} r={r}: {results[r]:.2f} dB", flush=True)
    best_r = max(results, key=results.get)
    out = run_reconstruction(scene, prior, variables, denoiser="fastdvd",
                             warm_start=warm.x_bayer,
                             config=replace(config, denoiser_relax=best_r, select_best=True),
                             device=device)
    return float(warm.psnr.mean()), results, best_r, float(out.psnr.mean()), outs + [out]


def main(scenes: list[str], size: int = 512, device: torch.device | str = "cuda",
         cut: int | None = None) -> list[tuple]:
    """Print the table; returns ``(scene, style, warm dB, {r: dB}, best r,
    guarded dB, results)`` per scene. ``cut`` shortens every stage of the rows'
    schedules to at most that many iterations."""
    from adaptivepnp_sci_torch.cli import _build_denoiser
    from adaptivepnp_sci_torch.configs.scenes import admm_config_for
    from adaptivepnp_sci_torch.run_all_scenes import _make_scene_data

    _, prior, variables = _build_denoiser("fastdvd", None, bf16=True)
    print("| scene | stand-in | warm dB | " + " | ".join(f"r={r}" for r in RELAXES)
          + " | best r + select_best |")
    print("|---" * (len(RELAXES) + 4) + "|")
    rows = []
    for name in scenes:
        style, scene = _make_scene_data(name, 8, size, size, 1)
        config = admm_config_for(name, "fastdvd", False, True)
        config = replace(config, iters=studies.cut_iters(config.iters, cut))
        warm_db, results, best_r, guarded, outs = relax_row(scene, prior, variables, config,
                                                            device)
        print(f"| {name} | {style} | {warm_db:.2f} "
              + "".join(f"| {results[r]:.2f} " for r in RELAXES)
              + f"| r={best_r}+sb: {guarded:.2f} |", flush=True)
        rows.append((name, style, warm_db, results, best_r, guarded, outs))
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    from adaptivepnp_sci_torch.run_all_scenes import SCENE_STANDINS

    ap = studies.parser(__doc__)
    ap.add_argument("scenes", nargs="*")
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args()
    main(args.scenes or list(SCENE_STANDINS), args.size, _check_device(args.device))
