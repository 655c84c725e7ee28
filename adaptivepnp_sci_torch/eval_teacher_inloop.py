"""The distillation student's ceiling: the teacher (FFDNet-color) run
through the loop that ``eval_weights`` scores students in (port of
``scripts/eval_teacher_inloop.py``): the FastDVDnet branch's
``ADMMConfig`` (rho 0.55, sigma (12, 6)/255 x (24, 12), adaptation lr 2e-7,
2 steps every 12 iterations) from the 40-iteration GAP-TV warm start.

A student that imitated the teacher perfectly would land here; below it is
imitation error, and the gap between this and the shipped weights' number
is the difference of the operators.

Usage: python -m adaptivepnp_sci_torch.eval_teacher_inloop --ffdnet PATH [size] [style ...]
       [--device cuda|cpu]   (default 512, smooth textured leaves photo)
"""

from __future__ import annotations

from typing import Any

import torch

from adaptivepnp_sci_torch import studies

STYLES = ("smooth", "textured", "leaves", "photo")


def inloop_row(scene: Any, prior, params: dict, config, device: torch.device | str
               ) -> tuple[float, float, Any]:
    """``(warm dB, final dB, result)`` of the warm start and the solve."""
    from adaptivepnp_sci_torch.solvers.gap_tv import gap_tv
    from adaptivepnp_sci_torch.solvers.two_stage_admm import two_stage_admm

    y, phi, orig = studies.on_device(scene, device)
    warm = gap_tv(y, phi, studies.WARM, orig_bayer=orig, device=device)
    r = two_stage_admm(y, phi, config, prior, params, warm.x_bayer, orig, device)
    return float(warm.psnr_per_frame.mean()), float(r.psnr_per_frame.mean()), r


def main(ffdnet: str | dict, size: int = 512, styles=STYLES,
         device: torch.device | str = "cuda", model=None, config=None
         ) -> list[tuple[str, float, float, Any]]:
    """Print one line per style; returns ``(style, warm dB, final dB,
    result)``.
    The denoiser is the FFDNet prior (``model``, FFDNet-color by default)
    under the FastDVDnet branch's configuration (``config`` replaces it)."""
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color
    from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior

    prior = ffdnet_prior(ffdnet_color() if model is None else model)
    params = studies.load_ffdnet_weights(ffdnet)
    config = studies.fastdvd_config() if config is None else config
    rows = []
    for style in styles:
        scene = make_scene(b=8, h=size, w=size, seed=42, style=style)
        warm_db, final_db, r = inloop_row(scene, prior, params, config, device)
        print(f"teacher-in-loop@{size}/{style}: warm={warm_db:.2f} dB  final={final_db:.2f} dB",
              flush=True)
        rows.append((style, warm_db, final_db, r))
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__, ffdnet=True)
    ap.add_argument("size", nargs="?", type=int, default=512)
    ap.add_argument("styles", nargs="*")
    args = ap.parse_args()
    main(args.ffdnet, args.size, tuple(args.styles) or STYLES, _check_device(args.device))
