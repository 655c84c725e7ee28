"""In-loop fidelity sweep of the solver's levers (port of
``scripts/sweep_fidelity.py``; 512x512x8 benchmark scene, FastDVDnet in
bf16).

Weight sets that denoise better alone can do worse inside the plug-and-play
loop. The levers tried on each set: per-sigma-stage relax schedules (damp
only the large-sigma stage, where the denoiser moves the iterate furthest)
and stronger, denser online adaptation (lr 1e-6 every 6 iterations, pulling
the weights toward measurement consistency). Sets: the shipped
``weights/fastdvd.npz`` and, where they exist, the 96-px-crop and textured
sets; an absent set prints a ``[skip]`` line. One line per run.

Usage: python -m adaptivepnp_sci_torch.sweep_fidelity [weights_96] [weights_tex]
       [--size 512] [--device cuda|cpu]
"""

from __future__ import annotations

import os
import time
from typing import Any

import torch

from adaptivepnp_sci_torch import studies
from adaptivepnp_sci_torch.adapt.online import AdaptConfig

STRONG_ADAPT = AdaptConfig(lr=1e-6, update_per_iter=2, interval_iter=6, initial_iter=1)


def runs(weight_sets: dict[str, Any]) -> list[tuple[str, str, Any, AdaptConfig]]:
    """``(label, set, relax, adapt)`` of every run over the present sets."""
    ref = studies.FASTDVD_ADAPT
    out = [(f"{name}: baseline (ref adapt, relax=1)", name, 1.0, ref) for name in weight_sets]
    for name in ("crop96", "textured"):
        if name not in weight_sets:
            continue
        out += [(f"{name}: relax (0.5, 1.0)", name, (0.5, 1.0), ref),
                (f"{name}: relax (0.7, 1.0)", name, (0.7, 1.0), ref),
                (f"{name}: relax (0.7, 0.9)", name, (0.7, 0.9), ref),
                (f"{name}: strong adapt (lr 1e-6, int 6)", name, 1.0, STRONG_ADAPT),
                (f"{name}: strong adapt + relax (0.7, 1.0)", name, (0.7, 1.0), STRONG_ADAPT)]
    return out


def fidelity_row(scene: Any, prior, params: dict, relax, adapt: AdaptConfig,
                 device: torch.device | str, iters=studies.FASTDVD_ITERS) -> tuple[float, Any]:
    """``(seconds, result)`` of the warm start and the solve with ``relax``
    and ``adapt`` on the FastDVDnet row's schedule (``iters``)."""
    from adaptivepnp_sci_torch.solvers.end_to_end import reconstruct_single_dispatch

    y, phi, orig = studies.on_device(scene, device)
    cfg = studies.fastdvd_config(adapt=adapt, iters=iters, denoiser_relax=relax)
    t0 = time.perf_counter()
    r = reconstruct_single_dispatch(y, phi, studies.WARM, cfg, prior, params, orig=orig,
                                    device=device)
    studies.synchronize(device)
    return time.perf_counter() - t0, r


def main(p96: str = "weights/fastdvd96/final", ptex: str = "weights/fastdvd_tex/final",
         size: int = 512, device: torch.device | str = "cuda",
         shipped: str = str(studies.REPO_WEIGHTS / "fastdvd.npz"),
         iters=studies.FASTDVD_ITERS) -> list[tuple[str, float, float, Any]]:
    """Print one line per run; returns ``(label, PSNR, SSIM, result)`` per
    run."""
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior
    from adaptivepnp_sci_torch.train.trainer import load_checkpoint_variables

    scene = make_scene(b=8, h=size, w=size, seed=42)
    prior = fastdvd_prior(FastDVDnet(dtype=torch.bfloat16))
    weight_sets = {}
    for name, path in (("shipped", shipped), ("crop96", p96), ("textured", ptex)):
        if os.path.exists(path):
            weight_sets[name] = load_checkpoint_variables(path)
        else:
            print(f"[skip] {name}: {path} absent")
    rows = []
    for label, name, relax, adapt in runs(weight_sets):
        secs, r = fidelity_row(scene, prior, weight_sets[name], relax, adapt, device, iters)
        p, s = studies.mean_db(r)
        print(f"{label:44s} PSNR {p:6.2f} dB  SSIM {s:.4f} ({secs:.0f}s)", flush=True)
        rows.append((label, p, s, r))
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__)
    ap.add_argument("paths", nargs="*", help="the 96-px-crop and the textured weight sets")
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args()
    main(*args.paths[:2], size=args.size, device=_check_device(args.device))
