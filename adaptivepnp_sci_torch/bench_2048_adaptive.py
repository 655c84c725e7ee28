"""The 2048x2048x8 adaptive solve on one card (port of
``scripts/bench_2048_adaptive.py``): the flagship configuration (FFDNet-color,
lr 2e-6, 2 steps every 15 iterations) in 512^2 tiles that share one
adaptation (``two_stage_admm_tiled``).

Two levers bound the adaptation's memory: ``AdaptConfig.crop`` (the loss on
a Bayer-aligned random ``crop x crop`` window, which stores ``(crop/512)^2``
of a tile's activations for the backward) and ``tile_chunk`` (tile groups
solved one after another, the adapted weights carried from group to group;
16 = all tiles at once). Each ``chunk:crop`` argument is one row (an empty
crop: the whole frame's loss); a run that exhausts the card's memory is
printed as ``FAILED`` with the error's first line.

Usage: python -m adaptivepnp_sci_torch.bench_2048_adaptive --ffdnet PATH [chunk:crop ...]
       [--size 2048] [--device cuda|cpu]   (default "4:" "4:256"; e.g. "16:")

The tiles are 512^2, or half the frame's side for a smaller ``--size``.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from adaptivepnp_sci_torch import studies

TILE = 512


def parse_combo(combo: str) -> tuple[int | None, int | None]:
    """``"chunk:crop"`` -> ``(tile_chunk, crop)``, None for an empty field."""
    cs, _, ks = combo.partition(":")
    return (int(cs) if cs else None), (int(ks) if ks else None)


def tiled_row(y, phi, orig, x0, prior, params: dict, config, tile: int, chunk: int | None,
              device: torch.device | str) -> tuple[float, Any]:
    """``(s/solve, result)`` of the second of two tiled solves (the first
    is the warm-up)."""
    from adaptivepnp_sci_torch.solvers.two_stage_admm import two_stage_admm_tiled

    def solve():
        r = two_stage_admm_tiled(y, phi, config, tile=tile, prior=prior, params=params,
                                 orig_bayer=orig, x0_bayer=x0, tile_chunk=chunk, device=device)
        studies.synchronize(device)
        return r

    solve()
    t0 = time.perf_counter()
    r = solve()
    return time.perf_counter() - t0, r


def main(ffdnet: str | dict, combos: tuple[str, ...] = ("4:", "4:256"), size: int = 2048,
         device: torch.device | str = "cuda", model=None, config=None) -> list[tuple]:
    """Print the table; returns ``(chunk, crop, s/solve or the error, PSNR,
    SSIM, result)`` per combination (PSNR, SSIM and result None for a
    failed run). ``config`` replaces the flagship's ``ADMMConfig`` (its
    crop is set per combination)."""
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color
    from adaptivepnp_sci_torch.solvers.gap_tv import gap_tv
    from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior

    b, tile = 8, min(TILE, size // 2)
    scene = make_scene(b=b, h=size, w=size, seed=42)
    y, phi, orig = studies.on_device(scene, device)
    params = studies.load_ffdnet_weights(ffdnet)
    prior = ffdnet_prior(ffdnet_color() if model is None else model)
    x0 = gap_tv(y, phi, studies.WARM, device=device).x_bayer
    where = "one card" if torch.device(device).type == "cuda" else "the CPU"
    print(f"{size}x{size}x{b}, {tile}^2 tiles, flagship adaptive config "
          f"(lr 2e-6, 2 steps every 15), {where}")
    print("| tile_chunk | adapt crop | s/solve (steady) | PSNR | SSIM |")
    print("|---|---|---|---|---|")
    rows = []
    for combo in combos:
        chunk, crop = parse_combo(combo)
        cfg = studies.with_adapt(studies.flagship_config() if config is None else config,
                                 crop=crop)
        label = f"| {chunk or (size // tile) ** 2} | {crop or 'full'} |"
        try:
            dt, r = tiled_row(y, phi, orig, x0, prior, params, cfg, tile, chunk, device)
        except torch.cuda.OutOfMemoryError as e:  # the card's answer is the result
            msg = str(e).splitlines()[0][:120]
            print(f"{label} FAILED: {msg} | | |", flush=True)
            rows.append((chunk, crop, msg, None, None, None))
            torch.cuda.empty_cache()
            continue
        p, s = studies.mean_db(r)
        print(f"{label} {dt:.2f} | {p:.2f} | {s:.4f} |", flush=True)
        rows.append((chunk, crop, dt, p, s, r))
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__, ffdnet=True)
    ap.add_argument("combos", nargs="*", default=["4:", "4:256"])
    ap.add_argument("--size", type=int, default=2048)
    args = ap.parse_args()
    main(args.ffdnet, tuple(args.combos), args.size, _check_device(args.device))
