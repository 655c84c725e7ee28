"""Measure tile-seam artifacts of the large-scene mode and the halo-overlap
fix (port of ``scripts/measure_tile_seams.py``).

``two_stage_admm_tiled`` with ``overlap=0`` hands the denoiser and the
demosaicker hard tile borders every iteration. Metric: PSNR restricted to
the seam band (pixels within ``band`` px of an interior tile border line)
against PSNR on the interior complement, with and without ``overlap``.
Scene: dead-leaves statistics (smooth scenes hide border effects); a
fixed-weight FFDNet-color with the flagship schedule, the weights of
``--ffdnet PATH`` (the reference's ``.pth``, a ``/``-keyed ``.npz`` or a
trainer ``.pt``); the GAP-TV warm start on the whole scene.

Usage: python -m adaptivepnp_sci_torch.measure_tile_seams --ffdnet PATH [h] [tile] [band]
       [--device cuda|cpu]   (defaults 1024, 512, 8)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

#: the flagship schedule, fixed weights
SIGMA = (25 / 255, 12 / 255, 6 / 255)
ITERS = (15, 6, 4)
OVERLAPS = (0, 16, 32)


def band_masks(h: int, w: int, tile: int, band: int) -> np.ndarray:
    """Boolean (H, W) mask of pixels within ``band`` px of an interior tile
    border line (either axis)."""
    def near(n):
        idx = np.arange(n)
        lines = np.arange(tile, n, tile)  # interior borders only
        if len(lines) == 0:
            return np.zeros(n, bool)
        d = np.abs(idx[:, None] - lines[None, :]).min(1)
        # border between pixel tile-1 and tile: band covers both sides
        d2 = np.abs(idx[:, None] - (lines[None, :] - 1)).min(1)
        return np.minimum(d, d2) < band

    return near(h)[:, None] | near(w)[None, :]


def masked_psnr(orig: np.ndarray, rec: np.ndarray, mask: np.ndarray) -> float:
    """Mean-over-frames PSNR on the masked pixels (orig/rec: (B, H, W))."""
    err = (orig - rec) ** 2
    mse = (err * mask).sum((1, 2)) / mask.sum()
    return float((10 * np.log10(1.0 / np.maximum(mse, 1e-12))).mean())


def seam_psnrs(orig: np.ndarray, rec: np.ndarray, tile: int, band: int
               ) -> tuple[float, float, float]:
    """``(full, seam band, interior)`` PSNR of ``rec`` against ``orig`` (B, H, W)."""
    seam = band_masks(orig.shape[1], orig.shape[2], tile, band)
    return (masked_psnr(orig, rec, np.ones_like(seam, dtype=float)),
            masked_psnr(orig, rec, seam.astype(float)),
            masked_psnr(orig, rec, (~seam).astype(float)))


def main(ffdnet: str, h: int = 1024, tile: int = 512, band: int = 8,
         device: torch.device | str = "cuda", overlaps: tuple[int, ...] = OVERLAPS
         ) -> list[tuple[int, float, float, float, float]]:
    """Print the table on ``device``; returns one row per overlap of
    ``overlaps``: ``(overlap, full dB, seam dB, interior dB, s/solve)``, the
    time of the second of two solves."""
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.distill_fastdvd import load_teacher
    from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color
    from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, gap_tv
    from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior
    from adaptivepnp_sci_torch.solvers.two_stage_admm import ADMMConfig, two_stage_admm_tiled

    device = torch.device(device)
    scene = make_scene(b=8, h=h, w=h, seed=42, style="leaves")
    y = torch.as_tensor(scene.meas, dtype=torch.float32, device=device)
    phi = torch.as_tensor(scene.mask, dtype=torch.float32, device=device)
    orig = np.asarray(scene.orig_bayer)

    params = load_teacher(ffdnet)
    prior = ffdnet_prior(ffdnet_color())
    config = ADMMConfig(sigma=SIGMA, iters=ITERS, denoiser="ffdnet")

    x0 = gap_tv(y, phi, GapTVConfig(iters=40), device=device).x_bayer
    seam = band_masks(h, h, tile, band)
    print(f"{h}x{h}x8 dead-leaves, tile={tile}, band=±{band}px "
          f"({seam.mean() * 100:.1f}% of pixels), fixed-weight FFDNet "
          f"{config.sigma} x {config.iters}")
    print("| overlap | PSNR full | PSNR seam band | PSNR interior | seam delta | s/solve |")
    print("|---|---|---|---|---|---|")
    rows = []
    for ov in overlaps:
        def solve():
            r = two_stage_admm_tiled(y, phi, config, tile=tile, prior=prior, params=params,
                                     x0_bayer=x0, overlap=ov, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize()
            return r

        solve()  # warm-up: the kernels' first launches, cuDNN's plans
        t0 = time.perf_counter()
        r = solve()
        dt = time.perf_counter() - t0
        p_full, p_seam, p_int = seam_psnrs(orig, r.x_bayer.cpu().numpy(), tile, band)
        print(f"| {ov} | {p_full:.2f} | {p_seam:.2f} | {p_int:.2f} "
              f"| {p_int - p_seam:+.2f} | {dt:.2f} |", flush=True)
        rows.append((ov, p_full, p_seam, p_int, dt))
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sizes", nargs="*", type=int, help="h, tile, band")
    ap.add_argument("--ffdnet", required=True,
                    help="FFDNet-color weights: .pth, /-keyed .npz or trainer .pt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain versions of the kernels")
    args = ap.parse_args()
    main(args.ffdnet, *args.sizes[:3], device=_check_device(args.device))
