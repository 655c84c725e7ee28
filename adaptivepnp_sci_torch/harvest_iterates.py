"""Harvest the plug-and-play loop's own denoiser inputs for distillation
(port of ``scripts/harvest_iterates.py``).

Operator distillation on Gaussian-noised clips transfers the teacher's prior
standalone, but the student can collapse in the loop: the ADMM iterates
leave the noised-clip manifold. This records ``x_rgb_w``, the exact tensor
the solver hands the denoiser (x-update -> Malvar demosaic -> ``x_rgb -
w/tau``), with its conditioning sigma, from two trajectory families:

  * teacher loop: the fixed-weight FFDNet of ``--teacher PATH`` as the
    prior (the operator the student should become);
  * student loop: the current student, FastDVDnet in bf16 through
    ``fastdvd_prior`` (the neighbourhoods the corrected operator must pull
    back from).

Fixed weights, clean duals, rho 0.55, over :data:`SCHEDULE`. From every
iterate it samples circular 5-frame windows x Bayer-phase-aligned 64 px
crops, cropped on the device; only the small stack goes to the host.

Usage:
  python -m adaptivepnp_sci_torch.harvest_iterates --teacher PATH [out.npz]
      [student_ckpt] [--size 512] [--device cuda|cpu]
    (student_ckpt default weights/fastdvd_distill/final.pt; '-' skips the
     student loop)

Output npz: clips (N, 5, 64, 64, 3) float32 in the solver's value range,
sigmas (N,) float32, for ``adaptivepnp_sci_torch.distill_iterates``.
"""

from __future__ import annotations

import argparse
from typing import Callable

import numpy as np
import torch
from torch import Tensor

#: the hard-scene schedule family (Bosphorus/Runner rows)
SCHEDULE = ((50 / 255, 8), (25 / 255, 8), (12 / 255, 8), (6 / 255, 8))
STYLES = ("smooth", "textured", "leaves", "photo")
SEEDS = (11, 22)
CROPS_PER_ITER = 4          # windows x crops sampled from every iterate
CROP = 64


def run_loop_and_harvest(y: Tensor, phi: Tensor, x0_packed: Tensor,
                         prior_apply: Callable[[Tensor, Tensor], Tensor],
                         rng: np.random.Generator, crops: list, sigmas: list) -> None:
    """The solver's fixed-weight denoiser path (clean duals) on ``y (H, W)``
    and ``phi (B, H, W)`` from ``x0_packed (B, 4, H/2, W/2)``, all on the
    device to run on, appending the crops of the denoiser's input at every
    iteration to ``crops`` (host arrays) and their sigmas to ``sigmas``;
    ``rng`` draws the windows and crop offsets."""
    from adaptivepnp_sci_torch.ops import bayer, cuda_kernels, physics
    from adaptivepnp_sci_torch.ops.demosaic import malvar2004

    rho, alpha, tau = 0.55, 1.0, 100.0
    y_p = bayer.pack(y)
    phi_p = bayer.pack(phi)
    phi_s = physics.phi_sum(phi_p)
    n_frames, h, w = phi.shape

    theta = x0_packed
    b = torch.zeros_like(theta)
    w_dual = torch.zeros((n_frames, h, w, 3), dtype=torch.float32, device=y.device)
    for sigma, iters in SCHEDULE:
        for _ in range(iters):
            x = cuda_kernels.admm_x_update(theta, b, y_p, phi_p, phi_s, rho, alpha)
            x_rgb = malvar2004(bayer.unpack(x + b / rho))
            x_rgb_w = x_rgb - w_dual / tau

            # circular 5-windows x Bayer-aligned crops, cropped on the device
            wins = []
            for _ in range(CROPS_PER_ITER):
                f = int(rng.integers(n_frames))
                idx = torch.from_numpy(np.arange(f - 2, f + 3) % n_frames).to(y.device)
                yy = 2 * int(rng.integers((h - CROP) // 2 + 1))
                xx = 2 * int(rng.integers((w - CROP) // 2 + 1))
                wins.append(x_rgb_w[idx, yy:yy + CROP, xx:xx + CROP])
                sigmas.append(sigma)
            crops.extend(torch.stack(wins).cpu().numpy())

            xhat = prior_apply(x_rgb_w, torch.tensor(sigma, dtype=torch.float32,
                                                     device=y.device))
            theta = torch.clamp(bayer.rggb_subsample(xhat), 0.0, 1.0)
            b = b + (x - theta)
            w_dual = w_dual + (x_rgb - xhat)


def priors(teacher: str, student_ckpt: str | None, device: torch.device | str
           ) -> dict[str, Callable[[Tensor, Tensor], Tensor]]:
    """``{name: (x_rgb, sigma) -> xhat}``: the teacher FFDNet, and unless
    ``student_ckpt`` is ``'-'`` or None the bf16 FastDVDnet student, both
    with fixed weights, without gradients, TF32 off."""
    from adaptivepnp_sci_torch.distill_fastdvd import teacher_fn
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior, working_copy
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32
    from adaptivepnp_sci_torch.train.trainer import load_checkpoint_variables

    def fixed(fn):
        def apply(x: Tensor, s: Tensor) -> Tensor:
            with full_f32(), torch.no_grad():
                return fn(x, s)
        return apply

    out = {"teacher": fixed(teacher_fn(teacher, device))}
    if student_ckpt not in (None, "-"):
        sp = fastdvd_prior(FastDVDnet(dtype=torch.bfloat16))
        net = working_copy(sp, load_checkpoint_variables(student_ckpt), device)
        out["student"] = fixed(lambda x, s: sp.apply(net, x, s))
    return out


def main(out: str, teacher: str, student_ckpt: str | None = "weights/fastdvd_distill/final.pt",
         size: int = 512, styles: tuple[str, ...] = STYLES, seeds: tuple[int, ...] = SEEDS,
         device: torch.device | str = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """Harvest every style x seed x prior at ``size`` on ``device`` into
    ``out``; returns ``(clips, sigmas)``."""
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.ops import bayer
    from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, gap_tv

    loops = priors(teacher, student_ckpt, device)
    crops: list = []
    sigmas: list = []
    rng = np.random.default_rng(7)
    for style in styles:
        for seed in seeds:
            sc = make_scene(b=8, h=size, w=size, seed=seed, style=style)
            y = torch.as_tensor(sc.meas, dtype=torch.float32, device=device)
            phi = torch.as_tensor(sc.mask, dtype=torch.float32, device=device)
            warm = gap_tv(y, phi, GapTVConfig(iters=40), device=device)
            x0 = bayer.pack(warm.x_bayer)  # (B, H, W) -> (B, 4, H/2, W/2)
            for name, apply in loops.items():
                n0 = len(crops)
                run_loop_and_harvest(y, phi, x0, apply, rng, crops, sigmas)
                print(f"{style}/{seed}/{name}: +{len(crops) - n0} clips", flush=True)

    clips = np.stack(crops)
    sig = np.asarray(sigmas, np.float32)
    np.savez(out, clips=clips, sigmas=sig)
    print(f"harvested {clips.shape} -> {out} ({clips.nbytes / 2**20:.0f} MB)")
    return clips, sig


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="weights/iterate_pool.npz")
    ap.add_argument("student_ckpt", nargs="?", default="weights/fastdvd_distill/final.pt")
    ap.add_argument("--teacher", required=True,
                    help="FFDNet-color weights: .pth, /-keyed .npz or trainer .pt")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain versions of the kernels")
    args = ap.parse_args()
    main(args.out, args.teacher, args.student_ckpt, args.size,
         device=_check_device(args.device))
