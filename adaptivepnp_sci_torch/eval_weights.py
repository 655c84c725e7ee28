"""Score FastDVDnet weight sets for plug-and-play use (port of
``scripts/eval_weights.py``): standalone denoising PSNR, in-loop (two-stage
ADMM) PSNR, and the eval-mode Jacobian's spectral norm.

The three numbers answer different questions:
  * standalone PSNR: how well does it denoise (the offline objective)?
  * in-loop PSNR: does it stay stable when the ADMM loop feeds its output
    back through the measurement model 36 times?
  * sigma_max (power iteration on the input->output Jacobian, frozen BN):
    the contraction margin that separates the two. The JAX package's record
    for the shipped stable weights reads ~0.73; unstable longer-trained
    sets >= 0.95.

Every random draw (the standalone noise, the power iteration's start) goes
through :func:`draw_normal`, from a CPU generator seeded with 0, so a run on
the card draws what a CPU run draws. TF32 is off wherever the model runs.

Usage: python -m adaptivepnp_sci_torch.eval_weights ckpt [ckpt ...]
       [--size 64] [--style smooth|textured|leaves] [--device cuda|cpu]
       (``ckpt``: a trainer ``.pt`` or a ``/``-keyed ``.npz`` of Flax
       variables, e.g. ``weights/fastdvd.npz``; 64x64 is a fast triage,
       ``--size 512`` the benchmark's scene)
"""

from __future__ import annotations

import argparse

import torch
from torch import Tensor

#: the noise level of the standalone score and of the Jacobian
EVAL_SIGMA = 20 / 255


def draw_normal(generator: torch.Generator, shape: tuple[int, ...]) -> Tensor:
    """Standard normal float32 draws of ``shape`` from ``generator``, on its
    device: the one function every draw of this module goes through."""
    return torch.randn(shape, generator=generator, device=generator.device)


def _unit(u: Tensor) -> Tensor:
    """``u`` over its per-clip norm (all axes but the first)."""
    axes = tuple(range(1, u.dim()))
    return u / torch.sqrt(torch.clamp(torch.sum(u * u, dim=axes, keepdim=True), min=1e-20))


def sigma_max_eval(model: torch.nn.Module, variables, clips: Tensor,
                   generator: torch.Generator, iters: int = 6) -> float:
    """Power-iteration estimate of the eval-mode Jacobian's top singular
    value at ``EVAL_SIGMA``, averaged over the batch of ``(N, 5, H, W, 3)``
    ``clips`` (on the device to run on): ``iters`` rounds of ``J^T J`` by
    ``torch.func.jvp`` / ``vjp`` from a start drawn from ``generator``. The
    model runs without recomputation (forward-mode differentiation does not
    pass ``torch.utils.checkpoint``), which leaves its outputs as they are."""
    from adaptivepnp_sci_torch.solvers.priors import module_copy
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32

    net = module_copy(model, variables, clips.device).requires_grad_(False)
    if hasattr(net, "remat"):
        net.remat = False
    sigma = torch.full((clips.shape[0],), EVAL_SIGMA, device=clips.device)

    def f(x: Tensor) -> Tensor:
        return net(x, sigma)

    with full_f32(), torch.no_grad():
        u = _unit(draw_normal(generator, tuple(clips.shape)).to(clips.device))
        for _ in range(iters):
            _, ju = torch.func.jvp(f, (clips,), (u,))
            _, vjp_fn = torch.func.vjp(f, clips)
            u = _unit(vjp_fn(ju)[0])
        _, ju = torch.func.jvp(f, (clips,), (u,))
        return float(torch.mean(torch.sqrt(torch.sum(ju * ju, dim=(1, 2, 3)))))


def main(ckpts: list[str], size: int = 64, style: str = "smooth",
         device: torch.device | str = "cuda") -> list[tuple[str, float, float, float]]:
    """Score each checkpoint on ``device``; prints one line per checkpoint
    and returns ``(path, standalone dB, in-loop dB, sigma_max)`` for each."""
    from adaptivepnp_sci_torch.adapt.online import AdaptConfig
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.ops import metrics
    from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, gap_tv
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior, working_copy
    from adaptivepnp_sci_torch.solvers.two_stage_admm import ADMMConfig, full_f32, two_stage_admm
    from adaptivepnp_sci_torch.train.datasets import synthetic_video_dataset
    from adaptivepnp_sci_torch.train.trainer import load_checkpoint_variables

    device = torch.device(device)
    model = FastDVDnet()
    prior = fastdvd_prior(model)
    scene = make_scene(b=8, h=size, w=size, seed=42, style=style)
    warm = gap_tv(scene.meas, scene.mask, GapTVConfig(iters=40), device=device)
    cfg = ADMMConfig(
        sigma=(12 / 255, 6 / 255), iters=(24, 12), denoiser="fastdvd",
        adapt=AdaptConfig(lr=2e-7, update_per_iter=2, interval_iter=12, initial_iter=1),
    )
    clips = torch.as_tensor(synthetic_video_dataset(4, length=5, size=64, seed=9), device=device)
    rgb = torch.as_tensor(scene.orig_rgb, dtype=torch.float32, device=device)
    noisy = rgb + EVAL_SIGMA * draw_normal(torch.Generator().manual_seed(0),
                                           tuple(rgb.shape)).to(device)

    rows = []
    for path in ckpts:
        v = load_checkpoint_variables(path)
        net = working_copy(prior, v, device)
        with full_f32(), torch.no_grad():
            den = prior.apply(net, noisy, torch.tensor(EVAL_SIGMA, device=device))
        standalone = float(metrics.psnr(rgb, torch.clamp(den, 0, 1)))
        r = two_stage_admm(scene.meas, scene.mask, cfg, prior, v, warm.x_bayer,
                           scene.orig_bayer, device)
        inloop = float(r.psnr_per_frame.mean())
        # the same start for every set, as the JAX script's one key
        smax = sigma_max_eval(model, v, clips, torch.Generator().manual_seed(0))
        print(f"{path}: standalone={standalone:.2f} dB  "
              f"in-loop@{size}/{style}={inloop:.2f} dB  "
              f"sigma_max={smax:.3f}", flush=True)
        rows.append((path, standalone, inloop, smax))
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpts", nargs="+")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--style", default="smooth",
                    help="scene statistics for the eval scene (smooth|textured|leaves)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain versions of the kernels")
    args = ap.parse_args()
    main(args.ckpts, args.size, args.style, _check_device(args.device))
