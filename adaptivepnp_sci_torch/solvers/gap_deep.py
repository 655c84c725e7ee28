"""One-stage GAP solver with a deep prior on Bayer data
(port of ``adaptivepnp_sci_tpu.solvers.gap_deep``).

The reference's ``admm_denoise_bayer_demosaic_pre`` deep branches: the GAP
x-update ``x = (theta + b) + lam * At((y - A(theta + b)) / (phi_sum + gamma))``
(the fused x-update kernel in its GAP form, any ``lam``), the denoiser input
``x - b``, Malvar (or bilinear) demosaicking, the joint RGB denoiser, the
RGGB re-mosaic into theta, the clip and the GAP dual ``b = b - (x - theta)``.
The 'PPP' branch's scheduled adaptation is the two-stage solver's
(:mod:`adaptivepnp_sci_torch.adapt.online`), with its carried Adam state when
``fresh_opt_per_trigger=False``. There is no RGB dual ``w``. With a mesh, the
frames spread over the ranks of its ``frame`` axis as in the two-stage
solver.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
from torch import Tensor

from adaptivepnp_sci_torch.adapt.online import (
    AdaptConfig,
    FrameShard,
    carried_adam,
    check_adapt_supported,
    draws_randoms,
    make_adapt_fn,
    make_schedule,
)
from adaptivepnp_sci_torch.ops import bayer, cuda_kernels, demosaic, metrics, physics
from adaptivepnp_sci_torch.parallel.mesh import Mesh
from adaptivepnp_sci_torch.solvers.gap_tv import as_f32
from adaptivepnp_sci_torch.solvers.priors import Prior, working_copy
from adaptivepnp_sci_torch.solvers.two_stage_admm import (
    check_inputs,
    frame_metrics,
    full_f32,
    on_frames,
)


@dataclass(frozen=True)
class GapDeepConfig:
    """Solver configuration; fields mirror the JAX ``GapDeepConfig``."""

    sigma: tuple[float, ...]
    iters: tuple[int, ...]
    denoiser: str = "ffdnet"          # 'ffdnet' | 'fastdvd'
    demosaic_method: str = "malvar"   # 'malvar' | 'bilinear'
    lam: float = 1.0
    gamma: float = 0.01
    adapt: AdaptConfig | None = None  # the reference's 'PPP' / update branches


class GapDeepResult(NamedTuple):
    x_rgb: Tensor            # (B, H, W, 3) the last denoised RGB cube
    x_bayer: Tensor          # (B, H, W) the final estimate, from x
    psnr_per_frame: Tensor
    ssim_per_frame: Tensor
    psnr_trace: Tensor       # (T,) per-iteration PSNR of x (zeros without orig)
    variables: Any           # the (possibly adapted) denoiser state dict
    opt_state: Any = None    # the carried Adam's state dict, or None


def gap_deep(
    y_bayer: np.ndarray | Tensor,
    phi_bayer: np.ndarray | Tensor,
    config: GapDeepConfig,
    prior: Prior,
    params: Mapping[str, Tensor] | None,
    x0_bayer: np.ndarray | Tensor | None = None,
    orig_bayer: np.ndarray | Tensor | None = None,
    opt_state: Mapping | None = None,
    device: torch.device | str = "cuda",
    generator: torch.Generator | None = None,
    mesh: Mesh | None = None,
) -> GapDeepResult:
    """Reconstruct one measurement ``y (H, W)`` with masks ``phi (B, H, W)``
    by GAP with a deep prior. ``params`` (the denoiser state dict) and
    ``prior.model`` are never modified; the adapted weights come back in
    ``variables``. ``opt_state``: the carried Adam's state dict to continue
    from (``fresh_opt_per_trigger=False``). ``generator`` feeds the
    adaptation input noise (None seeds a CPU generator with 0). ``mesh``:
    each rank of its ``frame`` axis solves its ``B / frame`` consecutive
    frames (the prior in its frame-sharded form, the x-update in its split
    form) and every rank returns the whole result, as
    :func:`~adaptivepnp_sci_torch.solvers.two_stage_admm.two_stage_admm`."""
    if config.denoiser not in ("ffdnet", "fastdvd"):
        raise ValueError(f"gap_deep: denoiser must be 'ffdnet' or 'fastdvd', got "
                         f"{config.denoiser!r}")
    if config.adapt is not None:
        check_adapt_supported(prior, config.adapt)
    y = as_f32(y_bayer, device)
    phi = as_f32(phi_bayer, device)
    check_inputs(y, phi)
    frames = FrameShard.of(mesh, phi.shape[0])
    prior = on_frames(frames, prior, None, None)[0]

    def mine(t: Tensor) -> Tensor:
        return t if frames is None else frames.local(t)

    phi = mine(phi)
    y_p, phi_p = bayer.pack(y), bayer.pack(phi)
    x0 = (physics.adjoint(y_p, phi_p) if x0_bayer is None
          else bayer.pack(mine(as_f32(x0_bayer, device))))
    orig_all = as_f32(orig_bayer, device) if orig_bayer is not None else None
    orig = None if orig_all is None else mine(orig_all)
    psnr = metrics.psnr if frames is None else frames.psnr
    sigmas_np, mask = make_schedule(config.sigma, config.iters, config.adapt)
    dm = demosaic.bilinear if config.demosaic_method == "bilinear" else demosaic.malvar2004

    with full_f32(), torch.no_grad():
        phi_s = physics.phi_sum(phi_p, gather=None if frames is None else frames.gather)
        net = working_copy(prior, params, device)
        adapt, opt = None, None
        if config.adapt is not None:
            adapt = make_adapt_fn(prior, config.adapt)
            opt = carried_adam(net, config.adapt, opt_state)
            if draws_randoms(prior, config.adapt) and generator is None:
                generator = torch.Generator().manual_seed(0)
        sigmas = torch.as_tensor(sigmas_np, device=x0.device)
        x, theta, b = x0, x0, torch.zeros_like(x0)
        trace = []
        for k in range(len(sigmas_np)):
            x = cuda_kernels.gap_x_update(theta, b, y_p, phi_p, phi_s, config.lam, config.gamma,
                                          frames)
            x_rgb = dm(bayer.unpack(x - b))
            if adapt is not None and mask[k]:
                adapt(net, x_rgb, sigmas[k], y_p, phi_p, y, phi, generator, opt, frames=frames)
            xhat = prior.apply(net, x_rgb, sigmas[k])
            theta = torch.clamp(bayer.rggb_subsample(xhat), 0.0, 1.0)
            b = b - (x - theta)  # the GAP dual
            if orig is not None:
                trace.append(psnr(orig, bayer.unpack(x)))
        # the RGB result: one more denoise of the final estimate at the last sigma
        xhat = prior.apply(net, dm(bayer.unpack(x - b)), sigmas[-1])
        if frames is not None:
            x, xhat = frames.gather(x), frames.gather(xhat)
        x_bayer = bayer.unpack(x)
        p, s = frame_metrics(orig_all, x_bayer)
        tr = (torch.stack(trace) if orig is not None
              else torch.zeros(len(sigmas_np), dtype=torch.float32, device=x.device))
    return GapDeepResult(xhat, x_bayer, p, s, tr, net.state_dict(),
                         opt.state_dict() if opt is not None else None)
