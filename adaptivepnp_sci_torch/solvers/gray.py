"""Grayscale (non-Bayer) video-SCI solver
(port of ``adaptivepnp_sci_tpu.solvers.gray``).

The state is the raw frame cube ``(B, H, W)``: the GAP projection, with the
classic acceleration (the measurement residual fed back into ``y``) as an
option, then TV (the fused TV kernel on the card: one plane per frame) or a
caller's denoiser such as FFDNet-gray
(:func:`adaptivepnp_sci_torch.models.ffdnet.ffdnet_gray`), the clip to [0, 1]
and the GAP dual. With a mesh, each rank of its ``frame`` axis holds its
frames, and the frame sums run over every rank's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch import Tensor

from adaptivepnp_sci_torch.adapt.online import FrameShard
from adaptivepnp_sci_torch.ops import cuda_kernels, metrics, physics
from adaptivepnp_sci_torch.parallel.mesh import Mesh
from adaptivepnp_sci_torch.solvers.gap_tv import as_f32
from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32


@dataclass(frozen=True)
class GrayConfig:
    sigma: tuple[float, ...] = (0.0,)
    iters: tuple[int, ...] = (40,)
    denoiser: str = "tv"     # 'tv' | 'ffdnet'
    lam: float = 1.0
    gamma: float = 0.01
    accelerate: bool = False  # classic GAP acceleration (y-residual feedback)
    tv_weight: float = 0.1
    tv_iters: int = 5


class GrayResult(NamedTuple):
    x: Tensor                # (B, H, W)
    psnr_per_frame: Tensor
    ssim_per_frame: Tensor
    psnr_trace: Tensor       # (T,) per-iteration PSNR of x (zeros without orig)


def gap_denoise_gray(
    y: np.ndarray | Tensor,
    phi: np.ndarray | Tensor,
    config: GrayConfig = GrayConfig(),
    denoise_fn: Callable[[Any, Tensor, Tensor], Tensor] | None = None,
    variables: Any = None,
    x0: np.ndarray | Tensor | None = None,
    orig: np.ndarray | Tensor | None = None,
    device: torch.device | str = "cuda",
    mesh: Mesh | None = None,
) -> GrayResult:
    """Reconstruct a grayscale frame cube from one snapshot ``y (H, W)`` with
    masks ``phi (B, H, W)``. For ``denoiser='ffdnet'``,
    ``denoise_fn(variables, frames (B, H, W, 1), sigma) -> (B, H, W, 1)`` with
    the frames as a batch (e.g. ``lambda net, f, s: net(f, s)`` with an
    FFDNet-gray module as ``variables``). ``mesh``: every rank, given the
    whole inputs, holds its ``B / frame`` consecutive frames of the mesh's
    ``frame`` axis (``denoise_fn`` gets those: it must denoise each frame
    alone), the frame sums run over every rank's frames, and every rank
    returns the whole result."""
    if config.denoiser not in ("tv", "ffdnet"):
        raise ValueError(f"gray: denoiser must be 'tv' or 'ffdnet', got {config.denoiser!r}")
    if config.denoiser == "ffdnet" and denoise_fn is None:
        raise ValueError("gray: denoiser='ffdnet' needs a denoise_fn")
    y = as_f32(y, device)
    phi = as_f32(phi, device)
    frames = FrameShard.of(mesh, phi.shape[0])

    def mine(t: Tensor) -> Tensor:
        return t if frames is None else frames.local(t)

    phi = mine(phi)
    x0 = physics.adjoint(y, phi) if x0 is None else mine(as_f32(x0, device))
    orig_all = as_f32(orig, device) if orig is not None else None
    orig_t = None if orig_all is None else mine(orig_all)
    fwd = physics.forward if frames is None else frames.forward
    psnr = metrics.psnr if frames is None else frames.psnr
    sigmas = np.concatenate([np.full(n, s, np.float32) for s, n in zip(config.sigma, config.iters)])

    with full_f32(), torch.no_grad():
        phi_s = physics.phi_sum(phi, gather=None if frames is None else frames.gather)
        sig = torch.as_tensor(sigmas, device=x0.device)
        x, theta, b, y1 = x0, x0, torch.zeros_like(x0), y
        trace = []
        for k in range(len(sigmas)):
            if config.accelerate:
                # accelerated GAP (no dual): the measurement residual
                # accumulates into y1
                yb = fwd(theta, phi)
                y1 = y1 + (y - yb)
                resid = (y1 - yb) / (phi_s + config.gamma)
                x = theta + config.lam * (phi * resid[None])
                xb = x
            else:
                yb = fwd(theta + b, phi)
                resid = (y - yb) / (phi_s + config.gamma)
                x = theta + b + config.lam * (phi * resid[None])
                xb = x - b
            if config.denoiser == "tv":
                theta = cuda_kernels.tv_chambolle_fused(xb, weight=config.tv_weight,
                                                        max_iter=config.tv_iters)
            else:
                theta = denoise_fn(variables, xb[..., None], sig[k])[..., 0]
            theta = torch.clamp(theta, 0.0, 1.0)
            b = b - (x - theta)
            if orig_t is not None:
                trace.append(psnr(orig_t, x))
        if frames is not None:
            x = frames.gather(x)
        if orig_all is not None:
            p = metrics.psnr_per_frame(orig_all, x)
            s = metrics.ssim_per_frame(orig_all, x)
            tr = torch.stack(trace)
        else:
            p = s = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
            tr = torch.zeros(len(sigmas), dtype=torch.float32, device=x.device)
    return GrayResult(x, p, s, tr)
