"""Two-stage online-adaptive plug-and-play ADMM, FFDNet and FastDVDnet paths
(port of ``adaptivepnp_sci_tpu.solvers.two_stage_admm``).

Stage 1 works on packed Bayer planes (dual ``b``): the diagonalized
x-update, then demosaicking to RGB. Stage 2 works on the RGB cube (dual
``w``, penalty ``tau``): the deep denoiser, then the re-mosaic into the
theta-update. Online adaptation of the denoiser fires on a mask computed on
the host from the static schedule, so the solver is a plain Python loop with
``if mask[k]: adapt``.

Ported: the ``ffdnet``, ``fastdvd`` and ``tv`` denoiser branches with Malvar
or bilinear demosaicking, and ``two_stage_admm``. Options of the JAX solver
outside that subset raise ``NotImplementedError``; none is silently ignored.

Convolutions run in full float32: on entry the solver turns TF32 off for
cuDNN and matmuls and restores the previous settings on exit.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
import torch.nn as nn
from torch import Tensor

from adaptivepnp_sci_torch.adapt.online import AdaptConfig, make_adapt_fn, make_schedule
from adaptivepnp_sci_torch.ops import bayer, cuda_kernels, demosaic, metrics, physics
from adaptivepnp_sci_torch.solvers.gap_tv import as_f32
from adaptivepnp_sci_torch.solvers.priors import Prior, working_copy


@dataclass(frozen=True)
class ADMMConfig:
    """Solver configuration; fields mirror the JAX ``ADMMConfig``."""

    sigma: tuple[float, ...]
    iters: tuple[int, ...]
    denoiser: str = "ffdnet"          # 'tv' | 'ffdnet' | 'fastdvd'
    demosaic_method: str = "malvar"   # 'malvar' | 'bilinear'
    closed_form_demosaic: bool = False
    tv_weight: float = 0.1
    tv_iters: int = 5
    adapt: AdaptConfig | None = None
    denoiser_relax: float | tuple[float, ...] = 1.0
    select_best: bool = False
    select_best_holdout: float = 0.0
    faithful_aliasing: bool = False

    @property
    def rho(self) -> float:
        if self.closed_form_demosaic or self.denoiser == "fastdvd":
            return 0.55
        return 1.0

    @property
    def alpha(self) -> float:
        return 0.01 if self.denoiser == "tv" else 1.0

    @property
    def tau(self) -> float:
        return 10.0 if self.closed_form_demosaic else 100.0


class ADMMResult(NamedTuple):
    x_rgb: Tensor            # (B, H, W, 3) final denoised RGB cube
    x_bayer: Tensor          # (B, H, W) final Bayer estimate (from theta)
    psnr_per_frame: Tensor   # (B,)
    ssim_per_frame: Tensor   # (B,)
    psnr_trace: Tensor       # (T,) per-iteration PSNR (zeros without orig)
    variables: Any           # the (possibly adapted) denoiser state dict


def check_supported(config: ADMMConfig) -> None:
    """Raise ``NotImplementedError`` for an option outside the ported subset."""
    if config.denoiser not in ("ffdnet", "fastdvd", "tv"):
        raise NotImplementedError(f"denoiser={config.denoiser!r} is not ported yet")
    if config.demosaic_method not in ("malvar", "bilinear"):
        raise NotImplementedError(
            f"demosaic_method={config.demosaic_method!r} is not ported yet")
    relax = config.denoiser_relax
    if any(r != 1.0 for r in (relax if isinstance(relax, tuple) else (relax,))):
        raise NotImplementedError("denoiser_relax != 1 is not ported yet")
    for name in ("closed_form_demosaic", "select_best", "faithful_aliasing"):
        if getattr(config, name):
            raise NotImplementedError(f"{name} is not ported yet")
    if config.select_best_holdout:
        raise NotImplementedError("select_best_holdout is not ported yet")


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls; restore the
    previous settings on exit."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def run_admm(config: ADMMConfig, prior: Prior | None, net: nn.Module | None,
             y_full: Tensor, phi_full: Tensor, x0: Tensor, orig: Tensor | None,
             generator: torch.Generator | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """The whole sigma schedule from the packed warm start ``x0``; adapts
    ``net`` in place when the schedule fires, drawing the adaptation noise
    from ``generator`` (None: one seeded with 0 on the run's device).
    Returns ``(theta, xhat, trace)``:
    the packed final theta, the final RGB cube (zeros for 'tv') and the
    per-iteration PSNR of theta against ``orig`` (zeros without it)."""
    sigmas_np, mask = make_schedule(config.sigma, config.iters, config.adapt)
    total = int(sigmas_np.shape[0])
    rho, alpha, tau = config.rho, config.alpha, config.tau
    dev = x0.device

    y_p = bayer.pack(y_full)      # (4, H2, W2)
    phi_p = bayer.pack(phi_full)  # (B, 4, H2, W2)
    phi_s = physics.phi_sum(phi_p)
    n_frames, h, w = phi_full.shape
    trace: list[Tensor] = []

    def trace_psnr(theta: Tensor) -> None:
        if orig is not None:
            trace.append(metrics.psnr(orig, bayer.unpack(theta)))

    def finish_trace() -> Tensor:
        if orig is None:
            return torch.zeros(total, dtype=torch.float32, device=dev)
        return torch.stack(trace)

    x, theta, b = x0, x0, torch.zeros_like(x0)
    if config.denoiser == "tv":
        for _ in range(total):
            x = cuda_kernels.admm_x_update(theta, b, y_p, phi_p, phi_s, rho, alpha)
            xb = x + b / rho
            theta = cuda_kernels.tv_chambolle_fused(xb, weight=config.tv_weight,
                                                    max_iter=config.tv_iters)
            theta = torch.clamp(theta, 0.0, 1.0)
            b = b + (x - theta)
            trace_psnr(theta)
        zero_rgb = torch.zeros((n_frames, h, w, 3), dtype=torch.float32, device=dev)
        return theta, zero_rgb, finish_trace()

    dm = demosaic.bilinear if config.demosaic_method == "bilinear" else demosaic.malvar2004
    adapt = make_adapt_fn(prior, config.adapt) if config.adapt is not None else None
    if adapt is not None and prior.adapt_noise_std > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    sigmas = torch.as_tensor(sigmas_np, device=dev)  # one copy; sigmas[k] is a view
    w_dual = torch.zeros((n_frames, h, w, 3), dtype=torch.float32, device=dev)
    xhat = w_dual
    for k in range(total):
        sigma = sigmas[k]
        x = cuda_kernels.admm_x_update(theta, b, y_p, phi_p, phi_s, rho, alpha)
        x_rgb = dm(bayer.unpack(x + b / rho))
        x_rgb_w = x_rgb - w_dual / tau
        if adapt is not None and mask[k]:
            adapt(net, x_rgb_w, sigma, y_p, phi_p, y_full, phi_full, generator)
        xhat = prior.apply(net, x_rgb_w, sigma)
        theta = torch.clamp(bayer.rggb_subsample(xhat), 0.0, 1.0)
        b = b + (x - theta)
        w_dual = w_dual + (x_rgb - xhat)
        trace_psnr(theta)
    return theta, xhat, finish_trace()


def frame_metrics(orig: Tensor | None, x_bayer: Tensor) -> tuple[Tensor, Tensor]:
    if orig is None:
        z = torch.zeros(x_bayer.shape[0], dtype=torch.float32, device=x_bayer.device)
        return z, z
    return metrics.psnr_per_frame(orig, x_bayer), metrics.ssim_per_frame(orig, x_bayer)


def two_stage_admm(
    y_bayer: np.ndarray | Tensor,
    phi_bayer: np.ndarray | Tensor,
    config: ADMMConfig,
    prior: Prior | None = None,
    params: Mapping[str, Tensor] | None = None,
    x0_bayer: np.ndarray | Tensor | None = None,
    orig_bayer: np.ndarray | Tensor | None = None,
    device: torch.device | str = "cuda",
    generator: torch.Generator | None = None,
) -> ADMMResult:
    """Reconstruct one measurement.

    Args:
      y_bayer:    snapshot ``(H, W)``.
      phi_bayer:  masks ``(B, H, W)``.
      config:     solver schedule and penalties.
      prior:      deep denoiser plugin (None for 'tv').
      params:     denoiser state dict; never modified. The adapted weights
        come back in ``ADMMResult.variables``.
      x0_bayer:   warm start ``(B, H, W)`` (e.g. GAP-TV output).
      orig_bayer: optional ground truth for metrics.
      device:     where to run; the kernels run on CUDA.
      generator:  source of the adaptation input noise (FastDVDnet); None
        seeds one with 0.
    """
    check_supported(config)
    y = as_f32(y_bayer, device)
    phi = as_f32(phi_bayer, device)
    if y.dim() != 2 or phi.dim() != 3 or tuple(phi.shape[1:]) != tuple(y.shape):
        raise ValueError(
            f"expected y (H, W) and phi (B, H, W) with matching spatial dims; "
            f"got y {tuple(y.shape)}, phi {tuple(phi.shape)}"
        )
    if y.shape[0] % 2 or y.shape[1] % 2:
        raise ValueError(f"Bayer dims must be even, got {tuple(y.shape)}")
    if config.denoiser != "tv" and prior is None:
        raise ValueError(f"denoiser={config.denoiser!r} requires a prior")

    if x0_bayer is None:
        x0 = physics.adjoint(bayer.pack(y), bayer.pack(phi))
    else:
        x0 = bayer.pack(as_f32(x0_bayer, device))
    orig = as_f32(orig_bayer, device) if orig_bayer is not None else None

    with full_f32(), torch.no_grad():
        net = working_copy(prior, params, device) if config.denoiser != "tv" else None
        theta, xhat, trace = run_admm(config, prior, net, y, phi, x0, orig, generator)
        x_bayer = bayer.unpack(theta)
        p, s = frame_metrics(orig, x_bayer)
    variables = net.state_dict() if net is not None else params
    return ADMMResult(xhat, x_bayer, p, s, trace, variables)
