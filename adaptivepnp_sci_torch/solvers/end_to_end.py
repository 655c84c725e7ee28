"""End-to-end reconstruction of one snapshot
(port of ``adaptivepnp_sci_tpu.solvers.end_to_end``).

GAP-TV warm start, then the two-stage online-adaptive ADMM, then per-frame
PSNR/SSIM, in one call. The JAX package compiles this into one program so
that a snapshot costs one dispatch; PyTorch runs it eagerly, and nothing
returns to the host before the end.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
from torch import Tensor

from adaptivepnp_sci_torch.ops import bayer, physics
from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, _gap_tv_packed, as_f32
from adaptivepnp_sci_torch.solvers.priors import Prior, working_copy
from adaptivepnp_sci_torch.solvers.two_stage_admm import (
    ADMMConfig,
    frame_metrics,
    check_supported,
    full_f32,
    run_admm,
)


class EndToEndResult(NamedTuple):
    x_rgb: Tensor
    x_bayer: Tensor
    psnr_per_frame: Tensor
    ssim_per_frame: Tensor
    psnr_trace: Tensor
    variables: Any


def reconstruct_single_dispatch(
    y: np.ndarray | Tensor,
    phi: np.ndarray | Tensor,
    warm_cfg: GapTVConfig,
    admm_cfg: ADMMConfig,
    prior: Prior | None,
    params: Mapping[str, Tensor] | None,
    orig: np.ndarray | Tensor | None = None,
    device: torch.device | str = "cuda",
    generator: torch.Generator | None = None,
) -> EndToEndResult:
    """Reconstruct snapshot ``y (H, W)`` with masks ``phi (B, H, W)``.

    ``params`` is the denoiser state dict; it and ``prior.model`` are never
    modified, and the adapted weights come back in ``variables``. With
    ``orig (B, H, W)`` the result carries per-frame PSNR/SSIM and the
    per-iteration PSNR trace of the ADMM stage; without it they are zeros.
    ``generator`` feeds the adaptation input noise (None seeds one with 0).
    """
    check_supported(admm_cfg)
    if admm_cfg.denoiser != "tv" and prior is None:
        raise ValueError(f"denoiser={admm_cfg.denoiser!r} requires a prior")
    y = as_f32(y, device)
    phi = as_f32(phi, device)
    orig_t = as_f32(orig, device) if orig is not None else None
    with full_f32(), torch.no_grad():
        y_p = bayer.pack(y)
        phi_p = bayer.pack(phi)
        x0 = physics.adjoint(y_p, phi_p)
        xw, _ = _gap_tv_packed(y_p, phi_p, x0, None, warm_cfg)
        net = working_copy(prior, params, device) if admm_cfg.denoiser != "tv" else None
        theta, xhat, trace = run_admm(admm_cfg, prior, net, y, phi, xw, orig_t,
                                      generator)
        x_bayer = bayer.unpack(theta)
        p, s = frame_metrics(orig_t, x_bayer)
    variables = net.state_dict() if net is not None else params
    return EndToEndResult(xhat, x_bayer, p, s, trace, variables)
