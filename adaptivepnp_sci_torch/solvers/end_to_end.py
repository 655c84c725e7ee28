"""End-to-end reconstruction of one snapshot
(port of ``adaptivepnp_sci_tpu.solvers.end_to_end``).

GAP-TV warm start, then the two-stage online-adaptive ADMM, then per-frame
PSNR/SSIM, in one call. The JAX package compiles this into one program so
that a snapshot costs one dispatch; PyTorch runs it eagerly, and nothing
returns to the host before the end.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch
from torch import Tensor

from adaptivepnp_sci_torch.ops import bayer, physics
from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, _gap_tv_packed, as_f32
from adaptivepnp_sci_torch.solvers.priors import Prior
from adaptivepnp_sci_torch.solvers.two_stage_admm import (
    ADMMConfig,
    SolveState,
    check_supported,
    frame_metrics,
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
    #: the carried Adam's state dict (``fresh_opt_per_trigger=False``), or None
    opt_state: Any = None
    #: (T + 1,) select_best ranking statistics (see ``ADMMResult``), or None;
    #: the fields before it are the JAX ``EndToEndResult``'s, in its order
    resid_trace: Tensor | None = None


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
    demosaic_fn: Callable[[Tensor], Tensor] | None = None,
) -> EndToEndResult:
    """Reconstruct snapshot ``y (H, W)`` with masks ``phi (B, H, W)``.

    ``params`` is the denoiser state dict; it and ``prior.model`` are never
    modified, and the adapted weights come back in ``variables``. With
    ``orig (B, H, W)`` the result carries per-frame PSNR/SSIM and the
    per-iteration PSNR trace of the ADMM stage; without it they are zeros.
    ``generator`` feeds the adaptation input noise (None seeds one with 0).
    ``demosaic_fn`` is a fixed-weight deep demosaicker
    (:func:`~adaptivepnp_sci_torch.solvers.priors.ddnet_demosaic`), needed by
    ``demosaic_method="ddnet"``.
    """
    check_supported(admm_cfg, prior, demosaic_fn)
    y = as_f32(y, device)
    phi = as_f32(phi, device)
    orig_t = as_f32(orig, device) if orig is not None else None
    with full_f32(), torch.no_grad():
        y_p = bayer.pack(y)
        phi_p = bayer.pack(phi)
        x0 = physics.adjoint(y_p, phi_p)
        xw, _ = _gap_tv_packed(y_p, phi_p, x0, None, warm_cfg)
        st = SolveState(admm_cfg, prior, params, device, generator=generator)
        theta, xhat, trace, resids = run_admm(
            admm_cfg, prior, st.net, y[None], phi, xw[None],
            None if orig_t is None else orig_t[None], st.generator, demosaic_fn, None, st.opt)
        x_bayer = bayer.unpack(theta[0])
        p, s = frame_metrics(orig_t, x_bayer)
    variables, opt_state, _, _ = st.states()
    return EndToEndResult(xhat[0], x_bayer, p, s, trace[0], variables, opt_state, resids)
