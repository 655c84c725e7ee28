"""Total-variation proximal operator, Chambolle 2004 dual projection
(port of ``adaptivepnp_sci_tpu.ops.tv``).

Semantics of scikit-image's ``_denoise_tv_chambolle_nd`` for 2-D planes,
including its energy-based early stop: each plane stops on its own once
``|E_prev - E| < eps * E_init``, where ``E = (sum d^2 + weight * sum |grad out|)
/ size``, and returns ``out`` from the last iteration that ran.

This is the plain version of the CUDA TV kernel
(:func:`adaptivepnp_sci_torch.ops.cuda_kernels.tv_chambolle_fused`). All
planes step together; a plane that has stopped keeps its state, as the JAX
``vmap`` of a ``while_loop`` does. The energy sums are taken in float64, as
the CUDA kernel's block reductions are, so the two agree on where each plane
stops.
"""

from __future__ import annotations

import torch
from torch import Tensor


def _divergence(py: Tensor, px: Tensor) -> Tensor:
    """Negative divergence of the dual field, planes ``(N, H, W)``."""
    d = -(py + px)
    d[:, 1:, :] += py[:, :-1, :]
    d[:, :, 1:] += px[:, :, :-1]
    return d


def _grad(out: Tensor) -> tuple[Tensor, Tensor]:
    """Forward differences, zero at the far edge."""
    gy = torch.zeros_like(out)
    gx = torch.zeros_like(out)
    gy[:, :-1, :] = out[:, 1:, :] - out[:, :-1, :]
    gx[:, :, :-1] = out[:, :, 1:] - out[:, :, :-1]
    return gy, gx


def tv_chambolle_planes(
    planes: Tensor, weight: float = 0.1, eps: float = 2.0e-4, max_iter: int = 5
) -> tuple[Tensor, Tensor]:
    """TV prox of each plane of ``(N, H, W)``; returns ``(out, iterations)``
    with the number of iterations each plane ran, ``(N,)`` int32."""
    img = planes.to(torch.float32)
    n, h, w = img.shape
    size = h * w
    tau = 0.25
    py = torch.zeros_like(img)
    px = torch.zeros_like(img)
    out = img.clone()
    active = torch.ones(n, dtype=torch.bool, device=img.device)
    iters = torch.zeros(n, dtype=torch.int32, device=img.device)
    e_init = torch.zeros(n, dtype=torch.float64, device=img.device)
    e_prev = torch.zeros(n, dtype=torch.float64, device=img.device)
    for i in range(max_iter):
        if i > 0 and not bool(active.any()):
            break
        d = _divergence(py, px) if i > 0 else torch.zeros_like(img)
        new_out = img + d
        gy, gx = _grad(new_out)
        norm = torch.sqrt(gy * gy + gx * gx)
        e = ((d.double() ** 2).sum((1, 2)) + weight * norm.double().sum((1, 2))) / size
        coef = norm * (tau / weight) + 1.0
        sel = active[:, None, None]
        out = torch.where(sel, new_out, out)
        py = torch.where(sel, (py - tau * gy) / coef, py)
        px = torch.where(sel, (px - tau * gx) / coef, px)
        iters = iters + active.to(torch.int32)
        if i == 0:
            e_init = e
        else:
            active = active & ~((e_prev - e).abs() < eps * e_init)
        e_prev = torch.where(active, e, e_prev)
    return out, iters


def tv_chambolle_2d(
    image: Tensor, weight: float = 0.1, eps: float = 2.0e-4, max_iter: int = 5
) -> Tensor:
    """Chambolle TV denoising of one 2-D image ``(H, W)``."""
    return tv_chambolle_planes(image[None], weight, eps, max_iter)[0][0]


def tv_chambolle_multichannel(
    x: Tensor, weight: float = 0.1, eps: float = 2.0e-4, max_iter: int = 5
) -> Tensor:
    """Channel-wise 2-D TV prox over ``(..., H, W)``: every leading index is
    denoised independently as one 2-D image."""
    lead, hw = x.shape[:-2], x.shape[-2:]
    out, _ = tv_chambolle_planes(x.reshape((-1,) + tuple(hw)), weight, eps, max_iter)
    return out.reshape(tuple(lead) + tuple(hw))
