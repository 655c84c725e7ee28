"""SCI forward model and solver projection updates
(port of ``adaptivepnp_sci_tpu.ops.physics``).

``y = A(x) = sum_t Phi_t * x_t`` collapses ``B`` mask-modulated frames into
one snapshot; the adjoint broadcasts it back: ``At(y) = Phi * y``. Packed
Bayer state is ``(B, 4, H/2, W/2)`` with the frame axis leading.

``gap_x_update`` and ``admm_x_update`` are the plain versions of the fused
CUDA x-update kernel (:mod:`adaptivepnp_sci_torch.ops.cuda_kernels`).
"""

from __future__ import annotations

import torch
from torch import Tensor

#: Frame axis of packed state tensors (B, 4, H/2, W/2).
FRAME_AXIS = 0


def forward(x: Tensor, phi: Tensor) -> Tensor:
    """SCI forward model ``A(x) = sum_t phi_t * x_t`` over the frame axis."""
    return torch.sum(x * phi, dim=FRAME_AXIS)


def adjoint(y: Tensor, phi: Tensor) -> Tensor:
    """Adjoint ``At(y) = phi * y`` (broadcast y over the frame axis)."""
    return phi * y[None]


def phi_sum(phi: Tensor) -> Tensor:
    """Per-pixel mask energy ``sum_t phi_t`` with the zero-guard: pixels never
    sampled get 1 so the x-updates never divide by zero."""
    s = torch.sum(phi, dim=FRAME_AXIS)
    return torch.where(s == 0, torch.ones_like(s), s)


def gap_x_update(
    theta: Tensor, b: Tensor, y: Tensor, phi: Tensor, phi_s: Tensor,
    lam: float = 1.0, gamma: float = 0.01,
) -> Tensor:
    """GAP Euclidean-projection x-update of the TV warm start:
    ``x = (theta + b) + lam * At((y - A(theta + b)) / (phi_sum + gamma))``."""
    p = theta + b
    resid = (y - forward(p, phi)) / (phi_s + gamma)
    return p + lam * (phi * resid[None])


def admm_x_update(
    theta: Tensor, b: Tensor, y: Tensor, phi: Tensor, phi_s: Tensor,
    rho: float, alpha: float,
) -> Tensor:
    """Two-stage-ADMM x-update (diagonalized linear inverse):
    ``p = theta - b / rho``; ``x = p + Phi * (y - A(p)) / (alpha * rho + phi_sum)``."""
    p = theta - b / rho
    resid = (y - forward(p, phi)) / (alpha * rho + phi_s)
    return p + phi * resid[None]


def measurement_loss(x: Tensor, phi: Tensor, y: Tensor) -> Tensor:
    """Self-supervised measurement-consistency loss ``MSE(A(x), y)``."""
    return torch.mean((forward(x, phi) - y) ** 2)
