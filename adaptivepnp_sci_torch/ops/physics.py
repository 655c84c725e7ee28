"""SCI forward model and solver projection updates
(port of ``adaptivepnp_sci_tpu.ops.physics``).

``y = A(x) = sum_t Phi_t * x_t`` collapses ``B`` mask-modulated frames into
one snapshot; the adjoint broadcasts it back: ``At(y) = Phi * y``. Packed
Bayer state is ``(B, 4, H/2, W/2)`` with the frame axis leading; the
multi-measurement drivers put an item axis in front, ``(N, B, 4, H/2, W/2)``,
and name the frame axis ``PACKED_FRAME_AXIS`` (-4) to cover both.

``gap_x_update`` and ``admm_x_update`` are the plain versions of the fused
CUDA x-update kernel (:mod:`adaptivepnp_sci_torch.ops.cuda_kernels`), over
packed cubes with or without the item axis.
"""

from __future__ import annotations

import torch
from torch import Tensor

#: Frame axis of a frame cube without an item axis: (B, H, W) or (B, 4, H/2, W/2).
FRAME_AXIS = 0
#: Frame axis of packed cubes with or without an item axis: (..., B, 4, H/2, W/2).
PACKED_FRAME_AXIS = -4


def forward(x: Tensor, phi: Tensor, axis: int = FRAME_AXIS) -> Tensor:
    """SCI forward model ``A(x) = sum_t phi_t * x_t`` over the frame axis."""
    return torch.sum(x * phi, dim=axis)


def adjoint(y: Tensor, phi: Tensor, axis: int = FRAME_AXIS) -> Tensor:
    """Adjoint ``At(y) = phi * y`` (broadcast y over the frame axis)."""
    return phi * y.unsqueeze(axis)


def phi_sum(phi: Tensor, axis: int = FRAME_AXIS) -> Tensor:
    """Per-pixel mask energy ``sum_t phi_t`` with the zero-guard: pixels never
    sampled get 1 so the x-updates never divide by zero."""
    s = torch.sum(phi, dim=axis)
    return torch.where(s == 0, torch.ones_like(s), s)


def gap_x_update(
    theta: Tensor, b: Tensor, y: Tensor, phi: Tensor, phi_s: Tensor,
    lam: float = 1.0, gamma: float = 0.01,
) -> Tensor:
    """GAP Euclidean-projection x-update of the TV warm start:
    ``x = (theta + b) + lam * At((y - A(theta + b)) / (phi_sum + gamma))``.
    ``theta``, ``b``: ``(..., B, 4, h, w)``; ``y``: ``(..., 4, h, w)``; ``phi``
    and ``phi_s`` per item or shared by all items."""
    p = theta + b
    resid = (y - forward(p, phi, PACKED_FRAME_AXIS)) / (phi_s + gamma)
    return p + lam * (phi * resid.unsqueeze(PACKED_FRAME_AXIS))


def admm_x_update(
    theta: Tensor, b: Tensor, y: Tensor, phi: Tensor, phi_s: Tensor,
    rho: float, alpha: float,
) -> Tensor:
    """Two-stage-ADMM x-update (diagonalized linear inverse):
    ``p = theta - b / rho``; ``x = p + Phi * (y - A(p)) / (alpha * rho + phi_sum)``,
    over the shapes of :func:`gap_x_update`."""
    p = theta - b / rho
    resid = (y - forward(p, phi, PACKED_FRAME_AXIS)) / (alpha * rho + phi_s)
    return p + phi * resid.unsqueeze(PACKED_FRAME_AXIS)


def measurement_loss(x: Tensor, phi: Tensor, y: Tensor) -> Tensor:
    """Self-supervised measurement-consistency loss ``MSE(A(x), y)``."""
    return torch.mean((forward(x, phi) - y) ** 2)
