"""SCI forward model and solver projection updates
(port of ``adaptivepnp_sci_tpu.ops.physics``).

``y = A(x) = sum_t Phi_t * x_t`` collapses ``B`` mask-modulated frames into
one snapshot; the adjoint broadcasts it back: ``At(y) = Phi * y``. Packed
Bayer state is ``(B, 4, H/2, W/2)`` with the frame axis leading; the
multi-measurement drivers put an item axis in front, ``(N, B, 4, H/2, W/2)``,
and name the frame axis ``PACKED_FRAME_AXIS`` (-4) to cover both.

``gap_x_update`` and ``admm_x_update`` are the plain versions of the fused
CUDA x-update kernel (:mod:`adaptivepnp_sci_torch.ops.cuda_kernels`), over
packed cubes with or without the item axis. They are composed of the split
form's two passes, which a frame-sharded solve runs with the frame axis
spread over ranks: :func:`x_update_partial` (``p`` and the rank's terms
``phi_t * p_t`` of the frame sum) and :func:`x_update_finish` (the frame sum
over every frame's terms, then the update), with the terms all-gathered over
the ranks between the two. The sum is taken over all ``B`` terms in frame
order on every rank, so each rank computes what one process computes, bit
for bit.
"""

from __future__ import annotations

from typing import Callable

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


def phi_sum(phi: Tensor, axis: int = FRAME_AXIS,
            gather: Callable[[Tensor, int], Tensor] | None = None) -> Tensor:
    """Per-pixel mask energy ``sum_t phi_t`` with the zero-guard: pixels never
    sampled get 1 so the x-updates never divide by zero. ``gather``: ``phi``
    holds this rank's frames, and ``gather(t, axis)`` concatenates every
    rank's ``t`` along ``axis``; the sum then runs over all frames before the
    guard (a guard per rank would set a pixel that one rank never samples to
    1 on that rank, and the sum over ranks would be wrong)."""
    s = torch.sum(phi if gather is None else gather(phi, axis), dim=axis)
    return torch.where(s == 0, torch.ones_like(s), s)


def x_update_partial(theta: Tensor, b: Tensor, phi: Tensor, sign: float,
                     rho: float) -> tuple[Tensor, Tensor]:
    """The first pass of the split x-update: ``p = theta + sign * b / rho``
    and the terms ``phi_t * p_t`` of the frame sum, for the frames at hand
    (``(..., B, 4, h, w)``; ``phi`` per item or shared)."""
    if sign < 0:
        p = theta - b / rho
    else:
        p = theta + b if rho == 1.0 else theta + b / rho
    return p, p * phi


def x_update_finish(p: Tensor, terms: Tensor, y: Tensor, phi: Tensor, phi_s: Tensor,
                    c: float, lam: float = 1.0) -> Tensor:
    """The second pass: ``x = p + lam * phi * (y - sum_t terms_t) / (c +
    phi_s)``, ``terms`` holding every frame's term (``(..., B, 4, h, w)``)
    while ``p`` and ``phi`` hold the frames at hand."""
    resid = (y - torch.sum(terms, dim=PACKED_FRAME_AXIS)) / (c + phi_s)
    step = phi * resid.unsqueeze(PACKED_FRAME_AXIS)
    return p + step if lam == 1.0 else p + lam * step


def gap_x_update(
    theta: Tensor, b: Tensor, y: Tensor, phi: Tensor, phi_s: Tensor,
    lam: float = 1.0, gamma: float = 0.01,
) -> Tensor:
    """GAP Euclidean-projection x-update of the TV warm start:
    ``x = (theta + b) + lam * At((y - A(theta + b)) / (phi_sum + gamma))``.
    ``theta``, ``b``: ``(..., B, 4, h, w)``; ``y``: ``(..., 4, h, w)``; ``phi``
    and ``phi_s`` per item or shared by all items."""
    p, terms = x_update_partial(theta, b, phi, 1.0, 1.0)
    return x_update_finish(p, terms, y, phi, phi_s, gamma, lam)


def admm_x_update(
    theta: Tensor, b: Tensor, y: Tensor, phi: Tensor, phi_s: Tensor,
    rho: float, alpha: float,
) -> Tensor:
    """Two-stage-ADMM x-update (diagonalized linear inverse):
    ``p = theta - b / rho``; ``x = p + Phi * (y - A(p)) / (alpha * rho + phi_sum)``,
    over the shapes of :func:`gap_x_update`."""
    p, terms = x_update_partial(theta, b, phi, -1.0, rho)
    return x_update_finish(p, terms, y, phi, phi_s, alpha * rho)


def measurement_loss(x: Tensor, phi: Tensor, y: Tensor) -> Tensor:
    """Self-supervised measurement-consistency loss ``MSE(A(x), y)``."""
    return torch.mean((forward(x, phi) - y) ** 2)
