"""Shared model building blocks (port of ``adaptivepnp_sci_tpu.models.common``).

The JAX package works in NHWC; these take NCHW, PyTorch's layout.
``space_to_depth`` / ``depth_to_space`` are ``F.pixel_unshuffle`` /
``F.pixel_shuffle``: output channel ``c*r*r + i*r + j`` holds input pixel
offset ``(i, j)`` of channel ``c``, the ordering of the JAX helpers.
``upsample_bilinear_align_corners`` is ``nn.UpsamplingBilinear2d``'s
arithmetic, which the JAX helper spells out by hand.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import Tensor


def space_to_depth(x: Tensor, r: int = 2) -> Tensor:
    """``(N, C, H, W) -> (N, C*r*r, H/r, W/r)``."""
    return F.pixel_unshuffle(x, r)


def depth_to_space(x: Tensor, r: int = 2) -> Tensor:
    """Inverse of :func:`space_to_depth`."""
    return F.pixel_shuffle(x, r)


def replication_pad_to_even(x: Tensor) -> tuple[Tensor, int, int]:
    """Edge-replicate pad NCHW spatial dims up to even sizes; returns pads."""
    h, w = x.shape[-2:]
    ph, pw = h % 2, w % 2
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return x, ph, pw


def upsample_bilinear_align_corners(x: Tensor, scale: int = 2) -> Tensor:
    """Bilinear upsample of NCHW ``x`` by ``scale`` with ``align_corners=True``:
    output sample ``o`` reads input coordinate ``o * (in - 1) / (out - 1)``."""
    return F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=True)
