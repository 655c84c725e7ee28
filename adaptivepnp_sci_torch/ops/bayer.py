"""Bayer / CFA layout ops (port of ``adaptivepnp_sci_tpu.ops.bayer``).

The solver state lives in packed RGGB planes: a full-resolution mosaic
``(..., H, W)`` becomes four half-resolution planes ``(..., 4, H/2, W/2)``
ordered ``[R, G1, G2, B]`` (offsets ``[(0,0), (0,1), (1,0), (1,1)]``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import Tensor

#: RGGB plane offsets, plane order [R, G1, G2, B].
BAYER_OFFSETS = ((0, 0), (0, 1), (1, 0), (1, 1))


def pack(x: Tensor) -> Tensor:
    """Full-res mosaic ``(..., H, W)`` -> packed planes ``(..., 4, H/2, W/2)``.

    Plane ``a*2+b`` holds ``x[..., a::2, b::2]`` (RGGB order).
    """
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // 2, 2, w // 2, 2)
    x = torch.movedim(x, (-3, -1), (-4, -3))
    return x.reshape(*lead, 4, h // 2, w // 2)


def unpack(planes: Tensor) -> Tensor:
    """Packed planes ``(..., 4, H/2, W/2)`` -> full-res mosaic ``(..., H, W)``."""
    *lead, four, h2, w2 = planes.shape
    if four != 4:
        raise ValueError(f"expected 4 packed planes, got shape {tuple(planes.shape)}")
    x = planes.reshape(*lead, 2, 2, h2, w2)
    x = torch.movedim(x, (-4, -3), (-3, -1))
    return x.reshape(*lead, h2 * 2, w2 * 2)


def cfa_masks(shape: tuple[int, int], pattern: str = "RGGB") -> np.ndarray:
    """Boolean CFA masks ``(H, W, 3)`` for the given Bayer pattern."""
    pattern = pattern.upper()
    masks = {c: np.zeros(shape, dtype=bool) for c in "RGB"}
    for channel, (y, x) in zip(pattern, BAYER_OFFSETS):
        masks[channel][y::2, x::2] = True
    return np.stack([masks[c] for c in "RGB"], axis=-1)


@functools.lru_cache(maxsize=16)
def _cfa_tensor(shape: tuple[int, int], pattern: str, dtype: torch.dtype,
                device: torch.device) -> Tensor:
    # cached: the solver re-mosaics every iteration, and a fresh host->device
    # copy of the masks each time would stall the stream
    return torch.as_tensor(cfa_masks(shape, pattern), dtype=dtype, device=device)


def mask_like(x: Tensor, shape: tuple[int, ...], pattern: str = "RGGB") -> Tensor:
    """CFA masks ``(H, W, 3)`` for spatial ``shape``, in ``x``'s dtype and device."""
    return _cfa_tensor(tuple(shape), pattern.upper(), x.dtype, x.device)


def mosaic(rgb: Tensor, pattern: str = "RGGB") -> Tensor:
    """RGB ``(..., H, W, 3)`` -> Bayer mosaic ``(..., H, W)`` by CFA subsampling."""
    m = mask_like(rgb, rgb.shape[-3:-1], pattern)
    return torch.sum(rgb * m, dim=-1)


def rggb_subsample(rgb: Tensor) -> Tensor:
    """RGB frames ``(..., H, W, 3)`` -> packed RGGB planes ``(..., 4, H/2, W/2)``
    (the two-stage ADMM's theta-update re-mosaic)."""
    return pack(mosaic(rgb))


def embed_rgb(bayer: Tensor) -> Tensor:
    """Bayer mosaic ``(..., H, W)`` -> sparse RGB ``(..., H, W, 3)`` with each
    sample placed in its CFA color channel and zeros elsewhere."""
    m = mask_like(bayer, bayer.shape[-2:])
    return bayer[..., None] * m
