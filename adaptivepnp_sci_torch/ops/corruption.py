"""Input-corruption augmentation (port of ``adaptivepnp_sci_tpu.ops.corruption``).

The reference's ``gen_masked_data`` / ``mask_sequence``
(``utils/utils_image.py:17-87``): spatial, temporal or block dropout of the
frames of ``(N, F, H, W, C)`` windows, dropped pixels set to 1e-6 (the
reference's ``zero``), optionally applied to the FastDVDnet adaptation input
(``packages/fastdvdnet/test_fastdvdnet.py:360-361``).

The dropped sites come from :func:`drop_mask`, drawn from an explicit
``torch.Generator`` on its own device: the JAX package draws them from its
PRNG keys, so the masks differ, and tests replace this one function with
JAX's masks.
"""

from __future__ import annotations

import torch
from torch import Tensor

_ZERO = 1e-6


def drop_mask(generator: torch.Generator, shape: tuple[int, ...], ratio: float) -> Tensor:
    """Sites to drop: each True with probability ``ratio`` (bool, generator's
    device)."""
    return torch.rand(shape, generator=generator, device=generator.device) < ratio


def mask_spatial(generator: torch.Generator, x: Tensor, ratio: float = 0.1) -> Tensor:
    """Drop a ``ratio`` fraction of the centre frame's pixels (all channels)."""
    n, f, h, w, c = x.shape
    drop = drop_mask(generator, (h, w), ratio).to(x.device)
    out = x.clone()
    out[:, f // 2] = torch.where(drop[..., None], _ZERO, x[:, f // 2])
    return out


def mask_temporal(x: Tensor) -> Tensor:
    """Drop the whole centre frame."""
    out = x.clone()
    out[:, x.shape[1] // 2] = _ZERO
    return out


def mask_block(generator: torch.Generator, x: Tensor, ratio: float = 0.1) -> Tensor:
    """Drop random (frame, pixel) sites across the window."""
    n, f, h, w, c = x.shape
    drop = drop_mask(generator, (f, h, w), ratio).to(x.device)
    return torch.where(drop[None, :, :, :, None], _ZERO, x)


def mask_window(generator: torch.Generator | None, x: Tensor, mode: str,
                ratio: float = 0.1) -> Tensor:
    """One corruption ``mode`` (``'s'`` spatial, ``'t'`` temporal, ``'b'``
    block) of ``x``; the temporal mode draws nothing."""
    if mode == "t":
        return mask_temporal(x)
    if mode not in ("s", "b"):
        raise ValueError(f"unknown corruption mode {mode!r}")
    if generator is None:
        raise ValueError(f"corruption mode {mode!r} needs a torch.Generator")
    return (mask_spatial if mode == "s" else mask_block)(generator, x, ratio)


def mask_sequence(generator: torch.Generator, x: Tensor, modes: tuple[str, ...] = ("s",),
                  ratio: float = 0.1) -> tuple[Tensor, ...]:
    """One corrupted copy of ``x`` per mode, the masks drawn in turn."""
    return tuple(mask_window(generator, x, mode, ratio) for mode in modes)
