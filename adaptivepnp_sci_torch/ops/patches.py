"""Patch cropping and stitching for large scenes
(port of ``adaptivepnp_sci_tpu.ops.patches``).

Non-overlapping tiles are one reshape, overlapping windows one ``unfold``
view; neither loops over patches. The layout is the JAX package's:
``(..., H, W, C)`` images and ``(N, ..., p, p, C)`` patches, the patch axis
leading so the tiled solver runs it as its item axis.
"""

from __future__ import annotations

import torch
from torch import Tensor


def crop_patches(x: Tensor, patch: int) -> tuple[Tensor, tuple[int, int]]:
    """Non-overlapping tiles: ``(..., H, W, C) -> (Py*Px, ..., p, p, C)``.

    H and W must be multiples of ``patch``. Returns the tiles and the
    ``(Py, Px)`` grid for :func:`stitch_patches`."""
    *lead, h, w, c = x.shape
    py, px = h // patch, w // patch
    t = x.reshape(*lead, py, patch, px, patch, c)
    t = torch.movedim(t, (-5, -3), (0, 1))        # (py, px, ..., p, p, c)
    return t.reshape(py * px, *lead, patch, patch, c), (py, px)


def stitch_patches(tiles: Tensor, grid: tuple[int, int]) -> Tensor:
    """Inverse of :func:`crop_patches`."""
    py, px = grid
    _, *lead, p, p2, c = tiles.shape
    t = tiles.reshape(py, px, *lead, p, p2, c)
    t = torch.movedim(t, (0, 1), (-5, -3))
    return t.reshape(*lead, py * p, px * p2, c)


def _windows(x: Tensor, size: int, stride: int) -> Tensor:
    """Every ``size x size`` window of ``(..., H, W, C)`` at ``stride``:
    ``(Py*Px, ..., size, size, C)``, row-major over the window grid."""
    t = x.unfold(-3, size, stride).unfold(-3, size, stride)  # (..., Py, Px, C, s, s)
    t = torch.movedim(t, (-5, -4), (0, 1))                    # (Py, Px, ..., C, s, s)
    t = torch.movedim(t, -3, -1)                              # (Py, Px, ..., s, s, C)
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def crop_overlapping(x: Tensor, patch: int, halo: int) -> tuple[Tensor, tuple[int, int]]:
    """Overlapping halo windows: ``(..., H, W, C) -> (Py*Px, ..., p+2h, p+2h, C)``.

    ``x`` must already be padded by ``halo`` on each side (``H = Py*patch +
    2*halo``); window ``i`` is core tile ``i`` with ``halo`` pixels of context
    on every side. The cores (``[halo:halo+patch]`` of each window) tile the
    unpadded image: stitch with
    ``stitch_patches(windows[..., halo:halo+patch, halo:halo+patch, :], grid)``."""
    h, w = x.shape[-3], x.shape[-2]
    grid = ((h - 2 * halo) // patch, (w - 2 * halo) // patch)
    win = patch + 2 * halo
    # unfold keeps every window that fits; a padded size past the grid's
    # last core would add one, so crop to exactly the grid first
    x = x[..., : grid[0] * patch + 2 * halo, : grid[1] * patch + 2 * halo, :]
    return _windows(x, win, patch), grid


def strided_patches(x: Tensor, patch: int, stride: int) -> Tensor:
    """Overlapping patches of one image ``(H, W, C) -> (N, p, p, C)``."""
    return _windows(x, patch, stride)


def random_crop(generator: torch.Generator, x: Tensor, size: int) -> Tensor:
    """Random square crop of ``(..., H, W, C)``, its corner drawn uniformly
    from ``generator`` (the JAX package draws it from a PRNG key)."""
    h, w = x.shape[-3], x.shape[-2]
    y0 = int(torch.randint(0, h - size + 1, (), generator=generator))
    x0 = int(torch.randint(0, w - size + 1, (), generator=generator))
    return x[..., y0:y0 + size, x0:x0 + size, :]
