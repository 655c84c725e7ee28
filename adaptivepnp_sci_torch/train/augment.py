"""Training-time augmentation (port of ``adaptivepnp_sci_tpu.train.augment``).

The 8 dihedral modes of the reference's ``data_augmentation``, per sample
(:func:`augment_batch`) or one per batch with the reference's weighted
choice and constant offsets (:func:`normalize_augment`), and the noise draws
of the training tasks.

Every random number comes from an explicit ``torch.Generator``, drawn on the
generator's device and moved to the data's, through one function per kind
of draw (:func:`draw_modes`, :func:`random_sigma`, :func:`draw_noise`,
:func:`draw_choice`, :func:`draw_offsets`): the JAX package draws from its
own PRNG keys, so its numbers differ, and a test that compares the two
replaces these functions with JAX's draws. A CPU generator gives the same
draws whatever device the data is on.

A data-parallel step hands the draws a :class:`ShardedGenerator` (each
rank holding one slice of the global batch): every per-sample draw is then
made for the global batch, in the order one process makes it, and the rank
keeps its slice, so each sample gets the numbers it gets in one process.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch
from torch import Tensor

# 8 dihedral modes, the reference's numbering: 0 identity, 1 flipud, 2 rot90,
# 3 rot90+flipud, 4 rot180, 5 rot180+flipud, 6 rot270, 7 rot270+flipud
_MODES = 8

#: the reference's transform weights: [do_nothing, 7 dihedral modes, add_csnt]
#: (~1/4 chance of identity; ``packages/DDnet/utils.py:73-75``)
_REF_AUG_WEIGHTS = (32.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0)


class ShardedGenerator(NamedTuple):
    """``generator`` drawing for the ``index``-th of ``count`` equal slices of
    the global batch: a per-sample draw for ``n`` samples is made for
    ``n * count`` and the slice kept (:func:`per_sample`)."""

    generator: torch.Generator
    index: int
    count: int

    @property
    def device(self) -> torch.device:
        return self.generator.device


#: what the draw functions take: a generator, or one rank's share of it
Draws = Union[torch.Generator, ShardedGenerator]


def per_sample(generator: Draws, n: int,
               draw: Callable[[torch.Generator, int], Tensor]) -> Tensor:
    """``draw(gen, rows)`` for ``n`` samples: for a :class:`ShardedGenerator`,
    made for the global batch and this rank's slice kept."""
    if not isinstance(generator, ShardedGenerator):
        return draw(generator, n)
    gen, index, count = generator
    return draw(gen, n * count)[index * n:(index + 1) * n]


def apply_mode(img: Tensor, mode: int) -> Tensor:
    """Dihedral transform ``mode`` (0-7) of ``(..., H, W, C)`` over the
    ``(H, W)`` axes, as ``jnp.rot90(x, k, axes=(-3, -2))`` then a flip of
    axis -3 for the odd modes (H == W for the rotations)."""
    out = torch.rot90(img, mode // 2, dims=(-3, -2)) if mode // 2 else img
    return torch.flip(out, dims=(-3,)) if mode % 2 else out


def draw_modes(generator: Draws, n: int) -> Tensor:
    """``n`` dihedral modes, uniform over 0-7 (int64, generator's device)."""
    return per_sample(generator, n, lambda g, rows: torch.randint(
        0, _MODES, (rows,), generator=g, device=g.device))


def augment_batch(generator: Draws, batch: Tensor) -> Tensor:
    """A random dihedral transform per sample of ``(N, ..., H, W, C)``: each
    mode's transform of the whole batch, selected per sample (no host sync)."""
    modes = draw_modes(generator, batch.shape[0]).to(batch.device)
    out = batch
    for m in range(1, _MODES):
        sel = (modes == m).reshape(-1, *([1] * (batch.dim() - 1)))
        out = torch.where(sel, apply_mode(batch, m), out)
    return out


def draw_choice(generator: Draws) -> int:
    """One of :func:`normalize_augment`'s 9 transforms, with the reference's
    weights."""
    if isinstance(generator, ShardedGenerator):  # one draw for the whole batch
        generator = generator.generator
    w = torch.tensor(_REF_AUG_WEIGHTS, dtype=torch.float32, device=generator.device)
    return int(torch.multinomial(w / 148.0, 1, generator=generator))


def draw_offsets(generator: Draws, n: int) -> Tensor:
    """``n`` standard normal draws: ``add_csnt``'s per-sample offsets before
    their ``5/255`` scale."""
    return per_sample(generator, n, lambda g, rows: torch.randn(rows, generator=g,
                                                                device=g.device))


def normalize_augment(generator: Draws, batch: Tensor,
                      ctrl_fr_idx: int | None = None) -> tuple[Tensor, Tensor]:
    """The reference's ``normalize_augment`` (``packages/DDnet/utils.py:
    47-94``): scale a ``(N, F, H, W, C)`` clip batch from [0, 255] to [0, 1],
    apply ONE transform to the whole batch, chosen with the reference's
    weights among the 8 dihedral modes and ``add_csnt`` (a per-sample
    constant offset drawn from N(0, (5/255)^2)); returns ``(augmented,
    centre-frame ground truth)``."""
    img = batch / 255.0
    mode = draw_choice(generator)
    if mode < _MODES:
        out = apply_mode(img, mode)
    else:
        offs = draw_offsets(generator, img.shape[0]).to(device=img.device, dtype=img.dtype)
        out = img + (5.0 / 255.0) * offs.reshape(-1, *([1] * (img.dim() - 1)))
    c = ctrl_fr_idx if ctrl_fr_idx is not None else batch.shape[1] // 2
    return out, out[:, c]


def random_sigma(generator: Draws, n: int, lo: float, hi: float) -> Tensor:
    """Per-sample noise standard deviation, uniform in [lo, hi] (already
    /255-scaled), float32 on the generator's device."""
    u = per_sample(generator, n, lambda g, rows: torch.rand(rows, generator=g, device=g.device))
    return u * (hi - lo) + lo


def draw_noise(generator: Draws, shape: tuple[int, ...]) -> Tensor:
    """Standard normal noise of ``shape`` (float32, generator's device)."""
    return per_sample(generator, shape[0], lambda g, rows: torch.randn(
        (rows, *shape[1:]), generator=g, device=g.device))


def add_gaussian_noise(generator: Draws, x: Tensor, sigma: Tensor) -> Tensor:
    """``x`` plus N(0, sigma^2) noise; ``sigma`` broadcasts per leading sample."""
    sig = torch.as_tensor(sigma, device=x.device).reshape(-1, *([1] * (x.dim() - 1)))
    return x + sig * draw_noise(generator, tuple(x.shape)).to(device=x.device, dtype=x.dtype)
