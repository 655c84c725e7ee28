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
"""

from __future__ import annotations

import torch
from torch import Tensor

# 8 dihedral modes, the reference's numbering: 0 identity, 1 flipud, 2 rot90,
# 3 rot90+flipud, 4 rot180, 5 rot180+flipud, 6 rot270, 7 rot270+flipud
_MODES = 8

#: the reference's transform weights: [do_nothing, 7 dihedral modes, add_csnt]
#: (~1/4 chance of identity; ``packages/DDnet/utils.py:73-75``)
_REF_AUG_WEIGHTS = (32.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0)


def apply_mode(img: Tensor, mode: int) -> Tensor:
    """Dihedral transform ``mode`` (0-7) of ``(..., H, W, C)`` over the
    ``(H, W)`` axes, as ``jnp.rot90(x, k, axes=(-3, -2))`` then a flip of
    axis -3 for the odd modes (H == W for the rotations)."""
    out = torch.rot90(img, mode // 2, dims=(-3, -2)) if mode // 2 else img
    return torch.flip(out, dims=(-3,)) if mode % 2 else out


def draw_modes(generator: torch.Generator, n: int) -> Tensor:
    """``n`` dihedral modes, uniform over 0-7 (int64, generator's device)."""
    return torch.randint(0, _MODES, (n,), generator=generator, device=generator.device)


def augment_batch(generator: torch.Generator, batch: Tensor) -> Tensor:
    """A random dihedral transform per sample of ``(N, ..., H, W, C)``: each
    mode's transform of the whole batch, selected per sample (no host sync)."""
    modes = draw_modes(generator, batch.shape[0]).to(batch.device)
    out = batch
    for m in range(1, _MODES):
        sel = (modes == m).reshape(-1, *([1] * (batch.dim() - 1)))
        out = torch.where(sel, apply_mode(batch, m), out)
    return out


def draw_choice(generator: torch.Generator) -> int:
    """One of :func:`normalize_augment`'s 9 transforms, with the reference's
    weights."""
    w = torch.tensor(_REF_AUG_WEIGHTS, dtype=torch.float32, device=generator.device)
    return int(torch.multinomial(w / 148.0, 1, generator=generator))


def draw_offsets(generator: torch.Generator, n: int) -> Tensor:
    """``n`` standard normal draws: ``add_csnt``'s per-sample offsets before
    their ``5/255`` scale."""
    return torch.randn(n, generator=generator, device=generator.device)


def normalize_augment(generator: torch.Generator, batch: Tensor,
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


def random_sigma(generator: torch.Generator, n: int, lo: float, hi: float) -> Tensor:
    """Per-sample noise standard deviation, uniform in [lo, hi] (already
    /255-scaled), float32 on the generator's device."""
    u = torch.rand(n, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def draw_noise(generator: torch.Generator, shape: tuple[int, ...]) -> Tensor:
    """Standard normal noise of ``shape`` (float32, generator's device)."""
    return torch.randn(shape, generator=generator, device=generator.device)


def add_gaussian_noise(generator: torch.Generator, x: Tensor, sigma: Tensor) -> Tensor:
    """``x`` plus N(0, sigma^2) noise; ``sigma`` broadcasts per leading sample."""
    sig = torch.as_tensor(sigma, device=x.device).reshape(-1, *([1] * (x.dim() - 1)))
    return x + sig * draw_noise(generator, tuple(x.shape)).to(device=x.device, dtype=x.dtype)
