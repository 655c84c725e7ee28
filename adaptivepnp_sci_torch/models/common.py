"""Shared model building blocks (port of ``adaptivepnp_sci_tpu.models.common``).

The JAX package works in NHWC; these take NCHW, PyTorch's layout.
``space_to_depth`` / ``depth_to_space`` are ``F.pixel_unshuffle`` /
``F.pixel_shuffle``: output channel ``c*r*r + i*r + j`` holds input pixel
offset ``(i, j)`` of channel ``c``, the ordering of the JAX helpers.
``upsample_bilinear_align_corners`` is ``nn.UpsamplingBilinear2d``'s
arithmetic, which the JAX helper spells out by hand. :class:`FlaxBatchNorm2d`
is the one BatchNorm of the port's models: Flax's ``nn.BatchNorm`` in train
mode (over the global batch of several ranks with :func:`sync_batch_stats`),
``nn.BatchNorm2d`` in eval mode.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode is Flax's
    ``nn.BatchNorm(momentum=flax_momentum, epsilon=eps)``: the batch
    statistics in float32, the variance biased and computed as
    ``E[x^2] - E[x]^2`` (clipped at 0), the output
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``, and the running
    statistics moved as ``m * running + (1 - m) * batch`` with the biased
    variance (PyTorch's own feeds them the unbiased one, and its ``momentum``
    is ``1 - m``). ``affine=False`` is Flax's ``use_scale=use_bias=False``.
    Eval mode, the parameters and the buffers are ``nn.BatchNorm2d``'s.

    ``update_stats`` False (:func:`frozen_batch_stats`) normalises by the
    batch statistics without moving the running ones.

    ``stats_reduce`` (:func:`sync_batch_stats`; None: off) is the
    data-parallel mode: it maps this rank's ``(2, C)`` stack of ``E[x]`` and
    ``E[x^2]`` to those of the global batch (a differentiable all-reduce
    mean over the ranks), so train mode normalises by, and moves the
    running statistics with, the global batch's statistics, as the JAX
    package's sharded batch does."""

    update_stats = True
    stats_reduce: Callable[[Tensor], Tensor] | None = None

    def __init__(self, num_features: int, flax_momentum: float = 0.9, eps: float = 1e-5,
                 affine: bool = True):
        super().__init__(num_features, eps=eps, momentum=1.0 - flax_momentum, affine=affine)
        self.flax_momentum = flax_momentum

    def forward(self, x: Tensor) -> Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        sq = (xf * xf).mean(dim=(0, 2, 3))
        if self.stats_reduce is not None:
            mean, sq = self.stats_reduce(torch.stack([mean, sq])).unbind(0)
        var = torch.clamp(sq - mean * mean, min=0.0)
        if self.update_stats:
            m = self.flax_momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
                self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None]
        if self.bias is not None:
            y = y + self.bias[None, :, None, None]
        return y.to(x.dtype)


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module) -> Iterator[None]:
    """Train-mode BatchNorm inside ``module`` leaves its running statistics as
    they are for the duration (a second forward whose statistics the JAX
    package discards, or a recomputation in the backward pass)."""
    bns = [m for m in module.modules() if isinstance(m, FlaxBatchNorm2d)]
    before = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, flag in zip(bns, before):
            m.update_stats = flag


def sync_batch_stats(module: nn.Module, reduce: Callable[[Tensor], Tensor] | None) -> None:
    """Put every :class:`FlaxBatchNorm2d` of ``module`` in data-parallel mode
    with ``reduce`` (the global mean of a rank's statistics), or back to
    per-rank statistics with None."""
    for m in module.modules():
        if isinstance(m, FlaxBatchNorm2d):
            m.stats_reduce = reduce


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
