"""FFDNet, IPOL variant (Tassano et al., IPOL 2019)
(port of ``adaptivepnp_sci_tpu.models.ffdnet_ipol``).

The second FFDNet family of the reference, used by its standalone training
and testing scripts (``packages/ffdnet/models.py:18-105``; checkpoints
``packages/ffdnet/models/net_{rgb,gray}.pth``). Unlike the KAIR variant
(:mod:`.ffdnet`):

* the noise map has C channels and is concatenated *before* the
  space-to-depth features (``functions.py:49-53``);
* a DnCNN body: bias-free convolutions with BatchNorm (Flax's convention,
  momentum 0.9, eps 1e-5) on the middle layers;
* the network predicts the noise: :meth:`FFDNetIPOL.denoise` is
  ``clamp(noisy - out, 0, 1)`` (``test_ffdnet_ipol.py:97-99``).

The layers sit in ``self.layers``, a ``Sequential`` with the reference's
``intermediate_dncnn.itermediate_dncnn`` indices (a conv at 0, then conv, BN,
ReLU triples from 2, the last conv at ``3 nb - 4``), so a reference
checkpoint loads by a prefix change
(:func:`~adaptivepnp_sci_torch.models.convert.load_ffdnet_ipol`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch import Tensor

from adaptivepnp_sci_torch.models.common import (
    FlaxBatchNorm2d,
    depth_to_space,
    space_to_depth,
)


class FFDNetIPOL(nn.Module):
    """The predicted noise of ``(N, H, W, C)`` input at noise level ``sigma``
    (scalar or per-sample ``(N,)``), as the JAX model takes it; NCHW inside.
    H and W must be even."""

    def __init__(self, in_nc: int = 3, nc: int = 96, nb: int = 12):
        super().__init__()
        self.in_nc, self.nc, self.nb = in_nc, nc, nb
        layers: list[nn.Module] = [nn.Conv2d(5 * in_nc, nc, 3, padding=1, bias=False),
                                   nn.ReLU()]
        for _ in range(nb - 2):
            layers += [nn.Conv2d(nc, nc, 3, padding=1, bias=False),
                       FlaxBatchNorm2d(nc, flax_momentum=0.9, eps=1e-5), nn.ReLU()]
        layers.append(nn.Conv2d(nc, 4 * in_nc, 3, padding=1, bias=False))
        self.layers = nn.Sequential(*layers)

    def forward(self, x: Tensor, sigma: Tensor | float) -> Tensor:
        n, h, w, c = x.shape
        if c != self.in_nc:
            raise ValueError(f"expected {self.in_nc} channels, got {tuple(x.shape)}")
        feats = space_to_depth(x.permute(0, 3, 1, 2), 2)
        sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
        noise_map = sigma.reshape(-1, 1, 1, 1).expand(n, c, h // 2, w // 2)
        y = self.layers(torch.cat([noise_map, feats], dim=1))
        return depth_to_space(y, 2).permute(0, 2, 3, 1)

    def denoise(self, noisy: Tensor, sigma: Tensor | float) -> Tensor:
        """``clamp(noisy - predicted_noise, 0, 1)``."""
        return torch.clamp(noisy - self(noisy, sigma), 0.0, 1.0)


def ffdnet_ipol_rgb() -> FFDNetIPOL:
    """The colour config (nc = 96, nb = 12)."""
    return FFDNetIPOL(in_nc=3, nc=96, nb=12)


def ffdnet_ipol_gray() -> FFDNetIPOL:
    """The gray config (nc = 64, nb = 15)."""
    return FFDNetIPOL(in_nc=1, nc=64, nb=15)
