"""FFDNet denoiser (Zhang, Zuo & Zhang, TIP 2018)
(port of ``adaptivepnp_sci_tpu.models.ffdnet``).

Replication-pad to even size -> pixel-unshuffle(2) -> append the sigma map
as the last channel -> ``nb`` 3x3 convs with ReLU between -> pixel-shuffle(2)
-> crop. The layers sit in ``self.model`` as a ``Sequential`` with the ReLUs
at odd indices, the KAIR layout, so a KAIR checkpoint's state dict loads as
it is (:func:`adaptivepnp_sci_torch.models.convert.load_ffdnet`) and Flax
variables load through :func:`~adaptivepnp_sci_torch.models.convert.ffdnet_from_flax`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch import Tensor

from adaptivepnp_sci_torch.models.common import (
    depth_to_space,
    replication_pad_to_even,
    space_to_depth,
)


class FFDNet(nn.Module):
    """sigma-conditioned CNN denoiser. Input ``(N, H, W, C)`` in [0, 1], as
    the JAX model takes it; NCHW inside."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nc: int = 96, nb: int = 12):
        super().__init__()
        self.in_nc, self.out_nc, self.nc, self.nb = in_nc, out_nc, nc, nb
        layers: list[nn.Module] = [nn.Conv2d(in_nc * 4 + 1, nc, 3, padding=1), nn.ReLU()]
        for _ in range(nb - 2):
            layers += [nn.Conv2d(nc, nc, 3, padding=1), nn.ReLU()]
        layers.append(nn.Conv2d(nc, out_nc * 4, 3, padding=1))
        self.model = nn.Sequential(*layers)

    def forward(self, x: Tensor, sigma: Tensor | float) -> Tensor:
        """Denoise ``x`` at noise level ``sigma`` (scalar or per-sample (N,))."""
        h, w = x.shape[1], x.shape[2]
        x, _, _ = replication_pad_to_even(x.permute(0, 3, 1, 2))
        x = space_to_depth(x, 2)
        sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
        smap = sigma.reshape(-1, 1, 1, 1).expand(x.shape[0], 1, x.shape[2], x.shape[3])
        x = self.model(torch.cat([x, smap], dim=1))
        x = depth_to_space(x, 2)
        return x[:, :, :h, :w].permute(0, 2, 3, 1)


def ffdnet_color() -> FFDNet:
    """The color config of the flagship path (nc = 96, nb = 12)."""
    return FFDNet(in_nc=3, out_nc=3, nc=96, nb=12)
