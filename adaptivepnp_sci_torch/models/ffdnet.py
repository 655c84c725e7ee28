"""FFDNet denoiser (Zhang, Zuo & Zhang, TIP 2018)
(port of ``adaptivepnp_sci_tpu.models.ffdnet``).

Replication-pad to even size -> pixel-unshuffle(2) -> append the sigma map
as the last channel -> ``nb`` 3x3 convs with ReLU between -> pixel-shuffle(2)
-> crop. The layers sit in ``self.model`` as a ``Sequential`` with the ReLUs
at odd indices, the KAIR layout, so a KAIR checkpoint's state dict loads as
it is (:func:`adaptivepnp_sci_torch.models.convert.load_ffdnet`) and Flax
variables load through :func:`~adaptivepnp_sci_torch.models.convert.ffdnet_from_flax`.

``dtype`` and ``interior_dtype`` follow the JAX model's cast points: the
input with its sigma map is cast to ``dtype``, the first conv runs at
``dtype`` and its ReLU's output is cast to ``interior_dtype or dtype``, the
``nb - 2`` interior convs run at that type, the last conv's input is cast
back to ``dtype``, and the output returns to float32 before depth-to-space.
A bf16 conv sums exact products in float32 and rounds once
(:func:`adaptivepnp_sci_torch.ops.convpair.conv2d_lowp`), and its bias is
added in bf16, as Flax's ``nn.Conv(dtype=bfloat16)`` does. Parameters stay
float32: the type is a cast at apply time, not a weight format, so one
state dict serves every mode and gradients reach float32 parameters.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from adaptivepnp_sci_torch.models.common import (
    depth_to_space,
    replication_pad_to_even,
    space_to_depth,
)
from adaptivepnp_sci_torch.ops.convpair import conv2d_lowp


def _conv_at(x: Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> Tensor:
    """``conv`` on ``x`` (already of ``dtype``) at ``dtype``."""
    if dtype == torch.float32:
        return conv(x)
    return conv2d_lowp(x, conv.weight) + conv.bias.to(dtype).reshape(1, -1, 1, 1)


class FFDNet(nn.Module):
    """sigma-conditioned CNN denoiser. Input ``(N, H, W, C)`` in [0, 1], as
    the JAX model takes it; NCHW inside."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nc: int = 96, nb: int = 12,
                 dtype: torch.dtype = torch.float32, interior_dtype: torch.dtype | None = None):
        super().__init__()
        self.in_nc, self.out_nc, self.nc, self.nb = in_nc, out_nc, nc, nb
        self.dtype, self.interior_dtype = dtype, interior_dtype
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
        x = torch.cat([x, smap], dim=1).to(self.dtype)
        idt = self.interior_dtype or self.dtype
        convs = list(self.model)[0::2]
        x = F.relu(_conv_at(x, convs[0], self.dtype)).to(idt)
        for conv in convs[1:-1]:
            x = F.relu(_conv_at(x, conv, idt))
        x = _conv_at(x.to(self.dtype), convs[-1], self.dtype)
        x = depth_to_space(x.float(), 2)
        return x[:, :, :h, :w].permute(0, 2, 3, 1)


def ffdnet_color(**kw) -> FFDNet:
    """The color config of the flagship path (nc = 96, nb = 12); ``kw``:
    ``dtype`` / ``interior_dtype``."""
    return FFDNet(in_nc=3, out_nc=3, nc=96, nb=12, **kw)


def ffdnet_gray() -> FFDNet:
    """The gray config (nc = 64, nb = 15), for the grayscale solver."""
    return FFDNet(in_nc=1, out_nc=1, nc=64, nb=15)
