"""FFDNet (Zhang, Zuo & Zhang, IEEE TIP 2018), plain PyTorch forward on a
state dict.

Replicate-pad to even size, pixel-unshuffle by 2, append the noise-level map
as the last channel, ``nb`` 3x3 convolutions with ReLU between them,
pixel-shuffle, crop. Weights are the KAIR layout ``model.{2i}.weight`` /
``model.{2i}.bias``. Float32; TF32 by the precision (``float32``: off).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import Tensor

from pnpbench.reference import precision as prec


def forward(params: Mapping[str, Tensor], x: Tensor, sigma: Tensor, nb: int,
            precision: str = "float32") -> Tensor:
    """Denoise ``x (N, H, W, C)`` at noise level ``sigma`` (0-d or ``(N,)``)."""
    if prec.check(precision) not in ("float32", "tf32"):
        raise ValueError(f"FFDNet runs in float32 or tf32, not {precision!r}")
    h, w = x.shape[1], x.shape[2]
    v = x.permute(0, 3, 1, 2)
    ph, pw = h % 2, w % 2
    if ph or pw:
        v = F.pad(v, (0, pw, 0, ph), mode="replicate")
    v = F.pixel_unshuffle(v, 2)
    s = torch.as_tensor(sigma, dtype=v.dtype, device=v.device)
    v = torch.cat([v, s.reshape(-1, 1, 1, 1).expand(v.shape[0], 1, v.shape[2], v.shape[3])], 1)
    with prec.tf32(precision == "tf32"):
        for i in range(nb):
            v = F.conv2d(v, params[f"model.{2 * i}.weight"], params[f"model.{2 * i}.bias"],
                         padding=1)
            if i < nb - 1:
                v = F.relu(v)
    v = F.pixel_shuffle(v, 2)
    return v[:, :, :h, :w].permute(0, 2, 3, 1)
