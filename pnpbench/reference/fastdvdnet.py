"""FastDVDnet (Tassano, Delon & Veit, CVPR 2020), plain PyTorch forward on a
state dict, in a low precision.

Two cascaded U-Net blocks (``temp1``, ``temp2``), each over frame triplets
with the noise map interleaved: a grouped input conv (3 x 30 channels), a
fusion conv to 32, two stride-2 downs to 64 and 128, each followed by a
CvBlock (two 3x3 conv + BatchNorm + ReLU), pixel-shuffle ups, an output
block, and the residual from the centre frame in float32. BatchNorm is in
eval mode, folded to a float32 scale and shift.

Numbers follow the low-precision mode of the measured configuration: every
activation and weight is rounded to the working format
(:func:`~pnpbench.reference.precision.lowp`), each convolution sums exact
products in float32 and rounds its result once, each BatchNorm + ReLU is
taken in float32 and rounded. Names are the published model's
``convblock`` indices.

:func:`seq_circular` denoises a circular sequence of B frames: ``temp1`` once
per triplet ``(f-1, f, f+1) mod B``, then ``temp2`` over triplets of its
outputs.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import Tensor

from pnpbench.reference import precision as prec

BN_EPS = 1e-5


class _Net:
    def __init__(self, params: Mapping[str, Tensor], precision: str):
        if prec.check(precision) not in ("bfloat16", "fp8"):
            raise ValueError(f"this FastDVDnet runs in bfloat16 or fp8, not {precision!r}")
        self.p = params
        self.precision = precision

    def round(self, t: Tensor) -> Tensor:
        return prec.lowp(t, self.precision)

    def conv(self, x: Tensor, name: str, stride: int = 1, groups: int = 1) -> Tensor:
        w = self.round(self.p[f"{name}.weight"])
        if x.device.type == "cpu":  # the CPU has no fast bf16 convolution: same sums in float32
            out = F.conv2d(x.float(), w.float(), None, stride, 1, 1, groups)
        else:
            out = F.conv2d(x, w, None, stride, 1, 1, groups)
        return self.round(out)

    def bn_relu(self, x: Tensor, name: str) -> Tensor:
        p = self.p
        s = p[f"{name}.weight"].float() * torch.rsqrt(p[f"{name}.running_var"].float() + BN_EPS)
        b = p[f"{name}.bias"].float() - p[f"{name}.running_mean"].float() * s
        return self.round(torch.relu(x.float() * s.reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1)))

    def add(self, a: Tensor, b: Tensor) -> Tensor:
        return self.round(a.float() + b.float())

    def cv(self, x: Tensor, name: str) -> Tensor:
        x = self.bn_relu(self.conv(x, f"{name}.convblock.0"), f"{name}.convblock.1")
        return self.bn_relu(self.conv(x, f"{name}.convblock.3"), f"{name}.convblock.4")

    def denblock(self, t: str, in0: Tensor, in1: Tensor, in2: Tensor, nm: Tensor) -> Tensor:
        x = self.round(torch.cat([in0, nm, in1, nm, in2, nm], dim=1))
        x0 = self.bn_relu(self.conv(x, f"{t}.inc.convblock.0", groups=3), f"{t}.inc.convblock.1")
        x0 = self.bn_relu(self.conv(x0, f"{t}.inc.convblock.3"), f"{t}.inc.convblock.4")
        x1 = self.bn_relu(self.conv(x0, f"{t}.downc0.convblock.0", stride=2),
                          f"{t}.downc0.convblock.1")
        x1 = self.cv(x1, f"{t}.downc0.convblock.3")
        x2 = self.bn_relu(self.conv(x1, f"{t}.downc1.convblock.0", stride=2),
                          f"{t}.downc1.convblock.1")
        x2 = self.cv(x2, f"{t}.downc1.convblock.3")
        x2 = self.cv(x2, f"{t}.upc2.convblock.0")
        x2 = F.pixel_shuffle(self.conv(x2, f"{t}.upc2.convblock.1"), 2)
        x1 = self.cv(self.add(x1, x2), f"{t}.upc1.convblock.0")
        x1 = F.pixel_shuffle(self.conv(x1, f"{t}.upc1.convblock.1"), 2)
        x = self.bn_relu(self.conv(self.add(x0, x1), f"{t}.outc.convblock.0"),
                         f"{t}.outc.convblock.1")
        x = self.conv(x, f"{t}.outc.convblock.3")
        return in1.float() - x.float()


def seq_circular(params: Mapping[str, Tensor], frames: Tensor, sigma: Tensor,
                 precision: str = "bfloat16") -> Tensor:
    """Denoise a circular sequence ``(B, H, W, 3) -> (B, H, W, 3)`` (float32
    in and out) at noise level ``sigma`` (0-d)."""
    net = _Net(params, precision)
    x = frames.float().permute(0, 3, 1, 2)
    n, _, h, w = x.shape
    nm = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).reshape(-1, 1, 1, 1)
    nm = nm.expand(n, 1, h, w)
    t1 = net.denblock("temp1", torch.roll(x, 1, 0), x, torch.roll(x, -1, 0), nm)
    out = net.denblock("temp2", torch.roll(t1, 1, 0), t1, torch.roll(t1, -1, 0), nm)
    return out.permute(0, 2, 3, 1)
