"""DDnet, the dual-branch deep demosaicker (Wu, Yang, Su & Yuan, Adaptive
Deep PnP Algorithm for Video Snapshot Compressive Imaging, IJCV 2023;
``models/network_demosaicking.py:377-463`` of xyvirtualgroup/AdaptivePnP_SCI),
plain PyTorch forward on a state dict, in float32 or a low precision.

DDnet demosaics and denoises the centre frame of a window of five Bayer
frames, each given as sparse RGB (its value in its colour-filter channel,
zeros elsewhere). Base width 20: U-Net channels 20, 40 and 80, no
BatchNorm, bias-free 3x3 convolutions.

* Branch 1: the frames summed to 1-channel mosaics, frame ``t`` scaled by
  ``weight_tensor_in[3j + i]`` in its place ``i`` of triplet ``j``, go
  through the U-Net ``temp1`` on each of the three triplets ``(j, j+1,
  j+2)``; the centre frame (1 channel, broadcast to 3) is added back.
* Branch 2: the mosaics packed to 4-channel half-resolution RGGB planes,
  scaled by ``weight_tensor_in2``, go through the U-Net ``temp11`` on each
  triplet with the centre planes added back, a bilinear 2x upsample
  (``align_corners=True``) and the 4 -> 3 ``fusion`` block (conv, ReLU,
  conv).
* ``temp2``, one U-Net shared by both branches, fuses each branch's three
  triplet outputs (residual from the centre one); the branches mix as
  ``weight_tensor_out[0] * branch1 + weight_tensor_out[1] * branch2``.

Each U-Net (a ``DenBlock``): a grouped input conv (3 groups, 30 channels a
frame), a fusion conv to 20, two stride-2 downs (conv, ReLU, then two
conv + ReLU), pixel-shuffle ups (two conv + ReLU, a conv to 4x the
channels, the shuffle), the skip additions, an output block (conv, ReLU,
conv). Names are the published model's state-dict keys.

Departures from the published forward, each exact or the measured
configuration's: the unused noise-map ``inc`` blocks of the published
checkpoint are not part of the state dict; each DenBlock is called once a
triplet, as published (the measured program batches the three calls, which
gives the same sums without BatchNorm). In a low precision the values follow
the measured configuration's cast points: each U-Net rounds its input, every
weight and every convolution's result to the working format
(:func:`~pnpbench.reference.precision.lowp`; products summed in float32), a
skip addition is rounded once, the residuals, the upsample and the branch
mixing are float32, the fusion block's input is rounded and its result taken
back to float32.

:func:`demosaic` is the solver's step: Bayer mosaics ``(B, H, W)`` to RGB
``(B, H, W, 3)`` by DDnet over the circular windows ``(f-2 .. f+2) mod B``,
H and W reflect-padded up to multiples of 4 and cropped back.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from pnpbench.reference import precision as prec

#: DDnet's base width and its U-Net channels
BASE = 20
CHANNELS = (BASE, 2 * BASE, 4 * BASE)
WINDOW = 5
#: RGGB offsets of the packed planes [R, G1, G2, B], and each one's colour
BAYER = ((0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 2))


class _Net:
    def __init__(self, params: Mapping[str, Tensor], precision: str):
        self.p = params
        self.precision = prec.check(precision)
        self.lowp = precision in ("bfloat16", "fp8")

    def round(self, t: Tensor) -> Tensor:
        return prec.lowp(t, self.precision) if self.lowp else t.float()

    def conv(self, x: Tensor, name: str, stride: int = 1, groups: int = 1) -> Tensor:
        w = self.round(self.p[f"{name}.weight"])
        if self.lowp and x.device.type != "cpu":
            out = F.conv2d(x, w, None, stride, 1, 1, groups)
        else:  # float32, TF32 as the precision says; a low precision's sums on the CPU
            with prec.tf32(self.precision == "tf32"):
                out = F.conv2d(x.float(), w.float(), None, stride, 1, 1, groups)
        return self.round(out)

    def conv_relu(self, x: Tensor, name: str, stride: int = 1, groups: int = 1) -> Tensor:
        return torch.relu(self.conv(x, name, stride, groups))

    def cv(self, x: Tensor, name: str) -> Tensor:
        return self.conv_relu(self.conv_relu(x, f"{name}.convblock.0"), f"{name}.convblock.2")

    def add(self, a: Tensor, b: Tensor) -> Tensor:
        return self.round(a.float() + b.float())

    def unet(self, t: str, in0: Tensor, in1: Tensor, in2: Tensor) -> Tensor:
        """``temp1``, ``temp11`` or ``temp2`` on one triplet of NCHW frames
        (float32), with the centre frame's residual; float32 out."""
        x = self.round(torch.cat([in0, in1, in2], dim=1))
        x0 = self.conv_relu(x, f"{t}.inc_1.convblock.0", groups=3)
        x0 = self.conv_relu(x0, f"{t}.inc_1.convblock.2")
        x1 = self.conv_relu(x0, f"{t}.downc0.convblock.0", stride=2)
        x1 = self.cv(x1, f"{t}.downc0.convblock.2")
        x2 = self.conv_relu(x1, f"{t}.downc1.convblock.0", stride=2)
        x2 = self.cv(x2, f"{t}.downc1.convblock.2")
        x2 = self.cv(x2, f"{t}.upc2.convblock.0")
        x2 = F.pixel_shuffle(self.conv(x2, f"{t}.upc2.convblock.1"), 2)
        x1 = self.cv(self.add(x1, x2), f"{t}.upc1.convblock.0")
        x1 = F.pixel_shuffle(self.conv(x1, f"{t}.upc1.convblock.1"), 2)
        x = self.conv_relu(self.add(x0, x1), f"{t}.outc.convblock.0")
        return in1.float() + self.conv(x, f"{t}.outc.convblock.2").float()

    def fusion(self, x: Tensor) -> Tensor:
        x = self.conv_relu(self.round(x), "temp11.fusion.convblock.0")
        return self.conv(x, "temp11.fusion.convblock.2").float()


def pack(mosaic: Tensor) -> Tensor:
    """``(N, H, W)`` -> RGGB planes ``(N, 4, H/2, W/2)``."""
    return torch.stack([mosaic[:, dy::2, dx::2] for dy, dx, _ in BAYER], dim=1)


def forward(params: Mapping[str, Tensor], windows: Tensor, precision: str = "float32"
            ) -> Tensor:
    """DDnet on ``windows (N, 5, H, W, 3)`` (sparse RGB, H and W multiples of
    4) -> the centre frames ``(N, H, W, 3)``, float32."""
    net = _Net(params, precision)
    p = params
    a, a2, a3 = p["weight_tensor_in"], p["weight_tensor_in2"], p["weight_tensor_out"]
    mosaics = windows.float().sum(-1)                          # (N, 5, H, W)
    ones = [mosaics[:, t, None] for t in range(WINDOW)]        # (N, 1, H, W)
    fours = [pack(mosaics[:, t]) for t in range(WINDOW)]       # (N, 4, H/2, W/2)
    b1, b2 = [], []
    for j in range(3):
        t1 = [ones[j + i] * a[3 * j + i] for i in range(3)]
        b1.append(net.unet("temp1", *t1))
        t11 = [fours[j + i] * a2[3 * j + i] for i in range(3)]
        up = F.interpolate(net.unet("temp11", *t11), scale_factor=2, mode="bilinear",
                           align_corners=True)
        b2.append(net.fusion(up))
    out1 = net.unet("temp2", *b1)
    out2 = net.unet("temp2", *b2)
    return (a3[0] * out1 + a3[1] * out2).permute(0, 2, 3, 1)


def sparse_rgb(mosaic: Tensor) -> Tensor:
    """Bayer mosaics ``(B, H, W)`` -> sparse RGB ``(B, H, W, 3)``."""
    out = torch.zeros(*mosaic.shape, 3, dtype=mosaic.dtype, device=mosaic.device)
    for dy, dx, c in BAYER:
        out[:, dy::2, dx::2, c] = mosaic[:, dy::2, dx::2]
    return out


def demosaic(params: Mapping[str, Tensor], mosaic: Tensor, precision: str = "float32"
             ) -> Tensor:
    """The solver's demosaic step: ``(B, H, W) -> (B, H, W, 3)`` by DDnet on
    every frame's circular window of five."""
    b, h, w = mosaic.shape
    rgb = sparse_rgb(mosaic.float()).permute(0, 3, 1, 2)
    hp, wp = (-h) % 4, (-w) % 4
    if hp or wp:
        rgb = F.pad(rgb, (0, wp, 0, hp), mode="reflect")
    rgb = rgb.permute(0, 2, 3, 1)
    idx = (torch.arange(b)[:, None] + torch.arange(WINDOW)[None, :] - WINDOW // 2) % b
    return forward(params, rgb[idx.to(rgb.device)], precision)[:, :h, :w]


# --------------------------------------------------------------- weights

_SUB = {"conv0": "0", "conv1": "2"}


def _key(path: list[str]) -> str:
    """A Flax path of DDnet's ``params`` (``temp, block, [cvblock,] conv,
    kernel``) -> the published state-dict key of its weight."""
    temp, block, *rest, _ = path
    if rest[0] == "cvblock":  # the CvBlock inside a down (index 2) or an up (index 0) block
        outer = "2" if block.startswith("downc") else "0"
        return f"{temp}.{block}.convblock.{outer}.convblock.{_SUB[rest[1]]}.weight"
    if block.startswith("upc"):  # the conv before the pixel shuffle
        return f"{temp}.{block}.convblock.1.weight"
    return f"{temp}.{block}.convblock.{_SUB[rest[0]]}.weight"


def state_dict_from_npz(path: str, device: torch.device | str) -> dict[str, Tensor]:
    """DDnet's state dict from a ``/``-keyed ``.npz`` of Flax variables:
    kernels ``(kh, kw, I, O)`` become ``(O, I, kh, kw)``; the three
    ``weight_tensor_*`` keep their broadcast shapes."""
    sd: dict[str, Tensor] = {}
    with np.load(path) as z:
        for name in z.files:
            scope, *path_ = name.split("/")
            if scope != "params":
                raise ValueError(f"{path}: DDnet has no {scope!r} collection")
            val = np.asarray(z[name], np.float32)
            if len(path_) == 1:
                sd[path_[0]] = torch.from_numpy(val.copy())
            else:
                sd[_key(path_)] = torch.from_numpy(
                    np.ascontiguousarray(np.transpose(val, (3, 2, 0, 1))))
    return {k: v.to(device) for k, v in sd.items()}
