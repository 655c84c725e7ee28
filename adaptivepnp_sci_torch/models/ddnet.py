"""DDnet joint demosaicking and denoising network
(port of ``adaptivepnp_sci_tpu.models.ddnet``).

The dual-branch variant with base width 20 (channels 20/40/80), no
BatchNorm, bias-free convolutions:

  * input: five sparse-RGB Bayer frames (a circular window);
  * branch 1: the frames summed to 1-channel mosaics go through ``temp1``
    DenBlock triplets (residual added from the centre frame, broadcast from
    1 to 3 channels);
  * branch 2: the mosaics packed to 4-channel half-resolution RGGB planes go
    through ``temp11`` DenBlock4ChBayer triplets (residual, bilinear
    align-corners 2x upsample, 4 -> 3 fusion);
  * a shared ``temp2`` DenBlock fuses each branch, and the learned weights
    ``weight_tensor_{in,in2,out}`` scale the window's frames and mix the two
    branches.

Windows are ``(N, 5, H, W, 3)`` at the public method, as the JAX model takes
them, and NCHW inside. The modules keep the reference checkpoint's layout
(``temp1.inc_1.convblock.0.weight``, ``temp1.downc0.convblock.2.convblock.0
.weight``, ...; the ``weight_tensor_*`` in their broadcast shapes
``(9,1,1,1,1)``, ``(9,1,4,1,1)``, ``(2,1,3,1,1)``), so a reference state
dict loads as it is once its unused ``inc`` blocks are dropped
(:func:`adaptivepnp_sci_torch.models.convert.ddnet_state_dict_from_reference`),
and Flax variables load through
:func:`adaptivepnp_sci_torch.models.convert.ddnet_from_flax`. The grouped
input convolution is a ``groups=3`` ``nn.Conv2d``: the JAX model's
block-diagonal dense form computes the same sums (its zero blocks add
exactly).

With no BatchNorm the three shared-weight triplet calls of ``temp1``,
``temp11`` and ``temp2`` each fold into one batch.

``dtype=torch.bfloat16`` follows the JAX model's cast points: each DenBlock
casts its input to bf16 and runs its convolutions in bf16 (products summed
in float32, rounded once: :func:`adaptivepnp_sci_torch.ops.convpair.conv2d_lowp`)
in ``torch.channels_last``; the centre-frame residual, the upsample and the
branch mixing are float32; the ``fusion`` block runs in bf16 and returns to
float32. Parameters stay float32. DDnet's C -> C pairs (C = 40, 80) run on
the library's convolutions: the fused conv-pair kernel takes C in
{32, 64, 128} only.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from adaptivepnp_sci_torch.models.common import upsample_bilinear_align_corners
from adaptivepnp_sci_torch.models.fastdvdnet import _conv, _conv3
from adaptivepnp_sci_torch.ops import bayer

BASE_LAYER = 20
CHANNELS = (BASE_LAYER, BASE_LAYER * 2, BASE_LAYER * 4)


class CvBlock(nn.Module):
    """(Conv => ReLU) x 2, no norm."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.convblock = nn.Sequential(
            _conv3(in_ch, out_ch), nn.ReLU(), _conv3(out_ch, out_ch), nn.ReLU())

    def forward(self, x: Tensor) -> Tensor:
        conv0, _, conv1, _ = self.convblock
        x = F.relu(_conv(x, conv0, self.dtype))
        return F.relu(_conv(x, conv1, self.dtype))


class InputCvBlock2(nn.Module):
    """Grouped per-frame conv => ReLU => fusion conv => ReLU (no noise map)."""

    def __init__(self, num_in_frames: int, in_ch_each: int, out_ch: int,
                 interm_ch: int = 30, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        mid = num_in_frames * interm_ch
        self.convblock = nn.Sequential(
            _conv3(num_in_frames * in_ch_each, mid, groups=num_in_frames), nn.ReLU(),
            _conv3(mid, out_ch), nn.ReLU())

    def forward(self, x: Tensor) -> Tensor:
        conv0, _, conv1, _ = self.convblock
        x = F.relu(_conv(x, conv0, self.dtype))
        return F.relu(_conv(x, conv1, self.dtype))


class DownBlock(nn.Module):
    """Stride-2 conv => ReLU, then a CvBlock."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.convblock = nn.Sequential(
            _conv3(in_ch, out_ch, stride=2), nn.ReLU(), CvBlock(out_ch, out_ch, dtype))

    def forward(self, x: Tensor) -> Tensor:
        conv0, _, cv = self.convblock
        return cv(F.relu(_conv(x, conv0, self.dtype)))


class UpBlock(nn.Module):
    """CvBlock, conv to 4x the channels, pixel shuffle."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.convblock = nn.Sequential(
            CvBlock(in_ch, in_ch, dtype), _conv3(in_ch, out_ch * 4), nn.PixelShuffle(2))

    def forward(self, x: Tensor) -> Tensor:
        cv, conv0, shuffle = self.convblock
        return shuffle(_conv(cv(x), conv0, self.dtype))


class OutputCvBlock(nn.Module):
    """Conv => ReLU, then the conv to the output channels."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.convblock = nn.Sequential(_conv3(in_ch, in_ch), nn.ReLU(), _conv3(in_ch, out_ch))

    def forward(self, x: Tensor) -> Tensor:
        conv0, _, conv1 = self.convblock
        return _conv(F.relu(_conv(x, conv0, self.dtype)), conv1, self.dtype)


def _lowp(x: Tensor, dtype: torch.dtype | None) -> Tensor:
    """``x`` in the compute type, channels-last (unchanged for float32)."""
    if dtype is None:
        return x
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


class DenBlock(nn.Module):
    """U-Net over a triplet of NCHW frames with ``in_ch_each`` channels each;
    the residual from the centre frame is added in float32 (a 1-channel
    centre broadcasts over the 3-channel estimate)."""

    def __init__(self, in_ch_each: int = 3, out_ch: int = 3,
                 chs: tuple[int, int, int] = CHANNELS, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.inc_1 = InputCvBlock2(3, in_ch_each, chs[0], dtype=dtype)
        self.downc0 = DownBlock(chs[0], chs[1], dtype)
        self.downc1 = DownBlock(chs[1], chs[2], dtype)
        self.upc2 = UpBlock(chs[2], chs[1], dtype)
        self.upc1 = UpBlock(chs[1], chs[0], dtype)
        self.outc = OutputCvBlock(chs[0], out_ch, dtype)

    def unet(self, in0: Tensor, in1: Tensor, in2: Tensor) -> Tensor:
        x0 = self.inc_1(_lowp(torch.cat([in0, in1, in2], dim=1), self.dtype))
        x1 = self.downc0(x0)
        x2 = self.upc2(self.downc1(x1))
        x1 = self.upc1(x1 + x2)
        return in1.float() + self.outc(x0 + x1).float()

    def forward(self, in0: Tensor, in1: Tensor, in2: Tensor) -> Tensor:
        return self.unet(in0, in1, in2)


class DenBlock4ChBayer(DenBlock):
    """Half-resolution 4-channel RGGB branch: the U-Net with its residual,
    a bilinear 2x upsample in float32, and the 4 -> 3 ``fusion`` block."""

    def __init__(self, chs: tuple[int, int, int] = CHANNELS, dtype: torch.dtype | None = None):
        super().__init__(in_ch_each=4, out_ch=4, chs=chs, dtype=dtype)
        self.fusion = OutputCvBlock(4, 3, dtype)

    def forward(self, in0: Tensor, in1: Tensor, in2: Tensor) -> Tensor:
        x = upsample_bilinear_align_corners(self.unet(in0, in1, in2), 2)
        return self.fusion(_lowp(x, self.dtype)).float()


class DDnet(nn.Module):
    """Joint demosaick and denoise of the centre frame of a 5-frame window:
    ``(N, 5, H, W, 3)`` sparse-RGB-embedded Bayer frames (each value in its
    CFA channel, zeros elsewhere; H and W multiples of 4) -> ``(N, H, W, 3)``.

    ``dtype``: compute type of the three U-Nets' convolutions (None =
    float32; ``torch.bfloat16`` = bf16 compute with float32 parameters,
    residuals and mixing).
    """

    def __init__(self, num_input_frames: int = 5, dtype: torch.dtype | None = None):
        super().__init__()
        self.num_input_frames = num_input_frames
        self.dtype = dtype
        self.temp1 = DenBlock(in_ch_each=1, dtype=dtype)
        self.temp2 = DenBlock(in_ch_each=3, dtype=dtype)
        self.temp11 = DenBlock4ChBayer(dtype=dtype)
        self.weight_tensor_in = nn.Parameter(torch.ones((9, 1, 1, 1, 1)))
        self.weight_tensor_in2 = nn.Parameter(torch.ones((9, 1, 4, 1, 1)))
        self.weight_tensor_out = nn.Parameter(torch.ones((2, 1, 3, 1, 1)))

    def forward(self, windows: Tensor) -> Tensor:
        if windows.dim() != 5 or windows.shape[1] != self.num_input_frames:
            raise ValueError(f"expected windows (N, {self.num_input_frames}, H, W, 3), "
                             f"got {tuple(windows.shape)}")
        n = windows.shape[0]
        a, a2, a3 = self.weight_tensor_in, self.weight_tensor_in2, self.weight_tensor_out
        mosaics = windows.sum(-1)                                   # (N, 5, H, W)
        ones = [mosaics[:, i, None] for i in range(self.num_input_frames)]   # (N, 1, H, W)
        fours = [bayer.pack(mosaics[:, i]) for i in range(self.num_input_frames)]

        def triplets(f: list[Tensor], w: Tensor) -> tuple[Tensor, Tensor, Tensor]:
            # window weight a[3j + i] scales frame j + i of triplet j
            return tuple(torch.cat([f[j + i] * w[3 * j + i] for j in range(3)])
                         for i in range(3))

        x2 = self.temp1(*triplets(ones, a))
        y2 = self.temp11(*triplets(fours, a2))
        out = self.temp2(*(torch.cat([x2[i * n:(i + 1) * n], y2[i * n:(i + 1) * n]])
                           for i in range(3)))
        return (a3[0] * out[:n] + a3[1] * out[n:]).permute(0, 2, 3, 1)


class ResidualBlockNoBN(nn.Module):
    """``x + conv2(relu(conv1(x)))`` with a 48-channel bottleneck: the
    reference's dormant ``ResidualBlock_noBN``
    (``models/network_demosaicking.py:126-136``; used only by the equally
    dormant :class:`PyramidEncoder`)."""

    def __init__(self, nf: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(nf, 48, 3, padding=1)
        self.conv2 = nn.Conv2d(48, nf, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        return x + self.conv2(F.relu(self.conv1(x)))


class PyramidEncoder(nn.Module):
    """4x-downscaling pyramid feature encoder: the reference's dormant
    ``encoder`` (``models/network_demosaicking.py:137-182``; defined in the
    model file, instantiated by no driver).

    ``(N, H, W, 4)`` RGGB input -> ``(N, ceil(H/4), ceil(W/4), nf)``; NCHW
    inside. Two stride-2 head stages, ``n_rb`` residual blocks, then a
    three-level feature pyramid (1, 1/2, 1/4) merged by half-pixel bilinear
    upsampling (``align_corners=False``) and a 7x7 fusion conv. The
    reference's forward applies LeakyReLU(0.1) to head ``Sequential`` s that
    already end in one, which scales negatives by 0.01: kept as it is, since
    the double application is not idempotent. Every conv has a bias; the
    modules are named after the JAX scopes (``conv_first01_0``, ``rbs_{i}``,
    ...).
    """

    def __init__(self, nf: int = 64, n_rb: int = 5):
        super().__init__()
        self.n_rb = n_rb

        def conv(cin: int, cout: int, k: int = 3, s: int = 1) -> nn.Conv2d:
            return nn.Conv2d(cin, cout, k, stride=s, padding=k // 2)

        self.conv_first01_0 = conv(4, nf * 2, s=2)
        self.conv_first01_2 = conv(nf * 2, nf)
        self.conv_first02_0 = conv(nf, nf * 2, s=2)
        self.conv_first02_2 = conv(nf * 2, nf)
        self.conv_first = conv(nf, nf)
        for i in range(n_rb):
            self.add_module(f"rbs_{i}", ResidualBlockNoBN(nf))
        self.d2_conv1 = conv(nf, nf, s=2)
        self.d2_conv2 = conv(nf, nf)
        self.d4_conv1 = conv(nf, nf, s=2)
        self.d4_conv2 = conv(nf, nf)
        self.py_conv = conv(3 * nf, nf, k=7)

    def forward(self, x: Tensor) -> Tensor:
        def lrelu(v: Tensor) -> Tensor:
            return F.leaky_relu(v, 0.1)

        x = x.permute(0, 3, 1, 2)
        x = lrelu(self.conv_first01_0(x))
        x = lrelu(lrelu(self.conv_first01_2(x)))
        x = lrelu(self.conv_first02_0(x))
        x = lrelu(lrelu(self.conv_first02_2(x)))
        fea_lr = lrelu(self.conv_first(x))
        for i in range(self.n_rb):
            fea_lr = getattr(self, f"rbs_{i}")(fea_lr)
        d2 = lrelu(self.d2_conv2(lrelu(self.d2_conv1(fea_lr))))
        d4 = lrelu(self.d4_conv2(lrelu(self.d4_conv1(d2))))
        size = fea_lr.shape[-2:]

        def up(v: Tensor) -> Tensor:
            return F.interpolate(v, size=size, mode="bilinear", align_corners=False)

        out = torch.cat([fea_lr, up(d2), up(d4)], dim=1)
        return lrelu(self.py_conv(out)).permute(0, 2, 3, 1)
