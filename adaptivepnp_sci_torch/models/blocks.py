"""KAIR-style conv-block zoo (port of ``adaptivepnp_sci_tpu.models.blocks``).

The reference's block library (``models/basicblock.py``): the mode-string
conv factory, residual, attention and dense blocks, and the up/downsample
factories. The reference drivers use only ``conv`` and ``PixelUnShuffle``
(through FFDNet); the zoo is here so that models built on that library port
one to one.

NCHW throughout, PyTorch's and KAIR's layout (the JAX package is NHWC). As in
KAIR, every block takes its input channels first, since PyTorch layers are
not shape-lazy. Each submodule is named after its Flax scope (``conv{i}``,
``bn{i}``, ``res``, ``rcab{i}``, ...), so Flax variables map onto a block's
state dict by path alone
(:func:`~adaptivepnp_sci_torch.models.convert.blocks_from_flax`). BatchNorm is
:class:`~adaptivepnp_sci_torch.models.common.FlaxBatchNorm2d` with the JAX
module's momentum and epsilon; ``module.train()`` selects batch statistics,
where the JAX blocks take ``train=True``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from adaptivepnp_sci_torch.models.common import (
    FlaxBatchNorm2d,
    depth_to_space,
    space_to_depth,
)

# the reference's pixel_(un)shuffle live here in KAIR
pixel_shuffle = depth_to_space
pixel_unshuffle = space_to_depth


def sequential(*modules: nn.Module) -> nn.Sequential:
    """Chain modules left to right, the KAIR ``sequential``: nested
    ``nn.Sequential`` arguments are flattened into the chain."""
    flat: list[nn.Module] = []
    for m in modules:
        flat.extend(m.children() if isinstance(m, nn.Sequential) else [m])
    return nn.Sequential(*flat)


def _nearest_upsample(x: Tensor, r: int) -> Tensor:
    return x.repeat_interleave(r, dim=-2).repeat_interleave(r, dim=-1)


def _pool(x: Tensor, k: int, s: int, op: str) -> Tensor:
    if op == "max":
        return F.max_pool2d(x, k, s)
    return F.avg_pool2d(x, k, s)


_UPSAMPLE = {"U": 2, "u": 3, "v": 4}
#: mode character -> name prefix of its layer (``conv{i}``, ``bn{i}``, ...)
_LAYER = {"C": "conv", "T": "convt", "B": "bn", "I": "in"}


class ConvBlock(nn.Module):
    """Mode-string layer chain, the KAIR ``conv`` factory
    (``basicblock.py:61-101``).

    Mode characters: ``C`` conv, ``T`` transposed conv (``padding`` 0 only),
    ``B`` BatchNorm (Flax momentum 0.1, eps 1e-4: KAIR's torch momentum 0.9),
    ``I`` InstanceNorm (a ``GroupNorm`` with one group per channel, affine),
    ``R``/``r`` ReLU, ``L``/``l`` LeakyReLU, ``2``/``3``/``4`` PixelShuffle,
    ``U``/``u``/``v`` nearest upsample x2/x3/x4, ``M`` max pool, ``A`` avg
    pool (window ``kernel_size``, step ``stride``). Upper and lower case
    activations differ only by in-place-ness in KAIR: the same arithmetic.
    """

    def __init__(self, in_ch: int, out_ch: int = 64, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, bias: bool = True, mode: str = "CBR",
                 negative_slope: float = 0.2):
        super().__init__()
        self.mode, self.kernel_size, self.stride = mode, kernel_size, stride
        self.negative_slope = negative_slope
        k, s, p = kernel_size, stride, padding
        c = in_ch
        for i, t in enumerate(mode):
            if t == "C":
                self.add_module(f"conv{i}", nn.Conv2d(c, out_ch, k, s, p, bias=bias))
                c = out_ch
            elif t == "T":
                # PyTorch's output (in - 1) s - 2p + k equals Flax's VALID
                # transposed conv only at p = 0, the zoo's one use
                if p != 0:
                    raise ValueError("transposed conv only supported with padding=0")
                self.add_module(f"convt{i}", nn.ConvTranspose2d(c, out_ch, k, s, bias=bias))
                c = out_ch
            elif t == "B":
                self.add_module(f"bn{i}", FlaxBatchNorm2d(c, flax_momentum=0.1, eps=1e-4))
            elif t == "I":
                self.add_module(f"in{i}", nn.GroupNorm(c, c, eps=1e-5))
            elif t in "234":
                c //= int(t) ** 2
            elif t not in "RrLlUuvMA":
                raise NotImplementedError(f"undefined mode char: {t!r}")
        self.out_channels = c

    def forward(self, x: Tensor) -> Tensor:
        for i, t in enumerate(self.mode):
            if t in _LAYER:
                x = getattr(self, f"{_LAYER[t]}{i}")(x)
            elif t in "Rr":
                x = F.relu(x)
            elif t in "Ll":
                x = F.leaky_relu(x, self.negative_slope)
            elif t in "234":
                x = depth_to_space(x, int(t))
            elif t in _UPSAMPLE:
                x = _nearest_upsample(x, _UPSAMPLE[t])
            else:  # M, A
                x = _pool(x, self.kernel_size, self.stride, "max" if t == "M" else "avg")
        return x


class ConditionalBatchNorm2d(nn.Module):
    """Class-conditional BatchNorm (``basicblock.py:156-172``): BatchNorm
    without scale or bias (Flax's defaults, momentum 0.99, eps 1e-5), then a
    per-class gamma and beta from an embedding table."""

    def __init__(self, num_features: int, num_classes: int):
        super().__init__()
        self.num_features = num_features
        self.bn = FlaxBatchNorm2d(num_features, flax_momentum=0.99, eps=1e-5, affine=False)
        self.embed = nn.Embedding(num_classes, num_features * 2)
        # reference init (basicblock.py:161-163): gamma ~ N(1, 0.02), beta 0,
        # so training from scratch starts near the identity
        with torch.no_grad():
            self.embed.weight[:, :num_features].normal_(1.0, 0.02)
            self.embed.weight[:, num_features:].zero_()

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        gamma, beta = self.embed(y).chunk(2, dim=-1)
        shape = (-1, self.num_features, 1, 1)
        return gamma.reshape(shape) * self.bn(x) + beta.reshape(shape)


class ConcatBlock(nn.Module):
    """x -> concat(x, sub(x)) over channels (``basicblock.py:175-188``)."""

    def __init__(self, sub: nn.Module):
        super().__init__()
        self.sub = sub

    def forward(self, x: Tensor) -> Tensor:
        return torch.cat([x, self.sub(x)], dim=1)


class ShortcutBlock(nn.Module):
    """x -> x + sub(x) (``basicblock.py:191-208``)."""

    def __init__(self, sub: nn.Module):
        super().__init__()
        self.sub = sub

    def forward(self, x: Tensor) -> Tensor:
        return x + self.sub(x)


def _res_mode(mode: str) -> str:
    # KAIR lowers a leading activation so the residual path starts pre-act
    if mode and mode[0] in ("R", "L"):
        return mode[0].lower() + mode[1:]
    return mode


class ResBlock(nn.Module):
    """x + conv-chain(x) (``basicblock.py:211-227``)."""

    def __init__(self, channels: int = 64, kernel_size: int = 3, bias: bool = True,
                 mode: str = "CRC", negative_slope: float = 0.2):
        super().__init__()
        self.res = ConvBlock(channels, channels, kernel_size, 1, kernel_size // 2, bias,
                             _res_mode(mode), negative_slope)

    def forward(self, x: Tensor) -> Tensor:
        return x + self.res(x)


class IMDBlock(nn.Module):
    """Information multi-distillation block (Hui et al. 2019;
    ``basicblock.py:230-268``): three split-distill stages and a 1x1 fuse,
    residual."""

    def __init__(self, channels: int = 64, kernel_size: int = 3, bias: bool = True,
                 mode: str = "CL", d_rate: float = 0.25, negative_slope: float = 0.05):
        super().__init__()
        c = channels
        self.d_nc = d_nc = int(c * d_rate)
        r_nc = c - d_nc
        k, p = kernel_size, kernel_size // 2
        self.conv1 = ConvBlock(c, c, k, 1, p, bias, mode, negative_slope)
        self.conv2 = ConvBlock(r_nc, c, k, 1, p, bias, mode, negative_slope)
        self.conv3 = ConvBlock(r_nc, c, k, 1, p, bias, mode, negative_slope)
        self.conv4 = ConvBlock(r_nc, d_nc, k, 1, p, bias, mode[0], negative_slope)
        self.conv1x1 = ConvBlock(4 * d_nc, c, 1, 1, 0, bias, mode[0], negative_slope)

    def forward(self, x: Tensor) -> Tensor:
        d = self.d_nc
        d1, r1 = self.conv1(x).split([d, x.shape[1] - d], dim=1)
        d2, r2 = self.conv2(r1).split([d, x.shape[1] - d], dim=1)
        d3, r3 = self.conv3(r2).split([d, x.shape[1] - d], dim=1)
        d4 = self.conv4(r3)
        return x + self.conv1x1(torch.cat([d1, d2, d3, d4], dim=1))


class ESA(nn.Module):
    """Enhanced spatial attention (``basicblock.py:271-295``): squeeze,
    stride-2 conv and a 7/3 max pool, a conv stack, bilinear upsampling with
    half-pixel centres (``align_corners=False``, the JAX resize's when
    enlarging), gate."""

    def __init__(self, channels: int = 64, reduction: int = 4, bias: bool = True):
        super().__init__()
        r_nc = channels // reduction

        def conv(cin: int, cout: int, k: int, s: int, p: int) -> nn.Conv2d:
            return nn.Conv2d(cin, cout, k, s, p, bias=bias)

        self.conv1 = conv(channels, r_nc, 1, 1, 0)
        self.conv21 = conv(r_nc, r_nc, 1, 1, 0)
        self.conv2 = conv(r_nc, r_nc, 3, 2, 0)
        self.conv3 = conv(r_nc, r_nc, 3, 1, 1)
        self.conv4 = conv(r_nc, r_nc, 3, 1, 1)
        self.conv5 = conv(r_nc, r_nc, 3, 1, 1)
        self.conv6 = conv(r_nc, channels, 1, 1, 0)

    def forward(self, x: Tensor) -> Tensor:
        x1 = self.conv1(x)
        x2 = F.max_pool2d(self.conv2(x1), 7, 3)
        x2 = F.relu(self.conv3(x2))
        x2 = F.relu(self.conv4(x2))
        x2 = self.conv5(x2)
        x2 = F.interpolate(x2, size=x.shape[-2:], mode="bilinear", align_corners=False)
        x2 = self.conv6(x2 + self.conv21(x1))
        return x * torch.sigmoid(x2)


class CFRB(nn.Module):
    """Cascaded feature-refinement block with an ESA gate
    (``basicblock.py:298-330``)."""

    def __init__(self, channels: int = 50, kernel_size: int = 3, bias: bool = True,
                 mode: str = "CL", d_rate: float = 0.5, negative_slope: float = 0.05):
        super().__init__()
        c = channels
        d_nc = int(c * d_rate)
        k, p = kernel_size, kernel_size // 2
        self.relu = mode[-1] in ("R", "r")
        self.negative_slope = negative_slope
        for i in (1, 2, 3):
            self.add_module(f"conv{i}_d", ConvBlock(c, d_nc, 1, 1, 0, bias, "C"))
            self.add_module(f"conv{i}_r", ConvBlock(c, c, k, 1, p, bias, "C"))
        self.conv4_d = ConvBlock(c, d_nc, k, 1, p, bias, "C")
        self.conv1x1 = ConvBlock(4 * d_nc, c, 1, 1, 0, bias, "C")
        self.esa = ESA(c, 4, True)

    def _act(self, x: Tensor) -> Tensor:
        return F.relu(x) if self.relu else F.leaky_relu(x, self.negative_slope)

    def forward(self, x: Tensor) -> Tensor:
        ds = []
        for i in (1, 2, 3):
            ds.append(getattr(self, f"conv{i}_d")(x))
            x = self._act(getattr(self, f"conv{i}_r")(x) + x)
        x = self._act(torch.cat([*ds, self.conv4_d(x)], dim=1))
        return self.esa(self.conv1x1(x))


class CALayer(nn.Module):
    """Squeeze-and-excitation channel attention (``basicblock.py:333-348``)."""

    def __init__(self, channels: int = 64, reduction: int = 16):
        super().__init__()
        self.fc0 = nn.Conv2d(channels, channels // reduction, 1)
        self.fc1 = nn.Conv2d(channels // reduction, channels, 1)

    def forward(self, x: Tensor) -> Tensor:
        y = x.mean(dim=(-2, -1), keepdim=True)
        return x * torch.sigmoid(self.fc1(F.relu(self.fc0(y))))


class RCABlock(nn.Module):
    """Residual channel-attention block (``basicblock.py:354-367``)."""

    def __init__(self, channels: int = 64, kernel_size: int = 3, bias: bool = True,
                 mode: str = "CRC", reduction: int = 16, negative_slope: float = 0.2):
        super().__init__()
        self.res = ConvBlock(channels, channels, kernel_size, 1, kernel_size // 2, bias,
                             _res_mode(mode), negative_slope)
        self.ca = CALayer(channels, reduction)

    def forward(self, x: Tensor) -> Tensor:
        return self.ca(self.res(x)) + x


class RCAGroup(nn.Module):
    """``nb`` RCABlocks and a tail conv, residual (``basicblock.py:373-390``)."""

    def __init__(self, channels: int = 64, kernel_size: int = 3, bias: bool = True,
                 mode: str = "CRC", reduction: int = 16, nb: int = 12,
                 negative_slope: float = 0.2):
        super().__init__()
        self.nb = nb
        for i in range(nb):
            self.add_module(f"rcab{i}", RCABlock(channels, kernel_size, bias, mode, reduction,
                                                 negative_slope))
        self.tail = ConvBlock(channels, channels, mode="C")

    def forward(self, x: Tensor) -> Tensor:
        h = x
        for i in range(self.nb):
            h = getattr(self, f"rcab{i}")(h)
        return self.tail(h) + x


class ResidualDenseBlock5C(nn.Module):
    """Five-conv residual dense block with a 0.2-scaled residual
    (``basicblock.py:393-413``)."""

    def __init__(self, nc: int = 64, gc: int = 32, kernel_size: int = 3, bias: bool = True,
                 mode: str = "CR", negative_slope: float = 0.2):
        super().__init__()
        k, p = kernel_size, kernel_size // 2
        for i in range(1, 5):
            self.add_module(f"conv{i}", ConvBlock(nc + (i - 1) * gc, gc, k, 1, p, bias, mode,
                                                  negative_slope))
        self.conv5 = ConvBlock(nc + 4 * gc, nc, k, 1, p, bias, mode[:-1], negative_slope)

    def forward(self, x: Tensor) -> Tensor:
        feats = [x]
        for i in range(1, 5):
            feats.append(getattr(self, f"conv{i}")(torch.cat(feats, dim=1)))
        return self.conv5(torch.cat(feats, dim=1)) * 0.2 + x


class RRDB(nn.Module):
    """Residual-in-residual dense block, three RDB5C
    (``basicblock.py:416-436``)."""

    def __init__(self, nc: int = 64, gc: int = 32, kernel_size: int = 3, bias: bool = True,
                 mode: str = "CR", negative_slope: float = 0.2):
        super().__init__()
        for i in (1, 2, 3):
            self.add_module(f"rdb{i}", ResidualDenseBlock5C(nc, gc, kernel_size, bias, mode,
                                                            negative_slope))

    def forward(self, x: Tensor) -> Tensor:
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class NonLocalBlock2D(nn.Module):
    """Embedded-gaussian non-local attention (``basicblock.py:543-591``):
    ``x + W(softmax(theta(x) phi(x)^T) g(x))`` over the flattened positions,
    two batched matrix products and 1x1 convs."""

    def __init__(self, nc: int = 64, act_mode: str = "B", downsample: bool = False):
        super().__init__()
        inter = nc // 2
        self.downsample = downsample
        self.theta = nn.Conv2d(nc, inter, 1)
        self.phi = nn.Conv2d(nc, inter, 1)
        self.g = nn.Conv2d(nc, inter, 1)
        self.w = ConvBlock(inter, nc, 1, 1, 0, True, "C" + act_mode)

    def forward(self, x: Tensor) -> Tensor:
        n, _, h, w = x.shape
        src = F.max_pool2d(x, 2, 2) if self.downsample else x
        theta = self.theta(x).flatten(2).transpose(1, 2)   # (n, hw, inter)
        phi = self.phi(src).flatten(2).transpose(1, 2)     # (n, m, inter)
        g = self.g(src).flatten(2).transpose(1, 2)
        attn = torch.softmax(theta @ phi.transpose(1, 2), dim=-1)
        y = (attn @ g).transpose(1, 2).reshape(n, -1, h, w)
        return x + self.w(y)


# ---------------------------------------------------------------------------
# up/downsample factories (``basicblock.py:446-540``): thin ConvBlock
# constructors, mode '2R'/'3BR'/... selects the scale and an optional
# norm/activation
# ---------------------------------------------------------------------------

def _scale_of(mode: str, allowed: str = "234") -> int:
    if not (len(mode) < 4 and mode[0] in allowed):
        raise ValueError(f"bad factory mode {mode!r}")
    return int(mode[0])


def upsample_pixelshuffle(in_ch: int, out_ch: int = 3, kernel_size: int = 3,
                          bias: bool = True, mode: str = "2R",
                          negative_slope: float = 0.2) -> ConvBlock:
    r = _scale_of(mode)
    return ConvBlock(in_ch, out_ch * r * r, kernel_size, 1, kernel_size // 2, bias,
                     "C" + mode, negative_slope)


def upsample_upconv(in_ch: int, out_ch: int = 3, kernel_size: int = 3, bias: bool = True,
                    mode: str = "2R", negative_slope: float = 0.2) -> ConvBlock:
    up = {2: "U", 3: "u", 4: "v"}[_scale_of(mode)]
    return ConvBlock(in_ch, out_ch, kernel_size, 1, kernel_size // 2, bias,
                     up + "C" + mode[1:], negative_slope)


def upsample_convtranspose(in_ch: int, out_ch: int = 3, bias: bool = True,
                           mode: str = "2R", negative_slope: float = 0.2) -> ConvBlock:
    r = _scale_of(mode)
    return ConvBlock(in_ch, out_ch, r, r, 0, bias, "T" + mode[1:], negative_slope)


def downsample_strideconv(in_ch: int, out_ch: int = 64, bias: bool = True,
                          mode: str = "2R", negative_slope: float = 0.2) -> ConvBlock:
    r = _scale_of(mode)
    return ConvBlock(in_ch, out_ch, r, r, 0, bias, "C" + mode[1:], negative_slope)


def downsample_maxpool(in_ch: int, out_ch: int = 64, kernel_size: int = 3,
                       bias: bool = True, mode: str = "2R",
                       negative_slope: float = 0.2, padding: int = 0) -> "_PoolThenConv":
    # KAIR's factory fixes the tail conv's padding at 0 whatever the kernel
    # size (basicblock.py:507); a parameter here, as in KAIR
    r = _scale_of(mode, "23")
    return _PoolThenConv(in_ch, out_ch, kernel_size, r, "max", bias, mode[1:],
                         negative_slope, padding)


def downsample_avgpool(in_ch: int, out_ch: int = 64, kernel_size: int = 3,
                       bias: bool = True, mode: str = "2R",
                       negative_slope: float = 0.2, padding: int = 1) -> "_PoolThenConv":
    # KAIR's avgpool tail conv pads by 1 whatever the kernel size
    # (basicblock.py:520)
    r = _scale_of(mode, "23")
    return _PoolThenConv(in_ch, out_ch, kernel_size, r, "avg", bias, mode[1:],
                         negative_slope, padding)


class _PoolThenConv(nn.Module):
    """Pool by ``r`` (window and step), then a conv chain: the maxpool and
    avgpool downsample factories."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, r: int, pool: str,
                 bias: bool, tail_mode: str, negative_slope: float, padding: int = 0):
        super().__init__()
        self.r, self.pool = r, pool
        self.tail = ConvBlock(in_ch, out_ch, kernel_size, 1, padding, bias, "C" + tail_mode,
                              negative_slope)

    def forward(self, x: Tensor) -> Tensor:
        return self.tail(_pool(x, self.r, self.r, self.pool))
