"""FastDVDnet temporal video denoiser (Tassano et al., CVPR 2020)
(port of ``adaptivepnp_sci_tpu.models.fastdvdnet``).

Two cascaded U-Net denoising blocks over 5-frame windows: ``temp1`` on the
three overlapping triplets, ``temp2`` fusing the three outputs. Each
:class:`DenBlock`: a grouped input conv over the three frames with their
noise maps interleaved, two stride-2 downs, pixel-shuffle ups, the residual
from the centre frame. BatchNorm throughout (eps 1e-5, momentum 0.1).

Frames are ``(N, H, W, C)`` at the public methods, as the JAX model takes
them, and NCHW inside. The modules sit in ``convblock`` ``Sequential``s with
the published model's indices (``temp1.inc.convblock.0.weight``, ...), so a
FastDVDnet checkpoint's state dict loads as it is and Flax variables load
through :func:`adaptivepnp_sci_torch.models.convert.fastdvdnet_from_flax`.

``dtype=torch.bfloat16`` runs each DenBlock's conv/BN chain in bf16 with
float32 parameters and float32 residuals: weights are cast at use,
convolutions sum in float32 and round once, eval-mode BatchNorm is folded to
a float32 scale and shift. In that mode the U-Net is kept in
``torch.channels_last`` memory, and the eight C -> C :class:`CvBlock` s of a
denoiser call are each one launch of the fused conv-pair kernel
(:func:`adaptivepnp_sci_torch.ops.cuda_kernels.convpair`) when the tensors
are on the card and no gradient is asked for. Under the same condition the
folded BatchNorm and ReLU after each of the other BatchNorm'd convolutions
(the library's) is one launch of the epilogue kernel
(:func:`adaptivepnp_sci_torch.ops.cuda_kernels.scale_shift_relu`, bit for
bit the plain version): ten a :meth:`FastDVDnet.seq_circular` call. A forward
with gradient (the online adaptation) or in train mode goes through the
library's convolutions and PyTorch's elementwise passes with the same
arithmetic.

:meth:`FastDVDnet.seq_circular` denoises a whole circular B-frame sequence
with ``temp1`` evaluated once per distinct triplet (B evaluations instead of
the 3B of per-window evaluation): identical math with frozen BatchNorm.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor
from torch.utils.checkpoint import checkpoint

from adaptivepnp_sci_torch.models.common import FlaxBatchNorm2d, frozen_batch_stats
from adaptivepnp_sci_torch.ops import convpair as convpair_ops
from adaptivepnp_sci_torch.ops import cuda_kernels


#: the BatchNorm of FastDVDnet: Flax's convention (momentum 0.9, eps 1e-5) in
#: train mode, ``nn.BatchNorm2d``'s in eval mode
BatchNorm2d = FlaxBatchNorm2d


def _conv3(in_ch: int, out_ch: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, groups=groups, bias=False)


def _conv(x: Tensor, conv: nn.Conv2d, dtype: torch.dtype | None) -> Tensor:
    if dtype is None:
        return conv(x)
    return convpair_ops.conv2d_lowp(x, conv.weight, conv.stride[0], conv.groups)


def _needs_grad(*tensors: Tensor) -> bool:
    """Whether a forward over ``tensors`` must be differentiable: the kernels
    have no backward."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _bn_relu(x: Tensor, bn: nn.BatchNorm2d, dtype: torch.dtype | None) -> Tensor:
    if dtype is None:
        return F.relu(bn(x))
    if bn.training:  # batch statistics, in float32
        return F.relu(bn(x.float())).to(dtype)
    # low-precision eval: the folded epilogue, on the kernel unless a gradient is needed
    s, b = convpair_ops.fold_bn(bn)
    epilogue = (convpair_ops.scale_shift_relu if _needs_grad(x, s, b)
                else cuda_kernels.scale_shift_relu)
    return epilogue(x, s, b)


def _hwio(conv: nn.Conv2d, dtype: torch.dtype) -> Tensor:
    """A conv's weight as the ``(kh, kw, Cin, Cout)`` kernel of the conv pair."""
    return conv.weight.to(dtype).permute(2, 3, 1, 0).contiguous()


class CvBlock(nn.Module):
    """(Conv => BN => ReLU) x 2."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.convblock = nn.Sequential(
            _conv3(in_ch, out_ch), BatchNorm2d(out_ch), nn.ReLU(),
            _conv3(out_ch, out_ch), BatchNorm2d(out_ch), nn.ReLU())

    def forward(self, x: Tensor) -> Tensor:
        conv0, bn0, _, conv1, bn1, _ = self.convblock
        dt = self.dtype
        if dt is None or self.training or conv0.in_channels != conv0.out_channels:
            x = _bn_relu(_conv(x, conv0, dt), bn0, dt)
            return _bn_relu(_conv(x, conv1, dt), bn1, dt)
        # low-precision eval: the conv pair, on the kernel unless a gradient is needed
        args = (_hwio(conv0, dt), *convpair_ops.fold_bn(bn0),
                _hwio(conv1, dt), *convpair_ops.fold_bn(bn1))
        pair = convpair_ops.convpair if _needs_grad(x, *args) else cuda_kernels.convpair
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        return pair(nhwc, *args).permute(0, 3, 1, 2)


class InputCvBlock(nn.Module):
    """Grouped per-frame conv (+BN+ReLU), then the fusion conv (+BN+ReLU)."""

    def __init__(self, num_in_frames: int, out_ch: int, interm_ch: int = 30,
                 num_color_channels: int = 3, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        mid = num_in_frames * interm_ch
        self.convblock = nn.Sequential(
            _conv3(num_in_frames * (num_color_channels + 1), mid, groups=num_in_frames),
            BatchNorm2d(mid), nn.ReLU(),
            _conv3(mid, out_ch), BatchNorm2d(out_ch), nn.ReLU())

    def forward(self, x: Tensor) -> Tensor:
        conv0, bn0, _, conv1, bn1, _ = self.convblock
        x = _bn_relu(_conv(x, conv0, self.dtype), bn0, self.dtype)
        return _bn_relu(_conv(x, conv1, self.dtype), bn1, self.dtype)


class DownBlock(nn.Module):
    """Stride-2 conv with symmetric padding 1 (+BN+ReLU), then a CvBlock."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.convblock = nn.Sequential(
            _conv3(in_ch, out_ch, stride=2), BatchNorm2d(out_ch), nn.ReLU(),
            CvBlock(out_ch, out_ch, dtype))

    def forward(self, x: Tensor) -> Tensor:
        conv0, bn0, _, cv = self.convblock
        return cv(_bn_relu(_conv(x, conv0, self.dtype), bn0, self.dtype))


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
    """Conv (+BN+ReLU), then the conv to the colour channels."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.convblock = nn.Sequential(
            _conv3(in_ch, in_ch), BatchNorm2d(in_ch), nn.ReLU(), _conv3(in_ch, out_ch))

    def forward(self, x: Tensor) -> Tensor:
        conv0, bn0, _, conv1 = self.convblock
        return _conv(_bn_relu(_conv(x, conv0, self.dtype), bn0, self.dtype), conv1, self.dtype)


class DenBlock(nn.Module):
    """U-Net denoising block over a 3-frame triplet (NCHW frames and noise
    map); the residual from the centre frame is taken in float32."""

    def __init__(self, num_color_channels: int = 3,
                 chs: tuple[int, int, int] = (32, 64, 128), dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.inc = InputCvBlock(3, chs[0], num_color_channels=num_color_channels, dtype=dtype)
        self.downc0 = DownBlock(chs[0], chs[1], dtype)
        self.downc1 = DownBlock(chs[1], chs[2], dtype)
        self.upc2 = UpBlock(chs[2], chs[1], dtype)
        self.upc1 = UpBlock(chs[1], chs[0], dtype)
        self.outc = OutputCvBlock(chs[0], num_color_channels, dtype)

    def forward(self, in0: Tensor, in1: Tensor, in2: Tensor, noise_map: Tensor) -> Tensor:
        x = torch.cat([in0, noise_map, in1, noise_map, in2, noise_map], dim=1)
        if self.dtype is not None:
            x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x0 = self.inc(x)
        x1 = self.downc0(x0)
        x2 = self.downc1(x1)
        x2 = self.upc2(x2)
        x1 = self.upc1(x1 + x2)
        x = self.outc(x0 + x1)
        return in1.float() - x.float()


class FastDVDnet(nn.Module):
    """Windows ``(N, 5, H, W, C)`` + scalar or ``(N,)`` sigma -> ``(N, H, W, C)``.

    ``dtype``: compute type of the DenBlock conv/BN chains (None = float32;
    ``torch.bfloat16`` = bf16 compute with float32 parameters and residuals).
    ``remat``: recompute each DenBlock's activations in the backward pass
    (``torch.utils.checkpoint``), so that a gradient through all windows at
    full resolution holds one block's activations at a time.
    """

    def __init__(self, num_input_frames: int = 5, num_color_channels: int = 3,
                 dtype: torch.dtype | None = None, remat: bool = True):
        super().__init__()
        self.num_input_frames = num_input_frames
        self.dtype = dtype
        self.remat = remat
        self.temp1 = DenBlock(num_color_channels, dtype=dtype)
        self.temp2 = DenBlock(num_color_channels, dtype=dtype)

    def _block(self, block: DenBlock, in0: Tensor, in1: Tensor, in2: Tensor,
               noise_map: Tensor) -> Tensor:
        if self.remat and torch.is_grad_enabled():
            # the recomputation must not move the running statistics again
            return checkpoint(block, in0, in1, in2, noise_map, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(),
                                                  frozen_batch_stats(block)))
        return block(in0, in1, in2, noise_map)

    @staticmethod
    def _noise_map(like: Tensor, sigma: Tensor | float) -> Tensor:
        """``(N, 1, H, W)`` map of the noise level for NCHW ``like``."""
        n, _, h, w = like.shape
        sigma = torch.as_tensor(sigma, dtype=like.dtype, device=like.device)
        return sigma.reshape(-1, 1, 1, 1).expand(n, 1, h, w)

    def forward(self, windows: Tensor, sigma: Tensor | float) -> Tensor:
        if windows.dim() != 5 or windows.shape[1] != self.num_input_frames:
            raise ValueError(f"expected windows (N, {self.num_input_frames}, H, W, C), "
                             f"got {tuple(windows.shape)}")
        n = windows.shape[0]
        f = [windows[:, i].permute(0, 3, 1, 2) for i in range(self.num_input_frames)]
        noise_map = self._noise_map(f[0], sigma)
        if self.training:
            # train-mode BatchNorm takes its statistics per call: the three
            # triplets stay separate
            x20 = self._block(self.temp1, f[0], f[1], f[2], noise_map)
            x21 = self._block(self.temp1, f[1], f[2], f[3], noise_map)
            x22 = self._block(self.temp1, f[2], f[3], f[4], noise_map)
        else:
            # eval: the three shared-weight triplet calls fold into one 3N batch
            x2 = self._block(self.temp1, torch.cat(f[0:3]), torch.cat(f[1:4]),
                             torch.cat(f[2:5]), torch.cat([noise_map] * 3))
            x20, x21, x22 = x2[:n], x2[n:2 * n], x2[2 * n:]
        return self._block(self.temp2, x20, x21, x22, noise_map).permute(0, 2, 3, 1)

    def _stage(self, block: DenBlock, prev: Tensor, cur: Tensor, nxt: Tensor,
               sigma: Tensor | float) -> Tensor:
        return self._block(block, prev, cur, nxt, self._noise_map(cur, sigma))

    def triplet_stage1(self, prev: Tensor, cur: Tensor, nxt: Tensor,
                       sigma: Tensor | float) -> Tensor:
        """``temp1`` on one ``(N, H, W, C)`` triplet per sequence position."""
        nchw = (t.permute(0, 3, 1, 2) for t in (prev, cur, nxt))
        return self._stage(self.temp1, *nchw, sigma).permute(0, 2, 3, 1)

    def triplet_stage2(self, prev: Tensor, cur: Tensor, nxt: Tensor,
                       sigma: Tensor | float) -> Tensor:
        """``temp2`` fusing three consecutive ``temp1`` outputs ``(N, H, W, C)``."""
        nchw = (t.permute(0, 3, 1, 2) for t in (prev, cur, nxt))
        return self._stage(self.temp2, *nchw, sigma).permute(0, 2, 3, 1)

    def seq_circular(self, frames: Tensor, sigma: Tensor | float) -> Tensor:
        """Denoise a circular B-frame sequence ``(B, H, W, C) -> (B, H, W, C)``.

        Equal to gathering the B circular 5-frame windows and calling
        :meth:`forward` per window, with ``temp1`` run once per distinct
        triplet. For frozen BatchNorm (eval mode) only."""
        x = frames.permute(0, 3, 1, 2)
        t1 = self._stage(self.temp1, torch.roll(x, 1, 0), x, torch.roll(x, -1, 0), sigma)
        out = self._stage(self.temp2, torch.roll(t1, 1, 0), t1, torch.roll(t1, -1, 0), sigma)
        return out.permute(0, 2, 3, 1)


class SpatialDnCNN(nn.Module):
    """Single-frame spatial U-Net denoiser: the reference's dormant
    ``spatialDnCNN`` (``packages/fastdvdnet/models.py:92-144``; defined in the
    model file but on no driver path).

    The vocabulary of one :class:`DenBlock` (scopes ``inc``, ``downc0``,
    ``downc1``, ``upc2``, ``upc1``, ``outc``): a one-frame input conv (30
    intermediate channels), a (32, 64, 128) down/up U-Net, and the residual
    ``in - f(in, sigma)`` in float32. ``(N, H, W, C)`` frames and a scalar or
    ``(N,)`` sigma -> ``(N, H, W, C)``; NCHW inside.
    """

    def __init__(self, num_color_channels: int = 3,
                 chs: tuple[int, int, int] = (32, 64, 128), dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.inc = InputCvBlock(1, chs[0], num_color_channels=num_color_channels, dtype=dtype)
        self.downc0 = DownBlock(chs[0], chs[1], dtype)
        self.downc1 = DownBlock(chs[1], chs[2], dtype)
        self.upc2 = UpBlock(chs[2], chs[1], dtype)
        self.upc1 = UpBlock(chs[1], chs[0], dtype)
        self.outc = OutputCvBlock(chs[0], num_color_channels, dtype)

    def forward(self, x: Tensor, sigma: Tensor | float) -> Tensor:
        frame = x.permute(0, 3, 1, 2)
        inp = torch.cat([frame, FastDVDnet._noise_map(frame, sigma)], dim=1)
        if self.dtype is not None:
            inp = inp.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x0 = self.inc(inp)
        x1 = self.downc0(x0)
        x2 = self.upc2(self.downc1(x1))
        x1 = self.upc1(x1 + x2)
        out = self.outc(x0 + x1)
        return (frame.float() - out.float()).permute(0, 2, 3, 1)
