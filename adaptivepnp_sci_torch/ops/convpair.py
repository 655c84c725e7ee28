"""The CvBlock conv pair in low precision, plain PyTorch version
(port of ``xla_convpair`` of ``scripts/ab_pallas_convpair.py``).

``relu(s2 * conv3x3(relu(s1 * conv3x3(x, w1) + b1), w2) + b2)``: both
convolutions zero-padded by 1, BatchNorm folded into a per-channel scale and
shift, products of bf16 values summed in float32, the scale, shift and ReLU in
float32, the intermediate and the result rounded to bf16. It is the unit that
FastDVDnet's U-Net repeats, and what ``csrc/convpair.cu`` fuses into one
kernel; :func:`adaptivepnp_sci_torch.ops.cuda_kernels.convpair` routes CUDA
tensors to that kernel and CPU tensors here.

Layout at this interface is the JAX script's: activations ``(N, H, W, C)``,
kernels ``(3, 3, Cin, Cout)``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor


def fold_bn(bn: nn.BatchNorm2d) -> tuple[Tensor, Tensor]:
    """Eval-mode BatchNorm as ``y = s * x + b`` in float32:
    ``s = gamma / sqrt(var + eps)``, ``b = beta - mean * s``. Differentiable
    in ``gamma`` and ``beta``."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return s, bn.bias.float() - bn.running_mean.float() * s


def conv2d_lowp(x: Tensor, weight: Tensor, stride: int = 1, groups: int = 1) -> Tensor:
    """3x3 convolution (zero padding 1, no bias) of NCHW ``x`` in the low
    precision type of ``x``: exact products summed in float32, the sum
    rounded once. On the card the library's low-precision convolution does
    that; on the CPU the same arithmetic is a float32 convolution of the
    upcast values, rounded at the end (the CPU's own bf16 convolution is a
    slow reference loop)."""
    weight = weight.to(x.dtype)
    if x.device.type == "cpu":
        return F.conv2d(x.float(), weight.float(), None, stride, 1, 1, groups).to(x.dtype)
    return F.conv2d(x, weight, None, stride, 1, 1, groups)


def scale_shift_relu(x: Tensor, s: Tensor, b: Tensor) -> Tensor:
    """``relu(s * x + b)`` per channel of NCHW ``x`` in float32, rounded back
    to the type of ``x``."""
    y = x.float() * s.reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1)
    return torch.relu(y).to(x.dtype)


def convpair(x: Tensor, w1: Tensor, s1: Tensor, b1: Tensor,
             w2: Tensor, s2: Tensor, b2: Tensor) -> Tensor:
    """The conv pair on ``x (N, H, W, C)`` with kernels ``(3, 3, C, C)`` and
    float32 ``s``, ``b`` of ``C`` elements each; returns ``(N, H, W, C)`` in
    the type of ``x``. Differentiable."""
    v = x.permute(0, 3, 1, 2)
    v = scale_shift_relu(conv2d_lowp(v, w1.permute(3, 2, 0, 1)), s1, b1)
    v = scale_shift_relu(conv2d_lowp(v, w2.permute(3, 2, 0, 1)), s2, b2)
    return v.permute(0, 2, 3, 1)
