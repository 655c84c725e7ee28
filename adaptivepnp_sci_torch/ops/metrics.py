"""Image-quality metrics, PSNR and SSIM (port of ``adaptivepnp_sci_tpu.ops.metrics``).

``ssim`` reproduces ``skimage.metrics.structural_similarity`` defaults for
2-D float inputs with an explicit ``data_range``: 7x7 uniform window, sample
covariance normalization ``N/(N-1)``, K1=0.01 / K2=0.03, and a ``win//2``
border crop before averaging. The uniform filter is the JAX package's
cumulative-sum form, not a pooling op, so it rounds the same way.
"""

from __future__ import annotations

import torch
from torch import Tensor


def psnr(ref: Tensor, img: Tensor, data_range: float = 1.0) -> Tensor:
    """Peak signal-to-noise ratio in dB over the whole array."""
    mse = torch.mean((ref.to(torch.float32) - img.to(torch.float32)) ** 2)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def psnr_per_frame(ref: Tensor, img: Tensor, data_range: float = 1.0) -> Tensor:
    """PSNR of each leading-axis frame, ``(B, ...) -> (B,)``."""
    d = ref.to(torch.float32) - img.to(torch.float32)
    mse = torch.mean((d**2).reshape(d.shape[0], -1), dim=1)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def _uniform_filter_2d(x: Tensor, win: int) -> Tensor:
    """Mean filter over the last two axes via separable cumulative sums, with
    edge-replicate padding; only ``win//2``-interior pixels are exact, which
    is all :func:`ssim` consumes after its border crop."""
    pad = win // 2

    def filt1d(a: Tensor, axis: int) -> Tensor:
        a = torch.movedim(a, axis, 0)
        a = torch.cat([a[:1].repeat_interleave(pad, 0), a,
                       a[-1:].repeat_interleave(pad, 0)], dim=0)
        c = torch.cumsum(a, dim=0)
        c = torch.cat([torch.zeros_like(c[:1]), c], dim=0)
        out = (c[win:] - c[:-win]) / win
        return torch.movedim(out, 0, axis)

    return filt1d(filt1d(x, -2), -1)


def _ssim_map(x: Tensor, y: Tensor, data_range: float, win_size: int) -> Tensor:
    ndp = win_size**2
    cov_norm = ndp / (ndp - 1)

    ux = _uniform_filter_2d(x, win_size)
    uy = _uniform_filter_2d(y, win_size)
    uxx = _uniform_filter_2d(x * x, win_size)
    uyy = _uniform_filter_2d(y * y, win_size)
    uxy = _uniform_filter_2d(x * y, win_size)

    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    pad = (win_size - 1) // 2
    return s[..., pad:-pad, pad:-pad]


def ssim(ref: Tensor, img: Tensor, data_range: float = 1.0, win_size: int = 7) -> Tensor:
    """Mean structural similarity of two 2-D images (skimage-compatible)."""
    s = _ssim_map(ref.to(torch.float32), img.to(torch.float32), data_range, win_size)
    return torch.mean(s)


def ssim_per_frame(ref: Tensor, img: Tensor, data_range: float = 1.0) -> Tensor:
    """SSIM of each leading-axis frame, ``(B, H, W) -> (B,)``."""
    s = _ssim_map(ref.to(torch.float32), img.to(torch.float32), data_range, 7)
    return torch.mean(s.reshape(s.shape[0], -1), dim=1)
