"""Host-side image metrics, KAIR/MATLAB semantics in the 0-255 domain
(port of ``calculate_psnr`` / ``calculate_ssim`` of
``adaptivepnp_sci_tpu.utils.image``; NumPy only).

PSNR from the mean squared error against a peak of 255; SSIM with an 11x11
gaussian window of sigma 1.5 over the valid region, averaged over channels
and images. The on-device metrics are in :mod:`adaptivepnp_sci_torch.ops.metrics`.
"""

from __future__ import annotations

import numpy as np


def shave(img: np.ndarray, border: int = 0) -> np.ndarray:
    if border == 0:
        return img
    return img[border:-border, border:-border].copy()


def calculate_psnr(img1: np.ndarray, img2: np.ndarray, border: int = 0) -> float:
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    img1 = shave(np.asarray(img1, np.float64), border)
    img2 = shave(np.asarray(img2, np.float64), border)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(255.0 / np.sqrt(mse)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def _filter2_valid(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    """'valid' 2-D correlation with a small window."""
    kh, kw = window.shape
    h, w = img.shape
    shape = (h - kh + 1, w - kw + 1, kh, kw)
    patches = np.lib.stride_tricks.as_strided(img, shape, img.strides * 2)
    return np.einsum("hwkl,kl->hw", patches, window)


def ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    """MATLAB-style single-channel SSIM, 0-255 domain, 11x11 gaussian
    window sigma=1.5, valid region only."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    win = _gaussian_window()
    mu1 = _filter2_valid(img1, win)
    mu2 = _filter2_valid(img2, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _filter2_valid(img1 ** 2, win) - mu1_sq
    s2 = _filter2_valid(img2 ** 2, win) - mu2_sq
    s12 = _filter2_valid(img1 * img2, win) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray, border: int = 0) -> float:
    """Mean per-channel SSIM over (H, W), (H, W, C) or (N, H, W, C)."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    img1, img2 = np.asarray(img1), np.asarray(img2)
    if border:
        img1, img2 = shave(img1, border), shave(img2, border)
    if img1.ndim == 2:
        return ssim_single(img1, img2)
    if img1.ndim == 3:
        return float(np.mean([ssim_single(img1[..., c], img2[..., c])
                              for c in range(img1.shape[-1])]))
    if img1.ndim == 4:
        return float(np.mean([calculate_ssim(img1[i], img2[i]) for i in range(img1.shape[0])]))
    raise ValueError("Wrong input image dimensions.")
