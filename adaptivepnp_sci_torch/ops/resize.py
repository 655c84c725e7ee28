"""MATLAB-compatible bicubic image resize (port of
``adaptivepnp_sci_tpu.ops.resize``).

The KAIR ``imresize`` (MATLAB's cubic kernel with antialiasing when
shrinking), used for multiscale training data. The interpolation weights are
dense ``(out, in)`` matrices built once per size on the host, so a resize is
two matrix products on the tensor's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import Tensor


def _cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB's cubic interpolation kernel (Keys, a = -0.5)."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return (1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2
    ) * ((ax > 1) & (ax <= 2))


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_len: int, out_len: int, antialias: bool = True) -> np.ndarray:
    """Dense (out_len, in_len) weight matrix with MATLAB edge replication."""
    scale = out_len / in_len
    kernel_width = 4.0
    if scale < 1 and antialias:
        kernel_width /= scale

    # output sample o maps to input coordinate (o + 0.5)/scale - 0.5
    x = (np.arange(out_len) + 0.5) / scale - 0.5
    left = np.floor(x - kernel_width / 2).astype(int)
    p = int(np.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(p)[None, :]
    dist = x[:, None] - idx
    if scale < 1 and antialias:
        w = scale * _cubic(dist * scale)
    else:
        w = _cubic(dist)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    idx = np.clip(idx, 0, in_len - 1)  # replicate borders

    mat = np.zeros((out_len, in_len), np.float32)
    for o in range(out_len):
        np.add.at(mat[o], idx[o], w[o])
    return mat


def imresize(img: Tensor | np.ndarray, scale: float | None = None,
             out_shape: tuple[int, int] | None = None,
             antialias: bool = True) -> Tensor:
    """Resize ``(..., H, W, C)`` or ``(H, W)`` with MATLAB bicubic semantics,
    in float32 on the tensor's device (a NumPy array is taken as a CPU
    tensor)."""
    img = torch.as_tensor(img)
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[-3], img.shape[-2]
    if out_shape is None:
        out_shape = (int(np.ceil(h * scale)), int(np.ceil(w * scale)))
    mh = torch.from_numpy(_resize_matrix(h, out_shape[0], antialias)).to(img.device)
    mw = torch.from_numpy(_resize_matrix(w, out_shape[1], antialias)).to(img.device)
    out = torch.einsum("oh,...hwc->...owc", mh, img.float())
    out = torch.einsum("pw,...owc->...opc", mw, out)
    return out[..., 0] if squeeze else out
