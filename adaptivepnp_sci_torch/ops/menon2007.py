"""Menon 2007 (DDFAPD) directional demosaicing, batched over frames
(port of ``adaptivepnp_sci_tpu.ops.menon2007``).

D. Menon, S. Andriani, G. Calvagno, "Demosaicing with directional filtering
and a posteriori decision", IEEE TIP 2007: directional green interpolation
(horizontal / vertical FIR), the decision by chrominance-gradient
classifiers, R/B reconstruction, and the optional refining step. scipy
``convolve`` semantics are kept: a true convolution (the kernel flipped),
mirror padding for the 1-D filters and zero padding for the classifier. Sums
run in the JAX package's order, over the kernels' float32 values, in the
input's dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from adaptivepnp_sci_torch.ops.bayer import cfa_masks

_H0 = np.array([0, 0.5, 0, 0.5, 0], np.float32)
_H1 = np.array([-0.25, 0, 0.5, 0, -0.25], np.float32)
_KB = np.array([0.5, 0, 0.5], np.float32)
_FIR = np.ones(3, np.float32) / 3

# the classifier kernel; scipy.convolve flips it, so it is stored flipped for
# a correlation
_K = np.array(
    [[0, 0, 1, 0, 1],
     [0, 0, 0, 1, 0],
     [0, 0, 3, 0, 3],
     [0, 0, 0, 1, 0],
     [0, 0, 1, 0, 1]], np.float32)
_K_FLIP = _K[::-1, ::-1].copy()
_KT_FLIP = _K.T[::-1, ::-1].copy()


def _reflect(x: Tensor, dim: int, before: int, after: int) -> Tensor:
    """``numpy.pad(mode="reflect")`` along ``dim``, for any pad width (a pad
    wider than the axis reflects again, as numpy's does)."""
    n = x.shape[dim]
    i = np.arange(-before, n + after)
    if n > 1:
        i = i % (2 * (n - 1))
        i = np.where(i >= n, 2 * (n - 1) - i, i)
    else:
        i = np.zeros_like(i)
    return x.index_select(dim, torch.as_tensor(i, device=x.device))


def _cnv_h(x: Tensor, kern: np.ndarray) -> Tensor:
    """1-D horizontal correlation of frames ``(B, H, W)``, mirror padding
    (the kernels are symmetric, so this is the convolution)."""
    p = len(kern) // 2
    xp = _reflect(x, -1, p, p)
    w = x.shape[-1]
    return sum(float(kern[i]) * xp[..., i:i + w] for i in range(len(kern)))


def _cnv_v(x: Tensor, kern: np.ndarray) -> Tensor:
    p = len(kern) // 2
    xp = _reflect(x, -2, p, p)
    h = x.shape[-2]
    return sum(float(kern[i]) * xp[..., i:i + h, :] for i in range(len(kern)))


def _cnv2_zero(x: Tensor, kern: np.ndarray) -> Tensor:
    """2-D correlation with zero padding (``kern`` already flipped)."""
    kh, kw = kern.shape
    h, w = x.shape[-2:]
    xp = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2))
    out = torch.zeros_like(x)
    for i in range(kh):
        for j in range(kw):
            if kern[i, j] != 0:
                out = out + float(kern[i, j]) * xp[..., i:i + h, j:j + w]
    return out


def _masks(shape: tuple[int, int], pattern: str, device: torch.device) -> dict[str, Tensor]:
    """The CFA masks and the rows / columns that hold red or blue sites."""
    masks = cfa_masks(shape, pattern)
    r_m, g_m, b_m = masks[..., 0], masks[..., 1], masks[..., 2]
    h, w = shape
    out = {
        "r": r_m, "g": g_m, "b": b_m,
        "r_r": r_m.any(axis=1)[:, None] & np.ones((1, w), bool),
        "r_c": r_m.any(axis=0)[None, :] & np.ones((h, 1), bool),
        "b_r": b_m.any(axis=1)[:, None] & np.ones((1, w), bool),
        "b_c": b_m.any(axis=0)[None, :] & np.ones((h, 1), bool),
    }
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in out.items()}


def _refine(r: Tensor, g: Tensor, b: Tensor, mk: dict[str, Tensor], m: Tensor
            ) -> tuple[Tensor, Tensor, Tensor]:
    """The refining step (``refining_step_Menon2007``)."""
    r_m, g_m, b_m = mk["r"], mk["g"], mk["b"]
    zero = torch.zeros((), dtype=r.dtype, device=r.device)

    r_g = r - g
    b_g = b - g
    b_g_m = torch.where(b_m, torch.where(m, _cnv_h(b_g, _FIR), _cnv_v(b_g, _FIR)), zero)
    r_g_m = torch.where(r_m, torch.where(m, _cnv_h(r_g, _FIR), _cnv_v(r_g, _FIR)), zero)
    g = torch.where(r_m, r - r_g_m, g)
    g = torch.where(b_m, b - b_g_m, g)

    r_g = r - g
    b_g = b - g

    r_g_m = torch.where(g_m & mk["b_r"], _cnv_v(r_g, _KB), r_g_m)
    r = torch.where(g_m & mk["b_r"], g + r_g_m, r)
    r_g_m = torch.where(g_m & mk["b_c"], _cnv_h(r_g, _KB), r_g_m)
    r = torch.where(g_m & mk["b_c"], g + r_g_m, r)

    b_g_m = torch.where(g_m & mk["r_r"], _cnv_v(b_g, _KB), b_g_m)
    b = torch.where(g_m & mk["r_r"], g + b_g_m, b)
    b_g_m = torch.where(g_m & mk["r_c"], _cnv_h(b_g, _KB), b_g_m)
    b = torch.where(g_m & mk["r_c"], g + b_g_m, b)

    # both the R and the B update read the same chrominance R - B
    r_b = r - b
    r_b_m = torch.where(b_m, torch.where(m, _cnv_h(r_b, _FIR), _cnv_v(r_b, _FIR)), zero)
    r = torch.where(b_m, b + r_b_m, r)
    r_b_m = torch.where(r_m, torch.where(m, _cnv_h(r_b, _FIR), _cnv_v(r_b, _FIR)), zero)
    b = torch.where(r_m, r - r_b_m, b)
    return r, g, b


def menon2007(cfa: Tensor, pattern: str = "RGGB", refining_step: bool = True) -> Tensor:
    """Directional demosaic, batched: ``(B, H, W) -> (B, H, W, 3)``, in the
    input's floating dtype (integers become float32). The H/V decision
    ``d_V >= d_H`` can tie within float32 precision on synthetic data; float64
    inputs carry the reference's precision."""
    if not cfa.is_floating_point():
        cfa = cfa.to(torch.float32)
    mk = _masks(tuple(cfa.shape[-2:]), pattern.upper(), cfa.device)
    r_m, g_m, b_m = mk["r"], mk["g"], mk["b"]
    zero = torch.zeros((), dtype=cfa.dtype, device=cfa.device)

    r = cfa * r_m
    g = cfa * g_m
    b = cfa * b_m

    g_h = torch.where(~g_m, _cnv_h(cfa, _H0) + _cnv_h(cfa, _H1), g)
    g_v = torch.where(~g_m, _cnv_v(cfa, _H0) + _cnv_v(cfa, _H1), g)

    c_h = torch.where(r_m, r - g_h, zero)
    c_h = torch.where(b_m, b - g_h, c_h)
    c_v = torch.where(r_m, r - g_v, zero)
    c_v = torch.where(b_m, b - g_v, c_v)

    d_h = torch.abs(c_h - _reflect(c_h, -1, 0, 2)[..., 2:])
    d_v = torch.abs(c_v - _reflect(c_v, -2, 0, 2)[..., 2:, :])

    dd_h = _cnv2_zero(d_h, _K_FLIP)
    dd_v = _cnv2_zero(d_v, _KT_FLIP)

    m = dd_v >= dd_h
    g = torch.where(m, g_h, g_v)

    r_r, b_r = mk["r_r"], mk["b_r"]
    r = torch.where(g_m & r_r, g + _cnv_h(r, _KB) - _cnv_h(g, _KB), r)
    r = torch.where(g_m & b_r, g + _cnv_v(r, _KB) - _cnv_v(g, _KB), r)
    b = torch.where(g_m & b_r, g + _cnv_h(b, _KB) - _cnv_h(g, _KB), b)
    b = torch.where(g_m & r_r, g + _cnv_v(b, _KB) - _cnv_v(g, _KB), b)

    r = torch.where(
        b_r & b_m,
        torch.where(m, b + _cnv_h(r, _KB) - _cnv_h(b, _KB),
                    b + _cnv_v(r, _KB) - _cnv_v(b, _KB)),
        r,
    )
    b = torch.where(
        r_r & r_m,
        torch.where(m, r + _cnv_h(b, _KB) - _cnv_h(r, _KB),
                    r + _cnv_v(b, _KB) - _cnv_v(r, _KB)),
        b,
    )

    if refining_step:
        r, g, b = _refine(r, g, b, mk, m)
    return torch.stack([r, g, b], dim=-1)
