"""Classical CFA demosaicing, Malvar 2004 and bilinear
(port of ``adaptivepnp_sci_tpu.ops.demosaic``).

Each kernel bank is a reflect-padded shift-add in float32, as in the JAX
package's ``_conv_bank``: a single-input-channel 5x5 correlation is a
degenerate convolution, and the shift-add keeps the sums in the same order
as the reference. ``F.pad(mode="reflect")`` has ``jnp.pad``'s edge semantics.

Kernels are the published constants from H.S. Malvar, L.-W. He, R. Cutler,
"High-quality linear interpolation for demosaicing of Bayer-patterned color
images", ICASSP 2004.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from adaptivepnp_sci_torch.ops.bayer import cfa_masks, mask_like

# Malvar 2004 interpolation kernels (x8).
_GR_GB = np.array(
    [[0, 0, -1, 0, 0],
     [0, 0, 2, 0, 0],
     [-1, 2, 4, 2, -1],
     [0, 0, 2, 0, 0],
     [0, 0, -1, 0, 0]], np.float32) / 8.0

_RG_RB_BG_BR = np.array(
    [[0, 0, 0.5, 0, 0],
     [0, -1, 0, -1, 0],
     [-1, 4, 5, 4, -1],
     [0, -1, 0, -1, 0],
     [0, 0, 0.5, 0, 0]], np.float32) / 8.0

_RB_BB_BR_RR = np.array(
    [[0, 0, -1.5, 0, 0],
     [0, 2, 0, 2, 0],
     [-1.5, 0, 6, 0, -1.5],
     [0, 2, 0, 2, 0],
     [0, 0, -1.5, 0, 0]], np.float32) / 8.0

# Bilinear kernels.
_BILINEAR_G = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]], np.float32) / 4.0
_BILINEAR_RB = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 4.0


def _conv_bank(x: Tensor, kernels: np.ndarray) -> list[Tensor]:
    """Reflect-pad + multi-kernel correlation:
    ``(B, H, W) x (K, kh, kw) -> K tensors (B, H, W)``."""
    k, kh, kw = kernels.shape
    pad = kh // 2
    h, w = x.shape[-2:]
    xp = F.pad(x.to(torch.float32)[:, None], (pad, pad, pad, pad), mode="reflect")[:, 0]
    outs = [torch.zeros_like(x, dtype=torch.float32) for _ in range(k)]
    for i in range(kh):
        for j in range(kw):
            col = kernels[:, i, j]
            if not np.any(col):
                continue
            window = xp[:, i : i + h, j : j + w]
            for t in range(k):
                if col[t] != 0:
                    outs[t] = outs[t] + float(col[t]) * window
    return outs


@functools.lru_cache(maxsize=16)
def _malvar_masks(h: int, w: int, pattern: str, device: torch.device) -> dict[str, Tensor]:
    """CFA and row/column parity masks on ``device``, cached: the solver
    demosaics every iteration, and a host->device copy of the masks each time
    would stall the stream."""
    masks = cfa_masks((h, w), pattern)  # (H, W, 3) bool
    r_m, g_m, b_m = masks[..., 0], masks[..., 1], masks[..., 2]
    # Row/column parity masks: rows/cols that contain red (resp. blue) sites.
    r_rows = r_m.any(axis=1)[:, None] & np.ones((1, w), bool)
    r_cols = r_m.any(axis=0)[None, :] & np.ones((h, 1), bool)
    b_rows = b_m.any(axis=1)[:, None] & np.ones((1, w), bool)
    b_cols = b_m.any(axis=0)[None, :] & np.ones((h, 1), bool)
    sel = {
        "rb": r_m | b_m,
        "rr_bc": r_rows & b_cols, "br_rc": b_rows & r_cols,
        "br_bc": b_rows & b_cols, "rr_rc": r_rows & r_cols,
    }
    out = {k: torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in sel.items()}
    for k, v in (("r", r_m), ("g", g_m), ("b", b_m)):
        out[k] = torch.as_tensor(v.astype(np.float32), device=device)
    return out


def malvar2004(cfa: Tensor, pattern: str = "RGGB") -> Tensor:
    """Malvar-He-Cutler demosaic, batched: ``(B, H, W) -> (B, H, W, 3)``."""
    h, w = cfa.shape[-2:]
    m = _malvar_masks(h, w, pattern, cfa.device)

    g_conv, rb_g1, rb_g2, rb_br = _conv_bank(
        cfa, np.stack([_GR_GB, _RG_RB_BG_BR, _RG_RB_BG_BR.T, _RB_BB_BR_RR])
    )

    r = cfa * m["r"]
    g = torch.where(m["rb"], g_conv, cfa * m["g"])
    b = cfa * m["b"]

    r = torch.where(m["rr_bc"], rb_g1, r)
    r = torch.where(m["br_rc"], rb_g2, r)
    b = torch.where(m["br_rc"], rb_g1, b)
    b = torch.where(m["rr_bc"], rb_g2, b)
    r = torch.where(m["br_bc"], rb_br, r)
    b = torch.where(m["rr_rc"], rb_br, b)

    return torch.stack([r, g, b], dim=-1)


def bilinear(cfa: Tensor, pattern: str = "RGGB") -> Tensor:
    """Bilinear demosaic, batched: ``(B, H, W) -> (B, H, W, 3)``."""
    planes = cfa[..., None] * mask_like(cfa, cfa.shape[-2:], pattern)  # (B, H, W, 3)
    r = _conv_bank(planes[..., 0], _BILINEAR_RB[None])[0]
    g = _conv_bank(planes[..., 1], _BILINEAR_G[None])[0]
    b = _conv_bank(planes[..., 2], _BILINEAR_RB[None])[0]
    return torch.stack([r, g, b], dim=-1)
