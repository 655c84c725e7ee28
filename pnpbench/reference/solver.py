"""Plain PyTorch reference of the reconstruction: the CACTI forward model on
packed RGGB planes, the GAP-TV warm start with Chambolle's TV prox, the
two-stage plug-and-play ADMM with Malvar demosaicking, and the online
adaptation of the denoiser by Adam on the measurement-consistency loss.

Written from the published algorithms (Yuan 2016 GAP-TV; Chambolle 2004;
Malvar, He & Cutler 2004; the adaptive PnP-SCI two-stage ADMM of
xyvirtualgroup/AdaptivePnP_SCI) as plain tensor operations, with the same
constants and update order as the measured solver, so that the same inputs
give the same numbers up to rounding. Nothing here runs a custom kernel.
The denoiser is a callable ``(params, rgb (B, H, W, 3), sigma) -> rgb``
over a dict of tensors.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

#: RGGB plane offsets, plane order [R, G1, G2, B]
BAYER_OFFSETS = ((0, 0), (0, 1), (1, 0), (1, 1))
TV_TAU = 0.25
TV_EPS = 2.0e-4
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


# ----------------------------------------------------------------- layout

def pack(x: Tensor) -> Tensor:
    """Mosaic ``(..., H, W)`` -> packed planes ``(..., 4, H/2, W/2)``."""
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // 2, 2, w // 2, 2)
    return torch.movedim(x, (-3, -1), (-4, -3)).reshape(*lead, 4, h // 2, w // 2)


def unpack(p: Tensor) -> Tensor:
    """Packed planes ``(..., 4, H/2, W/2)`` -> mosaic ``(..., H, W)``."""
    *lead, _, h2, w2 = p.shape
    x = torch.movedim(p.reshape(*lead, 2, 2, h2, w2), (-4, -3), (-3, -1))
    return x.reshape(*lead, h2 * 2, w2 * 2)


def cfa(h: int, w: int, dtype: torch.dtype, device: torch.device) -> Tensor:
    """RGGB colour-filter masks ``(H, W, 3)``."""
    m = torch.zeros(h, w, 3, dtype=dtype, device=device)
    for ch, (oy, ox) in zip((0, 1, 1, 2), BAYER_OFFSETS):
        m[oy::2, ox::2, ch] = 1
    return m


def mosaic(rgb: Tensor) -> Tensor:
    """RGB ``(..., H, W, 3)`` -> Bayer mosaic ``(..., H, W)``."""
    return torch.sum(rgb * cfa(rgb.shape[-3], rgb.shape[-2], rgb.dtype, rgb.device), dim=-1)


# ---------------------------------------------------------- forward model

def phi_sum(phi_p: Tensor) -> Tensor:
    """``sum_t phi_t`` over the frame axis, 1 where no frame samples."""
    s = phi_p.sum(0)
    return torch.where(s == 0, torch.ones_like(s), s)


def gap_x_update(theta: Tensor, b: Tensor, y_p: Tensor, phi_p: Tensor, phi_s: Tensor,
                 gamma: float) -> Tensor:
    """GAP projection: ``p = theta + b``, ``x = p + phi (y - A p) / (gamma + phi_sum)``."""
    p = theta + b
    return p + phi_p * ((y_p - (p * phi_p).sum(0)) / (gamma + phi_s))


def admm_x_update(theta: Tensor, b: Tensor, y_p: Tensor, phi_p: Tensor, phi_s: Tensor,
                  rho: float, alpha: float) -> Tensor:
    """ADMM x-update: ``p = theta - b / rho``, ``x = p + phi (y - A p) / (alpha rho + phi_sum)``."""
    p = theta - b / rho
    return p + phi_p * ((y_p - (p * phi_p).sum(0)) / (alpha * rho + phi_s))


# ------------------------------------------------------------ TV prox

def tv_chambolle(planes: Tensor, weight: float, max_iter: int) -> tuple[Tensor, Tensor]:
    """Chambolle's dual projection on each plane of ``(N, H, W)``, with
    scikit-image's energy stop: a plane stops once ``|E_prev - E| < eps *
    E_init`` (energies summed in float64). Returns ``(out, iterations per
    plane)``."""
    img = planes
    n, h, w = img.shape
    py = torch.zeros_like(img)
    px = torch.zeros_like(img)
    out = img.clone()
    active = torch.ones(n, dtype=torch.bool, device=img.device)
    iters = torch.zeros(n, dtype=torch.int64, device=img.device)
    e_init = e_prev = torch.zeros(n, dtype=torch.float64, device=img.device)
    for i in range(max_iter):
        if i > 0 and not bool(active.any()):
            break
        if i > 0:
            d = -(py + px)
            d[:, 1:, :] += py[:, :-1, :]
            d[:, :, 1:] += px[:, :, :-1]
        else:
            d = torch.zeros_like(img)
        new_out = img + d
        gy = torch.zeros_like(img)
        gx = torch.zeros_like(img)
        gy[:, :-1, :] = new_out[:, 1:, :] - new_out[:, :-1, :]
        gx[:, :, :-1] = new_out[:, :, 1:] - new_out[:, :, :-1]
        norm = torch.sqrt(gy * gy + gx * gx)
        e = ((d.double() ** 2).sum((1, 2)) + weight * norm.double().sum((1, 2))) / (h * w)
        coef = norm * (TV_TAU / weight) + 1.0
        sel = active[:, None, None]
        out = torch.where(sel, new_out, out)
        py = torch.where(sel, (py - TV_TAU * gy) / coef, py)
        px = torch.where(sel, (px - TV_TAU * gx) / coef, px)
        iters = iters + active.to(torch.int64)
        if i == 0:
            e_init = e
        else:
            active = active & ~((e_prev - e).abs() < TV_EPS * e_init)
        e_prev = torch.where(active, e, e_prev)
    return out, iters


class WarmStart(NamedTuple):
    x_p: Tensor          # packed (B, 4, H/2, W/2), float32
    tv_iterations: float  # mean iterations a plane ran per TV call


def gap_tv(y: Tensor, phi: Tensor, iters: int, tv_weight: float = 0.1, tv_iters: int = 5,
           gamma: float = 0.01, dtype: torch.dtype = torch.float32) -> WarmStart:
    """GAP-TV from ``At(y)``: ``iters`` rounds of the GAP x-update, the TV
    prox of every packed plane, the clip to [0, 1] and the dual update.
    ``y (H, W)``, ``phi (B, H, W)``; the state is held in ``dtype``."""
    y_p = pack(y.to(dtype))
    phi_p = pack(phi.to(dtype))
    phi_s = phi_sum(phi_p)
    x = theta = phi_p * y_p[None]
    b = torch.zeros_like(x)
    total = 0.0
    for _ in range(iters):
        x = gap_x_update(theta, b, y_p, phi_p, phi_s, gamma)
        xb = x - b
        out, it = tv_chambolle(xb.reshape(-1, *xb.shape[-2:]), tv_weight, tv_iters)
        total += float(it.double().mean())
        theta = torch.clamp(out.reshape(xb.shape), 0.0, 1.0)
        b = b - (x - theta)
    return WarmStart(x.float(), total / max(iters, 1))


# ------------------------------------------------------------- demosaic

_K_G = np.array([[0, 0, -1, 0, 0], [0, 0, 2, 0, 0], [-1, 2, 4, 2, -1], [0, 0, 2, 0, 0],
                 [0, 0, -1, 0, 0]], np.float32) / 8.0
_K_RB_ROW = np.array([[0, 0, 0.5, 0, 0], [0, -1, 0, -1, 0], [-1, 4, 5, 4, -1],
                      [0, -1, 0, -1, 0], [0, 0, 0.5, 0, 0]], np.float32) / 8.0
_K_RB_DIAG = np.array([[0, 0, -1.5, 0, 0], [0, 2, 0, 2, 0], [-1.5, 0, 6, 0, -1.5],
                       [0, 2, 0, 2, 0], [0, 0, -1.5, 0, 0]], np.float32) / 8.0


def malvar(cfa_img: Tensor) -> Tensor:
    """Malvar-He-Cutler demosaic of RGGB mosaics ``(B, H, W) -> (B, H, W, 3)``:
    the four 5x5 filters as a reflect-padded shift-add in float32, in
    row-major tap order."""
    h, w = cfa_img.shape[-2:]
    bank = np.stack([_K_G, _K_RB_ROW, _K_RB_ROW.T, _K_RB_DIAG])
    xp = F.pad(cfa_img.float()[:, None], (2, 2, 2, 2), mode="reflect")[:, 0]
    outs = [torch.zeros_like(cfa_img, dtype=torch.float32) for _ in range(4)]
    for i in range(5):
        for j in range(5):
            window = xp[:, i:i + h, j:j + w]
            for t in range(4):
                if bank[t, i, j] != 0:
                    outs[t] = outs[t] + float(bank[t, i, j]) * window
    g_conv, rb_row, rb_col, rb_diag = outs
    dev = cfa_img.device
    yy = torch.arange(h, device=dev)[:, None] % 2
    xx = torch.arange(w, device=dev)[None, :] % 2
    r_site = (yy == 0) & (xx == 0)
    b_site = (yy == 1) & (xx == 1)
    g_site = ~(r_site | b_site)
    red_row = yy == 0
    r = torch.where(r_site, cfa_img, torch.zeros_like(cfa_img))
    g = torch.where(g_site, cfa_img, g_conv)
    b = torch.where(b_site, cfa_img, torch.zeros_like(cfa_img))
    g_in_r_row = g_site & red_row      # red row, blue column
    g_in_b_row = g_site & ~red_row     # blue row, red column
    r = torch.where(g_in_r_row, rb_row, r)
    r = torch.where(g_in_b_row, rb_col, r)
    b = torch.where(g_in_b_row, rb_row, b)
    b = torch.where(g_in_r_row, rb_col, b)
    r = torch.where(b_site, rb_diag, r)
    b = torch.where(r_site, rb_diag, b)
    return torch.stack([r, g, b], dim=-1)


# ----------------------------------------------------------- the solver

class Schedule(NamedTuple):
    """The deep stage's schedule (sigmas in [0, 1])."""

    sigma: tuple[float, ...]
    iters: tuple[int, ...]
    rho: float
    tau: float
    alpha: float
    lr: float
    update_per_iter: int
    interval_iter: int
    initial_iter: int


def adapt_mask(s: Schedule) -> list[bool]:
    """Iterations at which the denoiser adapts: ``k > initial_iter`` and
    ``k % interval_iter == 0``."""
    total = sum(s.iters)
    return [k > s.initial_iter and k % s.interval_iter == 0 for k in range(total)]


def _adam(params: dict[str, Tensor], grads: dict[str, Tensor], state: dict, lr: float) -> None:
    """One step of Adam (Kingma & Ba; PyTorch's arrangement of it) in place."""
    b1, b2 = ADAM_BETAS
    state["t"] = t = state.get("t", 0) + 1
    for k, g in grads.items():
        m = state.setdefault(("m", k), torch.zeros_like(g))
        v = state.setdefault(("v", k), torch.zeros_like(g))
        m.lerp_(g, 1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = v.sqrt() / (1 - b2 ** t) ** 0.5 + ADAM_EPS
        params[k].data.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


class Reconstruction(NamedTuple):
    x_bayer: Tensor              # (B, H, W)
    params: dict[str, Tensor]    # the denoiser's parameters after adaptation
    tv_iterations: float         # of the warm start


Denoiser = Callable[[Mapping[str, Tensor], Tensor, Tensor], Tensor]


def reconstruct(y: Tensor, phi: Tensor, warm_iters: int, s: Schedule, denoise: Denoiser,
                params: Mapping[str, Tensor], trainable: list[str], loss_mode: str,
                noise_std: float, generator: torch.Generator | None) -> Reconstruction:
    """GAP-TV warm start, then the two-stage ADMM with online adaptation.

    Each iteration: the x-update on packed planes, Malvar on ``x + b/rho``,
    the RGB dual correction, the adaptation when the schedule fires (Adam
    steps on the measurement-consistency loss of the denoised, re-mosaicked
    input, noise of ``noise_std`` added to that input first, drawn from
    ``generator`` as one ``(1, B, H, W, 3)`` normal tensor), the denoiser,
    the re-mosaic into theta with the clip to [0, 1], and the two dual
    updates. ``loss_mode``: ``packed4`` (loss on packed planes) or
    ``bayer1`` (on the full mosaic)."""
    y = y.float()
    phi = phi.float()
    warm = gap_tv(y, phi, warm_iters)
    y_p, phi_p = pack(y), pack(phi)
    phi_s = phi_sum(phi_p)
    p = {k: v.detach().clone() for k, v in params.items()}
    sigmas = torch.tensor(np.concatenate([np.full(n, sg, np.float32)
                                          for sg, n in zip(s.sigma, s.iters)]), device=y.device)
    fire = adapt_mask(s)
    b_frames = phi.shape[0]
    h, w = y.shape
    x = theta = warm.x_p
    b = torch.zeros_like(theta)
    w_dual = torch.zeros(b_frames, h, w, 3, device=y.device)
    for k in range(len(fire)):
        sigma = sigmas[k]
        x = admm_x_update(theta, b, y_p, phi_p, phi_s, s.rho, s.alpha)
        x_rgb = malvar(unpack(x + b / s.rho))
        x_rgb_w = x_rgb - w_dual / s.tau
        if fire[k]:
            inp = x_rgb_w
            if noise_std > 0:
                noise = torch.randn((1, b_frames, h, w, 3), generator=generator,
                                    dtype=torch.float32, device=generator.device)
                inp = inp + noise_std * noise[0].to(inp.device)
            inp = inp.detach()
            state: dict = {}
            for _ in range(s.update_per_iter):
                leaves = {k2: p[k2].detach().requires_grad_(True) for k2 in trainable}
                cur = {**p, **leaves}
                with torch.enable_grad():
                    out = denoise(cur, inp, sigma)
                    if loss_mode == "packed4":
                        pred = (pack(mosaic(out)) * phi_p).sum(0)
                        loss = torch.mean((pred - y_p) ** 2)
                    else:
                        pred = (mosaic(out) * phi).sum(0)
                        loss = torch.mean((pred - y) ** 2)
                    grads = torch.autograd.grad(loss, [leaves[k2] for k2 in trainable])
                for k2, leaf in leaves.items():
                    p[k2] = leaf.detach()
                _adam(p, dict(zip(trainable, grads)), state, s.lr)
        with torch.no_grad():
            xhat = denoise(p, x_rgb_w, sigma)
        theta = torch.clamp(pack(mosaic(xhat)), 0.0, 1.0)
        b = b + (x - theta)
        w_dual = w_dual + (x_rgb - xhat)
    return Reconstruction(unpack(theta), p, warm.tv_iterations)
