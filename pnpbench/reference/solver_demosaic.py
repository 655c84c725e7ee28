"""The reference's two-stage plug-and-play ADMM with its demosaic step as a
parameter: :func:`pnpbench.reference.solver.reconstruct`'s loop, whose
demosaic is Malvar, with any ``(B, H, W) -> (B, H, W, 3)`` step in its place
(the deep demosaicker of :mod:`pnpbench.reference.ddnet`, fixed weights).
The forward model, the warm start, the x-update, Adam and the schedule are
``solver``'s own, by import.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
from torch import Tensor

from pnpbench.reference.solver import (Denoiser, Reconstruction, Schedule, _adam, adapt_mask,
                                       admm_x_update, gap_tv, mosaic, pack, phi_sum, unpack)

Demosaicker = Callable[[Tensor], Tensor]


def reconstruct(y: Tensor, phi: Tensor, warm_iters: int, s: Schedule, denoise: Denoiser,
                demosaic: Demosaicker, params: Mapping[str, Tensor], trainable: list[str],
                loss_mode: str, noise_std: float, generator: torch.Generator | None
                ) -> Reconstruction:
    """GAP-TV warm start, then the two-stage ADMM with online adaptation of
    the denoiser, ``demosaic`` on ``x + b / rho`` in every iteration;
    otherwise as :func:`pnpbench.reference.solver.reconstruct`."""
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
        with torch.no_grad():
            x_rgb = demosaic(unpack(x + b / s.rho))
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
