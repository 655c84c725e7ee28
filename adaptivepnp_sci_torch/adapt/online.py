"""Online adaptation: fine-tune the denoiser against the measurement itself
(port of ``adaptivepnp_sci_tpu.adapt.online``).

Adam steps on ``MSE(A(mosaic(denoise(x))), y)`` interleave with the ADMM
iterations, fired on a per-iteration mask precomputed on the host
(:func:`make_schedule`) from the trigger rule
``k > initial_iter and k % interval_iter == 0`` and the update-count cap.

Each stage of each trigger builds a fresh ``torch.optim.Adam`` at the stage's
lr, as the reference does. The optimizer steps the solver's private copy of
the denoiser (:func:`adaptivepnp_sci_torch.solvers.priors.working_copy`),
never the caller's module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch
import torch.nn as nn
from torch import Tensor

from adaptivepnp_sci_torch.ops import bayer, physics

if TYPE_CHECKING:
    from adaptivepnp_sci_torch.solvers.priors import Prior


@dataclass(frozen=True)
class AdaptConfig:
    """Online adaptation schedule.

    ``lr``/``update_per_iter`` may be tuples of per-stage values: every
    trigger runs the stages in order, ``update_per_iter[i]`` Adam steps at
    ``lr[i]``, with a fresh optimizer per stage. A scalar on either field
    broadcasts against the other.

    ``fresh_opt_per_trigger`` must stay True here: carrying one Adam state
    through the solve is not ported yet.

    ``trainable_filter``: optional tuple of substrings of parameter names
    (PyTorch names, e.g. ``"model.0."``); when set, only matching parameters
    are updated and the rest stay bitwise frozen.

    ``crop`` (a random crop for the adaptation loss) is not ported yet.
    """

    lr: float | tuple[float, ...] = 2e-6
    update_per_iter: int | tuple[int, ...] = 2
    initial_iter: int = 1
    interval_iter: int = 5
    update_times: int = -1  # -1 = unlimited
    fresh_opt_per_trigger: bool = True
    trainable_filter: tuple[str, ...] | None = None
    crop: int | None = None


def resolve_stages(adapt: AdaptConfig) -> tuple[tuple[float, int], ...]:
    """Normalize ``(lr, update_per_iter)`` into per-stage ``((lr_i, n_i), ...)``
    pairs, broadcasting scalars."""
    lrs = adapt.lr if isinstance(adapt.lr, tuple) else (float(adapt.lr),)
    ns = (
        adapt.update_per_iter
        if isinstance(adapt.update_per_iter, tuple)
        else (int(adapt.update_per_iter),)
    )
    if len(lrs) == 1 and len(ns) > 1:
        lrs = lrs * len(ns)
    if len(ns) == 1 and len(lrs) > 1:
        ns = ns * len(lrs)
    if len(lrs) != len(ns):
        raise ValueError(
            f"lr stages ({len(lrs)}) and update_per_iter stages ({len(ns)}) "
            "must match or broadcast"
        )
    return tuple(zip((float(l) for l in lrs), (int(n) for n in ns)))


def first_lr(adapt: AdaptConfig) -> float:
    """The first nonzero stage lr (1.0 if every stage is 0): the base lr of
    the JAX package's default optimizer, kept for configuration parity."""
    return next((l for l, _ in resolve_stages(adapt) if l != 0.0), 1.0)


def make_schedule(
    sigma: tuple[float, ...], iters: tuple[int, ...], adapt: AdaptConfig | None
) -> tuple[np.ndarray, np.ndarray]:
    """Flatten the sigma continuation schedule into per-iteration arrays
    ``(sigma_per_iter [T] float32, adapt_mask [T] bool)``."""
    sigmas = np.concatenate(
        [np.full(n, s, np.float32) for s, n in zip(sigma, iters)]
    )
    total = int(sigmas.shape[0])
    mask = np.zeros(total, bool)
    if adapt is not None:
        fired = 0
        for k in range(total):
            if (
                k > adapt.initial_iter
                and k % adapt.interval_iter == 0
                and (adapt.update_times < 0 or fired < adapt.update_times)
            ):
                mask[k] = True
                fired += 1
    return sigmas, mask


def measurement_loss_fn(
    prior: "Prior",
    net: nn.Module,
    rgb_in: Tensor,
    sigma: Tensor,
    y_packed: Tensor,
    phi_packed: Tensor,
    y_full: Tensor,
    phi_full: Tensor,
) -> Callable[[], Tensor]:
    """The self-supervised loss closure of one adaptation trigger, over the
    current parameters of ``net``: the MSE of the re-mosaicked denoiser
    output through the forward model against the measurement, on the packed
    planes ('packed4', FFDNet) or on the full-resolution mosaic ('bayer1',
    FastDVDnet). The denoiser runs through ``prior.apply_adapt`` when the
    prior has one."""
    apply = prior.apply_adapt or prior.apply
    if prior.loss_mode == "packed4":

        def loss() -> Tensor:
            xhat = apply(net, rgb_in, sigma)
            pred = physics.forward(bayer.rggb_subsample(xhat), phi_packed)
            return torch.mean((pred - y_packed) ** 2)

    elif prior.loss_mode == "bayer1":

        def loss() -> Tensor:
            xhat = apply(net, rgb_in, sigma)
            pred = physics.forward(bayer.mosaic(xhat), phi_full)
            return torch.mean((pred - y_full) ** 2)

    else:
        raise ValueError(f"unknown loss_mode {prior.loss_mode!r}")
    return loss


def check_adapt_supported(prior: "Prior", adapt_cfg: AdaptConfig) -> None:
    """Raise ``NotImplementedError`` for an adaptation option not ported yet."""
    if adapt_cfg.crop is not None:
        raise NotImplementedError("AdaptConfig.crop is not ported yet")
    if not adapt_cfg.fresh_opt_per_trigger:
        raise NotImplementedError(
            "AdaptConfig.fresh_opt_per_trigger=False (a carried Adam state) "
            "is not ported yet")
    if prior.adapt_mask is not None:
        raise NotImplementedError("Prior.adapt_mask is not ported yet")


def make_adapt_fn(prior: "Prior", adapt_cfg: AdaptConfig):
    """Returns ``adapt(net, rgb_in, sigma, y_p, phi_p, y_f, phi_f, generator)``,
    which runs one trigger's Adam steps on ``net`` in place. ``net`` is the
    solver's private working copy, in eval mode: BatchNorm's running
    statistics are buffers, not parameters, and stay as they are.

    With ``prior.adapt_noise_std > 0`` the trigger first adds gaussian noise
    of that standard deviation to its input, drawn from ``generator`` on the
    generator's device (so a CPU generator gives the same draw wherever the
    solver runs)."""
    check_adapt_supported(prior, adapt_cfg)
    stages = resolve_stages(adapt_cfg)
    filters = adapt_cfg.trainable_filter

    def adapt(net: nn.Module, rgb_in: Tensor, sigma: Tensor, y_p: Tensor, phi_p: Tensor,
              y_f: Tensor, phi_f: Tensor, generator: torch.Generator | None = None) -> None:
        if prior.adapt_noise_std > 0:
            if generator is None:
                raise ValueError("the adaptation noise needs a torch.Generator")
            noise = torch.randn(rgb_in.shape, generator=generator, dtype=rgb_in.dtype,
                                device=generator.device)
            rgb_in = rgb_in + prior.adapt_noise_std * noise.to(rgb_in.device)
        trainable = [
            p for name, p in net.named_parameters()
            if filters is None or any(f in name for f in filters)
        ]
        loss = measurement_loss_fn(prior, net, rgb_in.detach(), sigma, y_p, phi_p,
                                   y_f, phi_f)
        with torch.enable_grad():
            for lr_i, n_i in stages:
                opt = torch.optim.Adam(trainable, lr=lr_i)
                for _ in range(n_i):
                    net.zero_grad(set_to_none=True)
                    loss().backward()
                    opt.step()
        net.zero_grad(set_to_none=True)

    return adapt
