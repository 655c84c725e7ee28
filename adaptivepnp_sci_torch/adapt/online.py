"""Online adaptation: fine-tune the denoiser against the measurement itself
(port of ``adaptivepnp_sci_tpu.adapt.online``).

Adam steps on ``MSE(A(mosaic(denoise(x))), y)`` interleave with the ADMM
iterations, fired on a per-iteration mask precomputed on the host
(:func:`make_schedule`) from the trigger rule
``k > initial_iter and k % interval_iter == 0`` and the update-count cap.

Each stage of each trigger builds a fresh ``torch.optim.Adam`` at the stage's
lr, as the reference does; with ``fresh_opt_per_trigger=False`` one Adam
(:func:`carried_adam`) lives through every trigger and, carried by the
drivers, across measurements, its lr set to each stage's in turn. The
optimizer steps the solver's private copy of the denoiser
(:func:`adaptivepnp_sci_torch.solvers.priors.working_copy`), never the
caller's module.

Several measurements (the tiles of one scene) can share one adaptation: the
loss is then the mean of their per-item losses, whose gradient is the mean of
the per-item gradients that the JAX package ``pmean``-s over its tile axis.
Those items can also be spread over ranks (:class:`ItemShard`): each rank
divides its items' losses by the count of all of them and the gradients are
summed over the ranks, and every rank makes the draws of all the items, in
item order, and keeps its own, so each item draws what it draws in one
process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn
from torch import Tensor

from adaptivepnp_sci_torch.ops import bayer, corruption, physics

if TYPE_CHECKING:
    from adaptivepnp_sci_torch.solvers.priors import Prior


@dataclass(frozen=True)
class AdaptConfig:
    """Online adaptation schedule.

    ``lr``/``update_per_iter`` may be tuples of per-stage values: every
    trigger runs the stages in order, ``update_per_iter[i]`` Adam steps at
    ``lr[i]``, with a fresh optimizer per stage. A scalar on either field
    broadcasts against the other.

    ``fresh_opt_per_trigger`` (default True) builds a fresh Adam for every
    stage of every trigger, as the reference does; False carries one Adam
    state through the solve and across measurements (:func:`carried_adam`).

    ``trainable_filter``: optional tuple of substrings of parameter names
    (PyTorch names, e.g. ``"model.0."``); when set, only matching parameters
    are updated and the rest stay bitwise frozen.

    ``crop``: the adaptation loss on a random ``crop x crop`` window (even
    offsets, so the Bayer phase holds) that slices the frame cube, the
    measurement and the masks alike; the offsets are drawn per trigger (per
    item, on an item axis) by :func:`crop_offsets`.
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
    """Raise ``ValueError`` for an adaptation input corruption
    (``Prior.adapt_mask``) of an unknown mode, as the JAX package does."""
    if prior.adapt_mask is not None and prior.adapt_mask[0] not in ("s", "t", "b"):
        raise ValueError(f"unknown adapt_mask mode {prior.adapt_mask[0]!r}")


def draws_randoms(prior: "Prior", adapt_cfg: AdaptConfig | None) -> bool:
    """Whether the adaptation draws from a generator: input noise, an input
    corruption mask (the spatial and block modes) or crop offsets."""
    masks = prior.adapt_mask is not None and prior.adapt_mask[0] in ("s", "b")
    return adapt_cfg is not None and (prior.adapt_noise_std > 0 or masks
                                      or adapt_cfg.crop is not None)


def mask_input(generator: torch.Generator | None, rgb_in: Tensor,
               adapt_mask: tuple[str, float]) -> Tensor:
    """The adaptation input with ``Prior.adapt_mask``'s corruption: the frame
    cube ``(B, H, W, 3)`` plays the window axis of
    :mod:`adaptivepnp_sci_torch.ops.corruption`; on an item axis
    ``(N, B, H, W, 3)`` each item draws its own mask, in turn."""
    mode, ratio = adapt_mask
    if rgb_in.dim() == 5:
        return torch.stack([mask_input(generator, r, adapt_mask) for r in rgb_in])
    return corruption.mask_window(generator, rgb_in[None], mode, ratio)[0]


def check_crop(crop: int, h: int, w: int) -> None:
    """The JAX package's refusals of an adaptation crop for ``(h, w)`` frames."""
    if crop % 2 or h % 2 or w % 2:
        raise ValueError(f"crop/frame dims must be even, got crop={crop} frame=({h},{w})")
    if crop > h or crop > w:
        raise ValueError(f"crop {crop} exceeds frame ({h},{w})")


def crop_offsets(generator: torch.Generator, h: int, w: int, crop: int) -> tuple[int, int]:
    """The even offsets ``(oy, ox)`` of one adaptation crop window, uniform
    over the windows that fit in ``(h, w)``, drawn from ``generator`` (the JAX
    package draws them from its own PRNG key, so the numbers differ)."""
    dev = generator.device
    oy = torch.randint(0, (h - crop) // 2 + 1, (), generator=generator, device=dev)
    ox = torch.randint(0, (w - crop) // 2 + 1, (), generator=generator, device=dev)
    return int(oy) * 2, int(ox) * 2


@dataclass(frozen=True)
class ItemShard:
    """This rank's share of items that share one adaptation: items ``start``
    to ``start + n`` of ``total``, the rest on other ranks. ``all_reduce``
    sums a list of tensors in place over the ranks that share the items."""

    start: int
    total: int
    all_reduce: Callable[[list[Tensor]], None]

    def local(self, t: Tensor, n: int) -> Tensor:
        """This rank's ``n`` items of ``t``, whose leading axis holds all."""
        return t[self.start:self.start + n]


def carried_adam(net: nn.Module, adapt_cfg: AdaptConfig,
                 opt_state: Mapping[str, Any] | None = None) -> torch.optim.Adam | None:
    """The Adam that ``fresh_opt_per_trigger=False`` carries: over every
    parameter of ``net`` (those outside ``trainable_filter`` get zero
    gradients, so their moments and values stay as they are, as in the JAX
    package), from the ``torch.optim.Adam`` state dict ``opt_state`` (None:
    a new one). None when the schedule builds a fresh Adam per stage."""
    if adapt_cfg.fresh_opt_per_trigger:
        return None
    opt = torch.optim.Adam(net.parameters(), lr=first_lr(adapt_cfg))
    if opt_state is not None:
        opt.load_state_dict(opt_state)
    return opt


def backward_mean(losses: Sequence[Callable[[], Tensor]], count: int | None = None) -> Tensor:
    """Accumulate the gradient of the mean of ``losses`` (closures), one
    loss's graph at a time so that peak memory is that of one; returns the
    mean loss, detached. ``count``: the number of losses the mean runs over,
    when some of them are on other ranks (:class:`ItemShard`; None: these)."""
    n = len(losses) if count is None else count
    total = None
    for loss_fn in losses:
        loss = loss_fn()
        (loss if n == 1 else loss / n).backward()
        total = loss.detach() if total is None else total + loss.detach()
    return total if n == 1 else total / n


def make_adapt_fn(prior: "Prior", adapt_cfg: AdaptConfig):
    """Returns ``adapt(net, rgb_in, sigma, y_p, phi_p, y_f, phi_f, generator,
    opt)``, which runs one trigger's Adam steps on ``net`` in place. ``net`` is
    the solver's private working copy, in eval mode: BatchNorm's running
    statistics are buffers, not parameters, and stay as they are. ``opt`` is
    the :func:`carried_adam` when the schedule carries one (None otherwise);
    its lr is set to each stage's before that stage's steps.

    ``rgb_in (N, B, H, W, 3)`` with an item axis adapts on ``N`` measurements
    at once: ``y_p (N, 4, h, w)``, ``y_f (N, H, W)``, and ``phi_p``/``phi_f``
    per item or shared; the loss is the mean of the per-item losses, each
    item's gradient accumulated before the next item's forward.

    With ``prior.adapt_noise_std > 0`` the trigger first adds gaussian noise
    of that standard deviation to its input, drawn from ``generator`` on the
    generator's device (so a CPU generator gives the same draw wherever the
    solver runs). With ``prior.adapt_mask`` it then corrupts the input
    (:func:`mask_input`), and with ``adapt_cfg.crop`` draws each item's crop
    window from ``generator`` (:func:`crop_offsets`).

    ``shard`` (:class:`ItemShard`): the ``N`` items are this rank's share of
    a group spread over ranks; the draws are made for the whole group and
    the gradients summed over its ranks after each backward. A prior with
    ``reduce_grads`` (frames spread over ranks) sums its gradients first."""
    check_adapt_supported(prior, adapt_cfg)
    stages = resolve_stages(adapt_cfg)
    filters = adapt_cfg.trainable_filter
    fresh = adapt_cfg.fresh_opt_per_trigger
    crop = None if adapt_cfg.crop is None else int(adapt_cfg.crop)

    def adapt(net: nn.Module, rgb_in: Tensor, sigma: Tensor, y_p: Tensor, phi_p: Tensor,
              y_f: Tensor, phi_f: Tensor, generator: torch.Generator | None = None,
              opt: torch.optim.Adam | None = None, shard: ItemShard | None = None) -> None:
        if not fresh and opt is None:
            raise ValueError("fresh_opt_per_trigger=False needs the carried Adam (carried_adam)")
        if shard is not None and rgb_in.dim() != 5:
            raise ValueError("an item shard needs the item axis (N, B, H, W, 3)")
        n_local = rgb_in.shape[0]
        if prior.adapt_noise_std > 0:
            if generator is None:
                raise ValueError("the adaptation noise needs a torch.Generator")
            shape = rgb_in.shape if shard is None else (shard.total, *rgb_in.shape[1:])
            noise = torch.randn(shape, generator=generator, dtype=rgb_in.dtype,
                                device=generator.device)
            if shard is not None:
                noise = shard.local(noise, n_local)
            rgb_in = rgb_in + prior.adapt_noise_std * noise.to(rgb_in.device)
        if prior.adapt_mask is not None:
            # the reference's masked-input ablation (gen_masked_data)
            if shard is None:
                rgb_in = mask_input(generator, rgb_in, prior.adapt_mask)
            else:
                # every item's mask in item order; the other ranks' items'
                # masks are drawn on this rank's first item and dropped
                masked = [mask_input(generator, rgb_in[i - shard.start]
                                     if 0 <= i - shard.start < n_local else rgb_in[0],
                                     prior.adapt_mask) for i in range(shard.total)]
                rgb_in = shard.local(torch.stack(masked), n_local)
        rgb_in = rgb_in.detach()
        items = ([(rgb_in, y_p, phi_p, y_f, phi_f)] if rgb_in.dim() == 4 else
                 [(rgb_in[i], y_p[i], phi_p[i] if phi_f.dim() == 4 else phi_p, y_f[i],
                   phi_f[i] if phi_f.dim() == 4 else phi_f) for i in range(rgb_in.shape[0])])
        if crop is not None:
            # the loss on a Bayer-aligned window of each item: the forward
            # model is pixel-separable, so the frames, y and phi are sliced alike
            if generator is None:
                raise ValueError("the adaptation crop needs a torch.Generator")
            h, w = phi_f.shape[-2:]
            check_crop(crop, h, w)
            cropped = []
            offsets = [crop_offsets(generator, h, w, crop)
                       for _ in range(len(items) if shard is None else shard.total)]
            if shard is not None:
                offsets = offsets[shard.start:shard.start + n_local]
            for (rgb_i, _, _, y_i, phi_i), (oy, ox) in zip(items, offsets):
                win = (slice(oy, oy + crop), slice(ox, ox + crop))
                y_c, phi_c = y_i[win], phi_i[(slice(None), *win)]
                cropped.append((rgb_i[(slice(None), *win)], bayer.pack(y_c), bayer.pack(phi_c),
                                y_c, phi_c))
            items = cropped
        losses = [measurement_loss_fn(prior, net, r, sigma, yp, pp, yf, pf)
                  for r, yp, pp, yf, pf in items]
        named = list(net.named_parameters())
        on = [filters is None or any(f in name for f in filters) for name, _ in named]
        trainable = [p for (_, p), keep in zip(named, on) if keep]
        with torch.enable_grad():
            for lr_i, n_i in stages:
                if fresh:
                    opt = torch.optim.Adam(trainable, lr=lr_i)
                else:
                    for group in opt.param_groups:
                        group["lr"] = lr_i
                for _ in range(n_i):
                    net.zero_grad(set_to_none=True)
                    backward_mean(losses, None if shard is None else shard.total)
                    grads = [p.grad for p in trainable if p.grad is not None]
                    if prior.reduce_grads is not None:
                        prior.reduce_grads(grads)
                    if shard is not None:
                        shard.all_reduce(grads)
                    if not fresh:
                        for (_, p), keep in zip(named, on):
                            if not keep or p.grad is None:
                                p.grad = torch.zeros_like(p)
                    opt.step()
        net.zero_grad(set_to_none=True)

    return adapt
