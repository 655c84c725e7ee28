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
process. The frames of one measurement can be spread over ranks too
(:class:`FrameShard`): the loss's frame sum then runs over every rank's
frames (:func:`~adaptivepnp_sci_torch.parallel.mesh.gathered_sum`), the
draws are made for the whole cube and each rank keeps its frames, and the
prior sums its parameters' gradients over the ranks.

:func:`trigger_draws` is the one function that makes a trigger's draws: the
adaptation takes its share of them, and a rank that skips a measurement of a
batch makes them to keep its generator in step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn as nn
from torch import Tensor

from adaptivepnp_sci_torch.ops import bayer, corruption, physics
from adaptivepnp_sci_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    all_reduce_tensors,
    gather,
    gathered_sum,
)
from adaptivepnp_sci_torch.utils.profiling import annotate, count

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
    frames: "FrameShard | None" = None,
) -> Callable[[], Tensor]:
    """The self-supervised loss closure of one adaptation trigger, over the
    current parameters of ``net``: the MSE of the re-mosaicked denoiser
    output through the forward model against the measurement, on the packed
    planes ('packed4', FFDNet) or on the full-resolution mosaic ('bayer1',
    FastDVDnet). The denoiser runs through ``prior.apply_adapt`` when the
    prior has one. ``frames``: ``rgb_in`` and the masks hold this rank's
    frames, and the forward model's frame sum runs over every rank's
    (:meth:`FrameShard.sum`)."""
    apply = prior.apply_adapt or prior.apply
    fwd = physics.forward if frames is None else frames.forward
    if prior.loss_mode == "packed4":

        def loss() -> Tensor:
            xhat = apply(net, rgb_in, sigma)
            pred = fwd(bayer.rggb_subsample(xhat), phi_packed)
            return torch.mean((pred - y_packed) ** 2)

    elif prior.loss_mode == "bayer1":

        def loss() -> Tensor:
            xhat = apply(net, rgb_in, sigma)
            pred = fwd(bayer.mosaic(xhat), phi_full)
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


@dataclass(frozen=True)
class FrameShard:
    """This rank's frames of a measurement whose ``B``-frame cube is spread
    over the ranks of ``mesh``'s ``frame`` axis: frames ``start`` to ``start
    + n`` of ``total``, consecutive (the slice of
    :func:`~adaptivepnp_sci_torch.parallel.mesh.shard`). Ranks of other
    ``data`` coordinates hold the same frames of their own copy."""

    mesh: Mesh
    start: int
    n: int
    total: int

    @classmethod
    def of(cls, mesh: Mesh | None, total: int) -> "FrameShard | None":
        """This rank's shard of ``total`` frames; None without a mesh or with
        one rank on its ``frame`` axis (the one-process path)."""
        if mesh is None or mesh.axis_size("frame") == 1:
            return None
        ranks = mesh.axis_size("frame")
        if total % ranks:
            raise ValueError(f"{total} frames do not split over the mesh's {ranks} frame ranks")
        n = total // ranks
        return cls(mesh, mesh.axis_index("frame") * n, n, total)

    def local(self, t: Tensor, dim: int = 0) -> Tensor:
        """This rank's frames of ``t``, whose ``dim`` holds all of them."""
        return t.narrow(dim, self.start, self.n)

    def gather(self, t: Tensor, dim: int = 0) -> Tensor:
        """Every rank's frames of ``t`` along ``dim``, in frame order."""
        return gather(t, self.mesh, "frame", dim)

    def sum(self, t: Tensor, dim: int = 0) -> Tensor:
        """The sum of every rank's per-frame terms ``t`` over ``dim``, in frame
        order on every rank, differentiable (:func:`gathered_sum`)."""
        return gathered_sum(t, self.mesh, "frame", dim)

    def forward(self, x: Tensor, phi: Tensor) -> Tensor:
        """The forward model ``sum_t phi_t x_t`` over every rank's frames."""
        return self.sum(x * phi, 0)

    def all_reduce(self, tensors: list[Tensor]) -> None:
        """Sum ``tensors`` (the parameters' gradients) over the frame ranks, in place."""
        all_reduce_tensors(tensors, self.mesh, "frame")

    def psnr(self, ref: Tensor, img: Tensor, data_range: float = 1.0) -> Tensor:
        """The PSNR of the whole cube from this rank's frames of ``ref`` and
        ``img``: the squared errors' sum all-reduced over the ranks."""
        d = ref.to(torch.float32) - img.to(torch.float32)
        sse = all_reduce_sum(torch.sum(d ** 2), self.mesh, "frame")
        mse = sse / (d.numel() * (self.total // self.n))
        return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


class TriggerDraws(NamedTuple):
    """The draws of one adaptation trigger for its whole input shape:
    ``noise`` (the input noise, unscaled), ``marks`` (the corruption of an
    input of ones: 1 where a pixel is kept, the dropped value elsewhere) and
    ``offsets`` (one crop window per item); None where the trigger draws
    none of them. On the generator's device."""

    noise: Tensor | None
    marks: Tensor | None
    offsets: list[tuple[int, int]] | None


def trigger_draws(prior: "Prior", adapt_cfg: AdaptConfig, generator: torch.Generator | None,
                  shape: tuple[int, ...]) -> TriggerDraws:
    """Every draw of one adaptation trigger, for an input of ``shape`` (``(B,
    H, W, 3)``, or ``(N, B, H, W, 3)`` with an item axis: every item and
    frame of the measurements that share the trigger), in the order the
    trigger takes them: the input noise, the corruption masks item by item,
    the crop offsets item by item."""
    noise = marks = offsets = None
    if prior.adapt_noise_std > 0:
        if generator is None:
            raise ValueError("the adaptation noise needs a torch.Generator")
        noise = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
    if prior.adapt_mask is not None:
        ones = torch.ones(shape, device=generator.device if generator is not None else "cpu")
        marks = mask_input(generator, ones, prior.adapt_mask)
    if adapt_cfg.crop is not None:
        if generator is None:
            raise ValueError("the adaptation crop needs a torch.Generator")
        h, w = shape[-3:-1]
        check_crop(int(adapt_cfg.crop), h, w)
        offsets = [crop_offsets(generator, h, w, int(adapt_cfg.crop))
                   for _ in range(shape[0] if len(shape) == 5 else 1)]
    return TriggerDraws(noise, marks, offsets)


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
    the gradients summed over its ranks after each backward. ``frames``
    (:class:`FrameShard`): ``rgb_in`` and the masks hold this rank's frames;
    the draws are made for all frames and the loss's frame sum runs over
    every rank's. A prior with ``reduce_grads`` (frames spread over ranks)
    sums its gradients first. :func:`trigger_draws` makes every draw."""
    check_adapt_supported(prior, adapt_cfg)
    stages = resolve_stages(adapt_cfg)
    filters = adapt_cfg.trainable_filter
    fresh = adapt_cfg.fresh_opt_per_trigger
    crop = None if adapt_cfg.crop is None else int(adapt_cfg.crop)

    @annotate("apnp.adapt")
    def adapt(net: nn.Module, rgb_in: Tensor, sigma: Tensor, y_p: Tensor, phi_p: Tensor,
              y_f: Tensor, phi_f: Tensor, generator: torch.Generator | None = None,
              opt: torch.optim.Adam | None = None, shard: ItemShard | None = None,
              frames: FrameShard | None = None) -> None:
        if not fresh and opt is None:
            raise ValueError("fresh_opt_per_trigger=False needs the carried Adam (carried_adam)")
        if shard is not None and rgb_in.dim() != 5:
            raise ValueError("an item shard needs the item axis (N, B, H, W, 3)")
        n_local = rgb_in.shape[0]
        item_axis = rgb_in.dim() == 5
        frame_dim = 1 if item_axis else 0
        shape = list(rgb_in.shape)
        if shard is not None:
            shape[0] = shard.total
        if frames is not None:
            shape[frame_dim] = frames.total
        draws = trigger_draws(prior, adapt_cfg, generator, tuple(shape))

        def mine(t: Tensor) -> Tensor:
            # this rank's items and frames of a draw over the whole input
            if shard is not None:
                t = shard.local(t, n_local)
            return t if frames is None else frames.local(t, frame_dim)

        if draws.noise is not None:
            rgb_in = rgb_in + prior.adapt_noise_std * mine(draws.noise).to(rgb_in.device)
        if draws.marks is not None:
            # the reference's masked-input ablation (gen_masked_data)
            marks = mine(draws.marks).to(rgb_in.device)
            rgb_in = torch.where(marks == 1.0, rgb_in, marks)
        rgb_in = rgb_in.detach()
        items = ([(rgb_in, y_p, phi_p, y_f, phi_f)] if rgb_in.dim() == 4 else
                 [(rgb_in[i], y_p[i], phi_p[i] if phi_f.dim() == 4 else phi_p, y_f[i],
                   phi_f[i] if phi_f.dim() == 4 else phi_f) for i in range(rgb_in.shape[0])])
        if draws.offsets is not None:
            # the loss on a Bayer-aligned window of each item: the forward
            # model is pixel-separable, so the frames, y and phi are sliced alike
            offsets = draws.offsets
            if shard is not None:
                offsets = offsets[shard.start:shard.start + n_local]
            cropped = []
            for (rgb_i, _, _, y_i, phi_i), (oy, ox) in zip(items, offsets):
                win = (slice(oy, oy + crop), slice(ox, ox + crop))
                y_c, phi_c = y_i[win], phi_i[(slice(None), *win)]
                cropped.append((rgb_i[(slice(None), *win)], bayer.pack(y_c), bayer.pack(phi_c),
                                y_c, phi_c))
            items = cropped
        losses = [measurement_loss_fn(prior, net, r, sigma, yp, pp, yf, pf, frames)
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
                    count("apnp.adam_steps")
        net.zero_grad(set_to_none=True)

    return adapt
