"""Online adaptation of the DDnet joint demosaicker, ``dm_update``
(port of ``adaptivepnp_sci_tpu.adapt.ddnet_online``).

Adam steps on the self-consistency loss: DDnet demosaics the sparse-RGB
frame windows, the output is re-mosaicked and compared with the input
mosaic. The steps run on a private float32 copy of the model; the caller's
module and weights are never changed. With the frames spread over the ranks
of a mesh's ``frame`` axis (:class:`~adaptivepnp_sci_torch.adapt.online.FrameShard`)
the windows reach the neighbours' frames through the ring halo, each rank's
loss is its frames' share of the whole mean, and the gradients are summed
over the ranks.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import torch
import torch.nn as nn
from torch import Tensor

from adaptivepnp_sci_torch.adapt.online import FrameShard, ItemShard, backward_mean
from adaptivepnp_sci_torch.ops import bayer
from adaptivepnp_sci_torch.parallel.halo import halo_windows
from adaptivepnp_sci_torch.solvers.priors import module_copy, window_indices
from adaptivepnp_sci_torch.utils.profiling import count


def frames_mse(err: Tensor, frames: FrameShard | None = None) -> Tensor:
    """The mean of the squared ``err`` over the frames; with ``frames``,
    this rank's share of the mean over every rank's frames (its squared sum
    over the whole count)."""
    if frames is None:
        return torch.mean(err ** 2)
    return torch.sum(err ** 2) / (err.numel() * (frames.total // frames.n))


def dm_consistency_loss(net: nn.Module, mosaic_frames: Tensor, window: int = 5,
                        frames: FrameShard | None = None) -> Tensor:
    """``MSE(sparse_rgb_in, sparse_rgb(mosaic(out)))`` over all frames
    ``(B, H, W)``: the Bayer-domain MSE divided by 3 (two thirds of the
    sparse-RGB entries are zero in both operands). ``frames``: the rank's
    frames and its share of the loss (:func:`frames_mse`)."""
    b = mosaic_frames.shape[0]
    rgb_in = bayer.embed_rgb(mosaic_frames)
    if frames is None:
        windows = rgb_in[window_indices(b, window).to(rgb_in.device)]
    else:
        windows = halo_windows(rgb_in, frames.mesh, "frame", window)
    return frames_mse(bayer.mosaic(net(windows)) - mosaic_frames, frames) / 3.0


def dm_adam_steps(net: nn.Module, opt: torch.optim.Adam,
                  loss_fns: Sequence[Callable[[], Tensor]], lr: float, steps: int,
                  fresh_opt: bool, shard: ItemShard | None = None,
                  frames: FrameShard | None = None) -> tuple[torch.optim.Adam, Tensor]:
    """``steps`` Adam steps on the mean of ``loss_fns`` (one closure per
    measurement that shares the update; see
    :func:`~adaptivepnp_sci_torch.adapt.online.backward_mean`) over all
    parameters of ``net``, with gradients on even inside the caller's
    ``no_grad``; with ``fresh_opt`` a new Adam replaces ``opt`` before every
    step. With ``shard`` the measurements are this rank's share of a group
    spread over ranks: the mean runs over the whole group and the gradients
    are summed over its ranks; with ``frames`` each loss is the rank's share
    over its frames, and the gradients are summed over the frame ranks.
    Returns the optimizer last used and the loss of the last step (this
    rank's share of it with ``shard`` or ``frames``), before its update.
    Each step adds one to the counter ``apnp.dm_adam_steps``."""
    params = list(net.parameters())
    loss = torch.zeros((), device=params[0].device)
    with torch.enable_grad():
        for _ in range(steps):
            if fresh_opt:
                opt = torch.optim.Adam(params, lr=lr)
            net.zero_grad(set_to_none=True)
            loss = backward_mean(loss_fns, None if shard is None else shard.total)
            for reducer in (frames, shard):
                if reducer is not None:
                    reducer.all_reduce([p.grad for p in params if p.grad is not None])
            opt.step()
            count("apnp.dm_adam_steps")
    net.zero_grad(set_to_none=True)
    return opt, loss.detach()


def make_dm_adapt_fn(model: nn.Module, lr: float = 1e-6, update_per_iter: int = 1,
                     window: int = 5, fresh_opt: bool = False, frames: FrameShard | None = None
                     ) -> Callable[..., tuple[dict[str, Tensor], dict[str, Any], Tensor]]:
    """Returns ``adapt(state_dict, optimizer_state, mosaic_frames) ->
    (state_dict, optimizer_state, loss)`` running ``update_per_iter`` Adam
    steps over all of DDnet's parameters (the ``weight_tensor_*`` included)
    on the frames' device. ``state_dict`` None means ``model``'s own weights;
    ``optimizer_state`` is a ``torch.optim.Adam`` state dict, None for a new
    optimizer. ``fresh_opt`` builds a new Adam before every step (the
    reference's semantics); otherwise one Adam state carries through the steps
    and, returned, across calls. ``loss`` is that of the last step, before its
    update. ``frames``: ``mosaic_frames`` are this rank's frames
    (:func:`dm_consistency_loss`); the gradients are summed over the frame
    ranks, and ``loss`` is the rank's share."""

    def adapt(state_dict: Mapping[str, Tensor] | None, optimizer_state: Mapping | None,
              mosaic_frames: Tensor) -> tuple[dict[str, Tensor], dict[str, Any], Tensor]:
        net = module_copy(model, state_dict, mosaic_frames.device)
        opt = torch.optim.Adam(net.parameters(), lr=lr)
        if optimizer_state is not None:
            opt.load_state_dict(optimizer_state)
        mosaic = mosaic_frames.detach()
        opt, loss = dm_adam_steps(
            net, opt, [lambda: dm_consistency_loss(net, mosaic, window, frames)], lr,
            update_per_iter, fresh_opt, frames=frames)
        return net.state_dict(), opt.state_dict(), loss

    return adapt
