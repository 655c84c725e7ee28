"""Online adaptation of the DDnet joint demosaicker, ``dm_update``
(port of ``adaptivepnp_sci_tpu.adapt.ddnet_online``).

Adam steps on the self-consistency loss: DDnet demosaics the sparse-RGB
frame windows, the output is re-mosaicked and compared with the input
mosaic. The steps run on a private float32 copy of the model; the caller's
module and weights are never changed.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
import torch.nn as nn
from torch import Tensor

from adaptivepnp_sci_torch.ops import bayer
from adaptivepnp_sci_torch.solvers.priors import module_copy, window_indices


def dm_consistency_loss(net: nn.Module, mosaic_frames: Tensor, window: int = 5) -> Tensor:
    """``MSE(sparse_rgb_in, sparse_rgb(mosaic(out)))`` over all frames
    ``(B, H, W)``: the Bayer-domain MSE divided by 3 (two thirds of the
    sparse-RGB entries are zero in both operands)."""
    b = mosaic_frames.shape[0]
    rgb_in = bayer.embed_rgb(mosaic_frames)
    out = net(rgb_in[window_indices(b, window).to(rgb_in.device)])
    return torch.mean((bayer.mosaic(out) - mosaic_frames) ** 2) / 3.0


def dm_adam_steps(net: nn.Module, opt: torch.optim.Adam, loss_fn: Callable[[], Tensor],
                  lr: float, steps: int, fresh_opt: bool) -> tuple[torch.optim.Adam, Tensor]:
    """``steps`` Adam steps on ``loss_fn()`` over all parameters of ``net``,
    with gradients on even inside the caller's ``no_grad``; with ``fresh_opt`` a new
    Adam replaces ``opt`` before every step. Returns the optimizer last used
    and the loss of the last step, before its update."""
    params = list(net.parameters())
    loss = torch.zeros((), device=params[0].device)
    with torch.enable_grad():
        for _ in range(steps):
            if fresh_opt:
                opt = torch.optim.Adam(params, lr=lr)
            net.zero_grad(set_to_none=True)
            loss = loss_fn()
            loss.backward()
            opt.step()
    net.zero_grad(set_to_none=True)
    return opt, loss.detach()


def make_dm_adapt_fn(model: nn.Module, lr: float = 1e-6, update_per_iter: int = 1,
                     window: int = 5, fresh_opt: bool = False
                     ) -> Callable[..., tuple[dict[str, Tensor], dict[str, Any], Tensor]]:
    """Returns ``adapt(state_dict, optimizer_state, mosaic_frames) ->
    (state_dict, optimizer_state, loss)`` running ``update_per_iter`` Adam
    steps over all of DDnet's parameters (the ``weight_tensor_*`` included)
    on the frames' device. ``state_dict`` None means ``model``'s own weights;
    ``optimizer_state`` is a ``torch.optim.Adam`` state dict, None for a new
    optimizer. ``fresh_opt`` builds a new Adam before every step (the
    reference's semantics); otherwise one Adam state carries through the steps
    and, returned, across calls. ``loss`` is that of the last step, before its
    update."""

    def adapt(state_dict: Mapping[str, Tensor] | None, optimizer_state: Mapping | None,
              mosaic_frames: Tensor) -> tuple[dict[str, Tensor], dict[str, Any], Tensor]:
        net = module_copy(model, state_dict, mosaic_frames.device)
        opt = torch.optim.Adam(net.parameters(), lr=lr)
        if optimizer_state is not None:
            opt.load_state_dict(optimizer_state)
        frames = mosaic_frames.detach()
        opt, loss = dm_adam_steps(net, opt, lambda: dm_consistency_loss(net, frames, window),
                                  lr, update_per_iter, fresh_opt)
        return net.state_dict(), opt.state_dict(), loss

    return adapt
