"""Denoiser-prior plugin interface for the PnP solvers
(port of ``adaptivepnp_sci_tpu.solvers.priors``).

A prior names a template module and how to apply it over the whole
``(B, H, W, 3)`` frame cube, plus what online adaptation needs. The solvers
never run or adapt the template itself: they load the caller's parameters
into a private copy (:func:`working_copy`) and return that copy's state dict.
The DDnet demosaicker (:func:`ddnet_demosaic`) runs on such a copy too.
"""

from __future__ import annotations

import copy
from typing import Callable, Mapping, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from adaptivepnp_sci_torch.ops.bayer import embed_rgb


class Prior(NamedTuple):
    """A pluggable deep denoiser prior.

    Attributes:
      name: identifier ('ffdnet', 'fastdvd').
      model: template module; its architecture, not its weights, is used.
      apply: ``(module, rgb (B,H,W,3), sigma 0-d tensor) -> (B,H,W,3)``.
      loss_mode: measurement-consistency loss domain for online adaptation:
        'packed4' (4-channel packed planes) or 'bayer1' (full-res mosaic).
      adapt_noise_std: gaussian noise added to the adaptation input
        (FastDVDnet 5/255, FFDNet 0).
      adapt_mask: optional ('s'|'t'|'b', ratio) adaptation-input corruption
        (:mod:`adaptivepnp_sci_torch.ops.corruption`), applied after the
        adaptation noise.
      apply_adapt: optional memory-bounded variant of ``apply`` used inside
        the adaptation gradient (None = ``apply``).
    """

    name: str
    model: nn.Module
    apply: Callable[[nn.Module, Tensor, Tensor], Tensor]
    loss_mode: str = "packed4"
    adapt_noise_std: float = 0.0
    adapt_mask: tuple[str, float] | None = None
    apply_adapt: Callable[[nn.Module, Tensor, Tensor], Tensor] | None = None


def _apply_module(net: nn.Module, rgb: Tensor, sigma: Tensor) -> Tensor:
    return net(rgb, sigma)


def ffdnet_prior(model: nn.Module) -> Prior:
    """FFDNet image prior: the B frames are denoised as one batch."""
    return Prior("ffdnet", model, _apply_module, loss_mode="packed4", adapt_noise_std=0.0)


def window_indices(n_frames: int, window: int = 5) -> Tensor:
    """Circular sliding-window gather indices ``(B, window)``: the window of
    frame f is ``(f - hw .. f + hw) mod B``."""
    hw = (window - 1) // 2
    return (torch.arange(n_frames)[:, None] + torch.arange(window)[None, :] - hw) % n_frames


def window_indices_mirror(n_frames: int, window: int = 5) -> Tensor:
    """Mirror-border sliding windows: out-of-range neighbours reflect off the
    sequence ends instead of wrapping."""
    hw = (window - 1) // 2
    idx = (torch.arange(n_frames)[:, None] + torch.arange(window)[None, :] - hw).abs()
    return torch.where(idx >= n_frames, 2 * (n_frames - 1) - idx, idx)


def _seq_circular(net: nn.Module, rgb: Tensor, sigma: Tensor) -> Tensor:
    return net.seq_circular(rgb, sigma)


def fastdvd_prior(model: nn.Module, window: int = 5, window_chunk: int | None = None,
                  adapt_window_chunk: int | None = None,
                  adapt_mask: tuple[str, float] | None = None) -> Prior:
    """FastDVDnet temporal prior over circular 5-frame windows.

    Default (``window == 5``, no chunking): the model's ``seq_circular``,
    ``temp1`` evaluated once per distinct circular triplet.

    ``window_chunk=k`` gathers the windows explicitly and runs them in
    sequential groups of k (peak memory = one group), for memory-constrained
    adaptation at large resolutions; ``adapt_window_chunk`` tightens the
    group size inside the adaptation gradient only.
    """

    def chunked(chunk: int | None):
        if chunk is None and window == 5:
            return _seq_circular

        def apply(net: nn.Module, rgb: Tensor, sigma: Tensor) -> Tensor:
            b = rgb.shape[0]
            windows = rgb[window_indices(b, window).to(rgb.device)]
            if chunk is None or chunk >= b:
                return net(windows, sigma)
            if b % chunk:
                raise ValueError(f"window_chunk {chunk} does not divide {b} frames")
            return torch.cat([net(windows[i:i + chunk], sigma) for i in range(0, b, chunk)])

        return apply

    return Prior("fastdvd", model, chunked(window_chunk), loss_mode="bayer1",
                 adapt_noise_std=5.0 / 255.0, adapt_mask=adapt_mask,
                 apply_adapt=chunked(adapt_window_chunk or window_chunk))


def module_copy(model: nn.Module, params: Mapping[str, Tensor] | None,
                device: torch.device | str) -> nn.Module:
    """A private float32 copy of ``model`` on ``device`` holding ``params``
    (the template's own weights when None), in eval mode. Neither ``model``
    nor ``params`` is changed by what is done to the copy."""
    net = copy.deepcopy(model)
    if params is not None:
        net.load_state_dict(params)
    return net.to(device=device, dtype=torch.float32).eval()


def working_copy(prior: Prior, params: Mapping[str, Tensor] | None,
                 device: torch.device | str) -> nn.Module:
    """The solver's private float32 copy of ``prior.model`` (:func:`module_copy`)."""
    return module_copy(prior.model, params, device)


def ddnet_demosaic_param(model: nn.Module, window: int = 5
                         ) -> Callable[[nn.Module, Tensor], Tensor]:
    """Deep joint demosaicker for the solver: ``(net, (B, H, W)) -> (B, H, W, 3)``
    with ``net`` a DDnet (``model`` or a copy of it; ``model`` is the template
    the solver copies for in-scan adaptation).

    Embeds each Bayer frame as sparse RGB, reflect-pads H and W up to
    multiples of 4 (the U-Nets downsample twice), gathers circular 5-frame
    windows and runs DDnet on all B windows as one batch, then crops.
    """
    del model  # the architecture travels with ``net``

    def apply(net: nn.Module, mosaic_frames: Tensor) -> Tensor:
        b, h, w = mosaic_frames.shape
        hp, wp = (-h) % 4, (-w) % 4
        rgb = embed_rgb(mosaic_frames)  # (B, H, W, 3)
        if hp or wp:
            rgb = F.pad(rgb.permute(0, 3, 1, 2), (0, wp, 0, hp), mode="reflect")
            rgb = rgb.permute(0, 2, 3, 1)
        out = net(rgb[window_indices(b, window).to(rgb.device)])
        return out[:, :h, :w]

    return apply


def ddnet_demosaic(model: nn.Module, params: Mapping[str, Tensor] | None = None,
                   window: int = 5) -> Callable[[Tensor], Tensor]:
    """Fixed-weight form of :func:`ddnet_demosaic_param`: ``(B, H, W) ->
    (B, H, W, 3)``, run without gradient on a private float32 copy of
    ``model`` holding ``params`` (the template's own weights when None). The
    copy follows its input's device; ``model`` and ``params`` are never
    changed."""
    apply_p = ddnet_demosaic_param(model, window)
    net = module_copy(model, params, "cpu")

    @torch.no_grad()
    def apply(mosaic_frames: Tensor) -> Tensor:
        if net.weight_tensor_in.device != mosaic_frames.device:
            net.to(mosaic_frames.device)
        return apply_p(net, mosaic_frames)

    return apply
