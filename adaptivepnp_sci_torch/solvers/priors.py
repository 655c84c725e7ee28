"""Denoiser-prior plugin interface for the PnP solvers
(port of ``adaptivepnp_sci_tpu.solvers.priors``, FFDNet part).

A prior names a template module and how to apply it over the whole
``(B, H, W, 3)`` frame cube, plus what online adaptation needs. The solvers
never run or adapt the template itself: they load the caller's parameters
into a private copy (:func:`working_copy`) and return that copy's state dict.
"""

from __future__ import annotations

import copy
from typing import Callable, Mapping, NamedTuple

import torch
import torch.nn as nn
from torch import Tensor


class Prior(NamedTuple):
    """A pluggable deep denoiser prior.

    Attributes:
      name: identifier ('ffdnet', ...).
      model: template module; its architecture, not its weights, is used.
      apply: ``(module, rgb (B,H,W,3), sigma 0-d tensor) -> (B,H,W,3)``.
      loss_mode: measurement-consistency loss domain for online adaptation:
        'packed4' (4-channel packed planes) or 'bayer1' (full-res mosaic).
      adapt_noise_std: gaussian noise added to the adaptation input (FFDNet 0).
      adapt_mask: optional ('s'|'t'|'b', ratio) adaptation-input corruption.
        Nonzero noise and the mask draw random numbers; both are not ported
        yet and make the adaptation raise.
    """

    name: str
    model: nn.Module
    apply: Callable[[nn.Module, Tensor, Tensor], Tensor]
    loss_mode: str = "packed4"
    adapt_noise_std: float = 0.0
    adapt_mask: tuple[str, float] | None = None


def _apply_module(net: nn.Module, rgb: Tensor, sigma: Tensor) -> Tensor:
    return net(rgb, sigma)


def ffdnet_prior(model: nn.Module) -> Prior:
    """FFDNet image prior: the B frames are denoised as one batch."""
    return Prior("ffdnet", model, _apply_module, loss_mode="packed4", adapt_noise_std=0.0)


def working_copy(prior: Prior, params: Mapping[str, Tensor] | None,
                 device: torch.device | str) -> nn.Module:
    """A private float32 copy of ``prior.model`` on ``device`` holding
    ``params`` (the template's own weights when None), in eval mode.
    Neither ``prior.model`` nor ``params`` is changed by what the solver does
    to the copy."""
    net = copy.deepcopy(prior.model)
    if params is not None:
        net.load_state_dict(params)
    return net.to(device=device, dtype=torch.float32).eval()
