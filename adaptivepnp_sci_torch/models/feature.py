"""VGG19 feature extractor for perceptual losses
(port of ``adaptivepnp_sci_tpu.models.feature``).

The reference's ``models/network_feature.py:16-44``: torchvision's VGG19
``features`` trunk cut at a chosen layer, for a perceptual loss. It is on no
reconstruction path. :class:`VGGFeatures` keeps torchvision's layer indices
(``features.{i}``), so a torchvision ``vgg19`` state dict loads through
:func:`vgg_state_dict_from_torch` without torchvision itself, and Flax
variables through :func:`vgg_from_flax`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn
from torch import Tensor

from adaptivepnp_sci_torch.models.convert import blocks_from_flax

# VGG19 'features' plan: conv channel widths with 'M' = maxpool
_VGG19_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
               512, 512, 512, 512, "M", 512, 512, 512, 512, "M")

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _vgg19_layers() -> list[nn.Module]:
    """torchvision's ``vgg19().features``, layer for layer."""
    layers: list[nn.Module] = []
    cin = 3
    for width in _VGG19_PLAN:
        if width == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(cin, width, 3, padding=1), nn.ReLU()]
            cin = width
    return layers


class VGGFeatures(nn.Module):
    """Features of ``(N, H, W, 3)`` RGB in [0, 1] through the first
    ``feature_layer`` layers of VGG19's ``features`` (ReLU and pool layers
    counted: 34 ends after ``relu5_3``, before ``conv5_4``), returned as
    ``(N, h, w, C)``; NCHW inside. ``use_input_norm`` standardises by the
    ImageNet mean and std first."""

    def __init__(self, feature_layer: int = 34, use_input_norm: bool = True):
        super().__init__()
        self.feature_layer, self.use_input_norm = feature_layer, use_input_norm
        self.features = nn.Sequential(*_vgg19_layers()[:feature_layer])
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD).reshape(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: Tensor) -> Tensor:
        x = x.permute(0, 3, 1, 2)
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        return self.features(x).permute(0, 2, 3, 1)


def vgg_state_dict_from_torch(state_dict: Mapping[str, Any],
                              feature_layer: int = 34) -> dict[str, Tensor]:
    """A torchvision ``vgg19()`` state dict (``features.{i}.*``, the
    classifier ignored) or ``vgg19().features`` state dict (``{i}.*``) ->
    the state dict of ``VGGFeatures(feature_layer)``."""
    out: dict[str, Tensor] = {}
    for k, v in state_dict.items():
        if k.startswith("classifier."):
            continue
        k = k.removeprefix("features.")
        if int(k.split(".")[0]) < feature_layer:
            out[f"features.{k}"] = torch.as_tensor(np.asarray(v), dtype=torch.float32)
    return out


def vgg_from_flax(variables: Mapping[str, Any]) -> dict[str, Tensor]:
    """Flax :class:`VGGFeatures` variables (``params/conv_{i}/{kernel,bias}``,
    ``i`` the torchvision index) -> the port's state dict."""
    return blocks_from_flax({"params": {"features": {
        name.removeprefix("conv_"): p for name, p in variables["params"].items()}}})


def perceptual_loss(model: VGGFeatures, pred: Tensor, target: Tensor) -> Tensor:
    """MSE in VGG feature space."""
    return torch.mean((model(pred) - model(target)) ** 2)
