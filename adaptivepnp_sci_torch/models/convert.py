"""Weight bridge between Flax variables and PyTorch state dicts
(port of ``adaptivepnp_sci_tpu.models.convert``, FFDNet part).

The JAX package converts a torch conv weight ``(O, I, kh, kw)`` to a Flax
kernel ``(kh, kw, I, O)``; here the bridge runs the other way as well, so
the same numpy arrays drive both packages. Flax names are
``params/conv_{i}/{kernel,bias}``; the port's FFDNet keeps the KAIR layout
``model.{2i}.{weight,bias}``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import Tensor


def conv_weight(kernel: np.ndarray) -> np.ndarray:
    """Flax kernel ``(kh, kw, I, O)`` -> torch conv weight ``(O, I, kh, kw)``."""
    return np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def conv_kernel(w: np.ndarray) -> np.ndarray:
    """Torch conv weight ``(O, I, kh, kw)`` -> Flax kernel ``(kh, kw, I, O)``."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def ffdnet_from_flax(variables: Mapping[str, Any]) -> dict[str, Tensor]:
    """Flax FFDNet variables (numpy leaves) -> state dict for
    :class:`adaptivepnp_sci_torch.models.ffdnet.FFDNet`."""
    params = variables["params"]
    n = len(params)
    sd: dict[str, Tensor] = {}
    for i in range(n):
        p = params[f"conv_{i}"]
        sd[f"model.{2 * i}.weight"] = torch.from_numpy(
            conv_weight(np.asarray(p["kernel"], np.float32)))
        sd[f"model.{2 * i}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))
    return sd


def ffdnet_to_flax(state_dict: Mapping[str, Tensor]) -> dict:
    """Inverse of :func:`ffdnet_from_flax`: a (possibly adapted) state dict
    -> Flax variables with numpy leaves."""
    conv_ids = sorted({int(k.split(".")[1]) for k in state_dict if k.startswith("model.")})
    params = {}
    for i, sid in enumerate(conv_ids):
        w = state_dict[f"model.{sid}.weight"].detach().cpu().numpy()
        params[f"conv_{i}"] = {
            "kernel": conv_kernel(w),
            "bias": state_dict[f"model.{sid}.bias"].detach().cpu().numpy(),
        }
    return {"params": params}


def load_ffdnet(path: str) -> dict[str, Tensor]:
    """Load a KAIR FFDNet checkpoint (``ffdnet_color.pth``) as a state dict
    for :class:`~adaptivepnp_sci_torch.models.ffdnet.FFDNet` on the CPU: the
    layouts match, once a DataParallel ``module.`` prefix is dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.removeprefix("module."): v for k, v in sd.items()}
