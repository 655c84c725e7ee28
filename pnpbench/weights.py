"""The weights the benchmark hands both the program and the reference, as
PyTorch state dicts on the device.

* Drawn from the seed in Flax's default scheme for convolutions (kernel
  ``lecun_normal``: a normal truncated at two standard deviations, scaled to
  variance ``1 / fan_in``; bias zero), on the device with a
  ``torch.Generator`` there, all kernels of a model in one draw.
* Read from a ``/``-keyed ``.npz`` of Flax variables (the repository's
  trained ``weights/*.npz``): Flax kernels ``(kh, kw, I, O)`` become
  ``(O, I, kh, kw)``, and FastDVDnet's Flax scopes map onto the published
  model's ``convblock`` indices.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import Tensor

#: std of the standard normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978


def lecun_normal_convs(shapes: list[tuple[int, int]], seed: int,
                       device: torch.device | str, ksize: int = 3) -> list[Tensor]:
    """Kernels ``(O, I, k, k)`` for ``(I, O)`` pairs, drawn from one uniform
    tensor by the inverse normal CDF restricted to [-2, 2]."""
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = [o * i * ksize * ksize for i, o in shapes]
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = lo + (1 - 2 * lo) * torch.rand(sum(sizes), generator=g, device=device)
    z = math.sqrt(2) * torch.special.erfinv(2 * u - 1)
    out = []
    for (i, o), part in zip(shapes, torch.split(z, sizes)):
        std = math.sqrt(1.0 / (i * ksize * ksize)) / TRUNC_STD
        out.append((part * std).reshape(o, i, ksize, ksize).contiguous())
    return out


def ffdnet_init(in_nc: int, out_nc: int, nc: int, nb: int, seed: int,
                device: torch.device | str) -> dict[str, Tensor]:
    """FFDNet's state dict (``model.{2i}.weight`` / ``.bias``) in Flax's
    default initialisation."""
    shapes = [(4 * in_nc + 1, nc)] + [(nc, nc)] * (nb - 2) + [(nc, 4 * out_nc)]
    sd: dict[str, Tensor] = {}
    for i, (w, (_, o)) in enumerate(zip(lecun_normal_convs(shapes, seed, device), shapes)):
        sd[f"model.{2 * i}.weight"] = w
        sd[f"model.{2 * i}.bias"] = torch.zeros(o, device=device)
    return sd


def load_npz_tree(path: str) -> dict:
    """A ``/``-keyed ``.npz`` as a nested dict of numpy arrays."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *scopes, leaf = key.split("/")
            node = tree
            for s in scopes:
                node = node.setdefault(s, {})
            node[leaf] = z[key]
    return tree


_CV_INDEX = {"conv0": "0", "bn0": "1", "conv1": "3", "bn1": "4"}


def _fastdvd_prefix(path: tuple[str, ...]) -> str:
    """Flax module path ``(temp, block, [cvblock,] layer)`` -> state-dict prefix."""
    temp, block, *rest = path
    if rest[0] == "cvblock":  # a CvBlock inside a block: index 3 of a down, 0 of an up
        outer = "3" if block.startswith("downc") else "0"
        return f"{temp}.{block}.convblock.{outer}.convblock.{_CV_INDEX[rest[1]]}"
    if block.startswith("upc"):  # the conv before the pixel shuffle
        return f"{temp}.{block}.convblock.1"
    return f"{temp}.{block}.convblock.{_CV_INDEX[rest[0]]}"


def _leaves(tree: Mapping[str, Any], path: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path, k, np.asarray(v)


def fastdvdnet_from_npz(path: str, device: torch.device | str) -> dict[str, Tensor]:
    """FastDVDnet's state dict from Flax variables (``params`` and
    ``batch_stats``)."""
    tree = load_npz_tree(path)
    sd: dict[str, Tensor] = {}
    for p, leaf, val in _leaves(tree["params"]):
        prefix = _fastdvd_prefix(p)
        if leaf == "kernel":
            w = np.ascontiguousarray(np.transpose(val.astype(np.float32), (3, 2, 0, 1)))
            sd[f"{prefix}.weight"] = torch.from_numpy(w)
        else:
            sd[f"{prefix}.{'weight' if leaf == 'scale' else 'bias'}"] = torch.from_numpy(
                np.array(val, np.float32))
    for p, leaf, val in _leaves(tree["batch_stats"]):
        prefix = _fastdvd_prefix(p)
        sd[f"{prefix}.running_{leaf}"] = torch.from_numpy(np.array(val, np.float32))
        sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return {k: v.to(device) for k, v in sd.items()}
