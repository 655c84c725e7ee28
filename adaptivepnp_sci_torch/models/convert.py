"""Weight bridge between Flax variables and PyTorch state dicts
(port of ``adaptivepnp_sci_tpu.models.convert``, FFDNet, FastDVDnet and DDnet
parts, and of the ``/``-keyed ``.npz`` reader of
``adaptivepnp_sci_tpu.train.trainer``).

The JAX package converts a torch conv weight ``(O, I, kh, kw)`` to a Flax
kernel ``(kh, kw, I, O)``; here the bridge runs the other way as well, so
the same numpy arrays drive both packages. Flax names are
``params/conv_{i}/{kernel,bias}``; the port's FFDNet keeps the KAIR layout
``model.{2i}.{weight,bias}``.

FastDVDnet: Flax scopes ``{temp1,temp2}/{inc,downc0,downc1,upc2,upc1,outc}/
[cvblock/]{conv0,bn0,conv1,bn1}`` map onto the published model's
``convblock`` indices, which the port's modules keep. BatchNorm splits into
``params`` (``scale``, ``bias``) and ``batch_stats`` (``mean``, ``var``).

DDnet: Flax scopes ``{temp1,temp11,temp2}/{inc_1,downc*,upc*,outc,fusion}/
[cvblock/]{conv0,conv1}`` map onto the reference checkpoint's no-BN
``convblock`` indices (a conv at 0 and 2 of its ``Sequential``); the
``weight_tensor_*`` keep their names and shapes. All convolutions are
bias-free.

Adam: optax's ``ScaleByAdamState`` (``count``, and the moment trees ``mu``,
``nu`` shaped like ``params``) maps onto ``torch.optim.Adam``'s state dict
(``step``, ``exp_avg``, ``exp_avg_sq`` per parameter) through the same
converters (:func:`adam_state_from_optax`, :func:`adam_state_to_optax`).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn as nn
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


# Flax scope -> index inside a (Conv, BN, ReLU, Conv, BN, ReLU) ``convblock``
_CV_INDEX = {"conv0": "0", "bn0": "1", "conv1": "3", "bn1": "4"}
_CV_SCOPE = {v: k for k, v in _CV_INDEX.items()}


def _fdvd_torch_prefix(path: tuple[str, ...]) -> str:
    """Flax module path ``(temp, block, [cvblock,] layer)`` -> state-dict prefix."""
    temp, block, *rest = path
    if rest[0] == "cvblock":  # nested CvBlock: index 3 of a down block, 0 of an up block
        outer = "3" if block.startswith("downc") else "0"
        return f"{temp}.{block}.convblock.{outer}.convblock.{_CV_INDEX[rest[1]]}"
    if block.startswith("upc"):  # the conv before the pixel shuffle
        return f"{temp}.{block}.convblock.1"
    return f"{temp}.{block}.convblock.{_CV_INDEX[rest[0]]}"


def _fdvd_flax_path(parts: list[str]) -> tuple[str, ...]:
    """Inverse of :func:`_fdvd_torch_prefix` on a split state-dict prefix."""
    temp, block, _, idx, *rest = parts
    if rest:
        return (temp, block, "cvblock", _CV_SCOPE[rest[1]])
    if block.startswith("upc"):
        return (temp, block, "conv0")
    return (temp, block, _CV_SCOPE[idx])


def _leaves(tree: Mapping[str, Any], path: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path, k, np.asarray(v)


def fastdvdnet_from_flax(variables: Mapping[str, Any]) -> dict[str, Tensor]:
    """Flax FastDVDnet variables (``params`` and ``batch_stats``, numpy leaves)
    -> state dict for :class:`adaptivepnp_sci_torch.models.fastdvdnet.FastDVDnet`."""
    sd: dict[str, Tensor] = {}
    for path, leaf, val in _leaves(variables["params"]):
        prefix = _fdvd_torch_prefix(path)
        if leaf == "kernel":
            sd[f"{prefix}.weight"] = torch.from_numpy(conv_weight(val.astype(np.float32)))
        else:  # BatchNorm scale / bias
            name = "weight" if leaf == "scale" else "bias"
            sd[f"{prefix}.{name}"] = torch.from_numpy(np.array(val, np.float32))
    for path, leaf, val in _leaves(variables["batch_stats"]):
        prefix = _fdvd_torch_prefix(path)
        sd[f"{prefix}.running_{leaf}"] = torch.from_numpy(np.array(val, np.float32))
        sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


def fastdvdnet_to_flax(state_dict: Mapping[str, Tensor]) -> dict:
    """Inverse of :func:`fastdvdnet_from_flax`: a (possibly adapted) state
    dict -> Flax variables with numpy leaves."""
    out: dict = {"params": {}, "batch_stats": {}}

    def put(collection: str, path: tuple[str, ...], leaf: str, value: np.ndarray) -> None:
        node = out[collection]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value

    for key, t in state_dict.items():
        *parts, leaf = key.removeprefix("module.").split(".")
        if leaf == "num_batches_tracked":
            continue
        path = _fdvd_flax_path(parts)
        val = t.detach().cpu().numpy()
        if leaf.startswith("running_"):
            put("batch_stats", path, leaf.removeprefix("running_"), val)
        elif path[-1].startswith("bn"):
            put("params", path, "scale" if leaf == "weight" else "bias", val)
        else:
            put("params", path, "kernel", conv_kernel(val))
    return out


# DDnet: index of a conv inside a no-BN (Conv, ReLU, Conv, ReLU) ``convblock``
_NOBN_INDEX = {"conv0": "0", "conv1": "2"}
_NOBN_SCOPE = {v: k for k, v in _NOBN_INDEX.items()}


def _ddnet_torch_prefix(path: tuple[str, ...]) -> str:
    """Flax module path ``(temp, block, [cvblock,] conv)`` -> state-dict prefix."""
    temp, block, *rest = path
    if rest[0] == "cvblock":  # nested CvBlock: index 2 of a down block, 0 of an up block
        outer = "2" if block.startswith("downc") else "0"
        return f"{temp}.{block}.convblock.{outer}.convblock.{_NOBN_INDEX[rest[1]]}"
    if block.startswith("upc"):  # the conv before the pixel shuffle
        return f"{temp}.{block}.convblock.1"
    return f"{temp}.{block}.convblock.{_NOBN_INDEX[rest[0]]}"


def _ddnet_flax_path(parts: list[str]) -> tuple[str, ...]:
    """Inverse of :func:`_ddnet_torch_prefix` on a split state-dict prefix."""
    temp, block, _, idx, *rest = parts
    if rest:
        return (temp, block, "cvblock", _NOBN_SCOPE[rest[1]])
    if block.startswith("upc"):
        return (temp, block, "conv0")
    return (temp, block, _NOBN_SCOPE[idx])


def ddnet_from_flax(variables: Mapping[str, Any]) -> dict[str, Tensor]:
    """Flax DDnet variables (or the tree of ``weights/ddnet.npz``, numpy
    leaves) -> state dict for :class:`adaptivepnp_sci_torch.models.ddnet.DDnet`."""
    sd: dict[str, Tensor] = {}
    for path, leaf, val in _leaves(variables["params"]):
        if not path:  # weight_tensor_in / in2 / out
            sd[leaf] = torch.from_numpy(np.array(val, np.float32))
        else:
            sd[f"{_ddnet_torch_prefix(path)}.weight"] = torch.from_numpy(
                conv_weight(val.astype(np.float32)))
    return sd


def ddnet_to_flax(state_dict: Mapping[str, Tensor]) -> dict:
    """Inverse of :func:`ddnet_from_flax`: a (possibly adapted) state dict ->
    Flax variables with numpy leaves."""
    params: dict = {}
    for key, t in state_dict.items():
        val = t.detach().cpu().numpy()
        if key.startswith("weight_tensor"):
            params[key] = val
            continue
        *parts, _ = key.split(".")
        node = params
        *scopes, conv = _ddnet_flax_path(parts)
        for p in scopes:
            node = node.setdefault(p, {})
        node[conv] = {"kernel": conv_kernel(val)}
    return {"params": params}


def ddnet_state_dict_from_reference(sd: Mapping[str, Any]) -> dict[str, Tensor]:
    """A reference DDnet checkpoint's state dict (tensors or numpy arrays) ->
    state dict for :class:`~adaptivepnp_sci_torch.models.ddnet.DDnet`: the
    DataParallel ``module.`` prefix and the unused noise-map ``inc`` blocks
    are dropped, the rest loads as it is."""
    out: dict[str, Tensor] = {}
    for key, val in sd.items():
        key = key.removeprefix("module.")
        if key.split(".")[1:2] == ["inc"]:
            continue
        out[key] = torch.as_tensor(val if isinstance(val, Tensor) else np.asarray(val),
                                   dtype=torch.float32)
    return out


def load_variables_npz(path: str) -> dict:
    """Read a ``/``-keyed ``.npz`` of model variables (the files in
    ``weights/``) into a nested dict of numpy arrays."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *scopes, leaf = key.split("/")
            node = tree
            for p in scopes:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def adam_state_from_optax(count: Any, mu: Mapping[str, Any], nu: Mapping[str, Any],
                          model: nn.Module, from_flax: Callable[[Mapping[str, Any]], dict],
                          lr: float) -> dict:
    """optax Adam moments -> a ``torch.optim.Adam`` state dict for the
    parameters of ``model`` at ``lr``. ``count`` is the step count; ``mu`` and
    ``nu`` are trees shaped like the Flax ``params`` (numpy leaves), mapped by
    ``from_flax`` (:func:`ffdnet_from_flax`, :func:`fastdvdnet_from_flax` or
    :func:`ddnet_from_flax`) onto the parameter names."""
    m = from_flax({"params": mu, "batch_stats": {}})
    v = from_flax({"params": nu, "batch_stats": {}})
    names = [name for name, _ in model.named_parameters()]
    sd = torch.optim.Adam(model.parameters(), lr=lr).state_dict()
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    sd["state"] = {i: {"step": step.clone(), "exp_avg": m[name], "exp_avg_sq": v[name]}
                   for i, name in enumerate(names)}
    return sd


def adam_state_to_optax(state_dict: Mapping[str, Any], model: nn.Module,
                        to_flax: Callable[[Mapping[str, Tensor]], dict]
                        ) -> tuple[int, dict, dict]:
    """Inverse of :func:`adam_state_from_optax`: ``(count, mu, nu)`` with
    ``mu``, ``nu`` Flax ``params`` trees of numpy arrays (zeros for a
    parameter Adam has not stepped). ``to_flax`` is the model's inverse
    converter (:func:`ffdnet_to_flax`, ...)."""
    state = state_dict["state"]
    count, m, v = 0, {}, {}
    for i, (name, p) in enumerate(model.named_parameters()):
        st = state.get(i)
        if st is None:
            m[name] = v[name] = torch.zeros_like(p)
            continue
        count = max(count, int(st["step"]))
        m[name], v[name] = st["exp_avg"], st["exp_avg_sq"]
    return count, to_flax(m)["params"], to_flax(v)["params"]
