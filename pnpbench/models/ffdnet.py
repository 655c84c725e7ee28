"""FFDNet-color: weights drawn from the seed in Flax's default scheme, the
program's ``ffdnet_prior`` (float32, TF32 off inside the solver), the plain
reference forward, every parameter adapting."""

from __future__ import annotations

import torch
from torch import Tensor

from pnpbench import traffic, weights as weights_mod
from pnpbench.counts import ffdnet as counts
from pnpbench.reference import ffdnet as ref


def weights(config: dict, seed: int, device: torch.device) -> dict[str, Tensor]:
    return weights_mod.ffdnet_init(config["in_nc"], config["out_nc"], config["nc"],
                                   config["nb"], traffic.sub_seed(seed, traffic.WEIGHTS), device)


def trainable(params: dict[str, Tensor]) -> list[str]:
    return list(params)


def program_prior(config: dict, params: dict[str, Tensor], device: torch.device):
    from adaptivepnp_sci_torch.models.ffdnet import FFDNet
    from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior

    model = FFDNet(in_nc=config["in_nc"], out_nc=config["out_nc"], nc=config["nc"],
                   nb=config["nb"]).to(device)
    model.load_state_dict(params)
    return ffdnet_prior(model.eval())


def reference_denoiser(config: dict, precision: str):
    nb = config["nb"]
    return lambda p, rgb, sigma: ref.forward(p, rgb, sigma, nb, precision)


def flops_per_call(config: dict, b: int, h: int, w: int) -> int:
    return counts.flops_per_call(b, h, w, config["in_nc"], config["nc"], config["nb"],
                                 config["out_nc"])
