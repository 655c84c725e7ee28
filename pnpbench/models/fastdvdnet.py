"""FastDVDnet: the repository's trained weights (a ``/``-keyed ``.npz`` of
Flax variables, read by the benchmark), the program's ``fastdvd_prior`` over
a ``FastDVDnet`` in the configuration's low precision, the plain reference
forward in that precision, the convolutions and BatchNorm scales and shifts
adapting (not the running statistics)."""

from __future__ import annotations

from pathlib import Path

import torch
from torch import Tensor

from pnpbench import weights as weights_mod
from pnpbench.counts import fastdvdnet as counts
from pnpbench.reference import fastdvdnet as ref

ROOT = Path(__file__).resolve().parents[2]
DTYPES = {"bfloat16": torch.bfloat16}
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def weights(config: dict, seed: int, device: torch.device) -> dict[str, Tensor]:
    """The trained weights, whose convolutions have to be the widths the
    configuration states and the operation count assumes."""
    del seed  # trained weights
    params = weights_mod.fastdvdnet_from_npz(str(ROOT / config["weights"]["file"]), device)
    for block in ("temp1", "temp2"):
        have = sorted((v.shape[0], v.shape[1]) for k, v in params.items()
                      if k.startswith(f"{block}.") and v.dim() == 4)
        want = sorted((co, ci // g) for ci, co, g, _, _ in counts.convs(
            4, 4, tuple(config["channels"]), interm=config["interm_channels"]))
        if have != want:
            raise ValueError(f"{block}'s convolutions (out, in) {have} are not the "
                             f"configuration's {want}")
    return params


def trainable(params: dict[str, Tensor]) -> list[str]:
    return [k for k in params if not k.endswith(BUFFERS)]


def program_prior(config: dict, params: dict[str, Tensor], device: torch.device):
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior

    model = FastDVDnet(dtype=DTYPES[config["precision"]], remat=config["remat"]).to(device)
    model.load_state_dict(params)
    return fastdvd_prior(model.eval(), window=config["window"])


def reference_denoiser(config: dict, precision: str):
    return lambda p, rgb, sigma: ref.seq_circular(p, rgb, sigma, precision)


def flops_per_call(config: dict, b: int, h: int, w: int) -> int:
    return counts.flops_per_call(b, h, w, tuple(config["channels"]), config["interm_channels"])
