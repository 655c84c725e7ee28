"""FastDVDnet as the prior and DDnet as the demosaicker, both in the
configuration's low precision with the repository's weights: one dict of
both networks' state dicts, DDnet's keys under :data:`DM`. FastDVDnet's part
is :mod:`pnpbench.models.fastdvdnet`'s (the program's prior, the reference
forward, what adapts); DDnet keeps its weights through the solve.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import Tensor

from pnpbench.counts import ddnet as ddnet_counts
from pnpbench.models import fastdvdnet
from pnpbench.reference import ddnet as ref_ddnet

ROOT = Path(__file__).resolve().parents[2]
#: the prefix of DDnet's keys in the weights
DM = "demosaicker."
#: the seed of the probe weights
PROBE_SEED = 20231


def prior_params(params: dict[str, Tensor]) -> dict[str, Tensor]:
    return {k: v for k, v in params.items() if not k.startswith(DM)}


def demosaicker_params(params: dict[str, Tensor]) -> dict[str, Tensor]:
    return {k[len(DM):]: v for k, v in params.items() if k.startswith(DM)}


def weights(config: dict, seed: int, device: torch.device) -> dict[str, Tensor]:
    """Both networks' trained weights, whose convolutions have to be the
    widths the configuration states and the operation counts assume."""
    dm = config["demosaicker"]
    sd = ref_ddnet.state_dict_from_npz(str(ROOT / dm["weights"]["file"]), device)
    chs = tuple(dm["channels"])
    want = sorted([(co, ci // g) for ci, co, g, _, _ in (
        ddnet_counts.convs(4, 4, 1, 3, chs) + ddnet_counts.convs(4, 4, 4, 4, chs)
        + ddnet_counts.convs(4, 4, 3, 3, chs))] + [(4, 4), (3, 4)])
    have = sorted((v.shape[0], v.shape[1]) for v in sd.values() if v.dim() == 4)
    if have != want:
        raise ValueError(f"DDnet's convolutions (out, in) {have} are not the "
                         f"configuration's {want}")
    return {**fastdvdnet.weights(config, seed, device), **{DM + k: v for k, v in sd.items()}}


def probe_params(params: dict[str, Tensor]) -> dict[str, Tensor]:
    """DDnet's keys and shapes with seeded random values in place of its
    weights: He-normal convolutions, window and branch weights around 1. With
    them both branches carry the output, which the repository's weights do
    not (their second branch moves DDnet's output by about a bf16 rounding);
    the cell's entry checks the demosaicker on them."""
    g = torch.Generator().manual_seed(PROBE_SEED)
    out = {}
    for k, v in sorted(demosaicker_params(params).items()):
        if v.dim() == 4:
            r = (2 / v[0].numel()) ** 0.5 * torch.randn(v.shape, generator=g)
        else:
            r = 1 + 0.1 * torch.randn(v.shape, generator=g)
        out[DM + k] = r.to(v.device)
    return out


def trainable(params: dict[str, Tensor]) -> list[str]:
    return fastdvdnet.trainable(prior_params(params))


def program_prior(config: dict, params: dict[str, Tensor], device: torch.device):
    return fastdvdnet.program_prior(config, prior_params(params), device)


def program_demosaicker(config: dict, params: dict[str, Tensor], device: torch.device):
    """The program's fixed-weight deep demosaicker ``(B, H, W) -> (B, H, W, 3)``."""
    from adaptivepnp_sci_torch.models.ddnet import DDnet
    from adaptivepnp_sci_torch.solvers.priors import ddnet_demosaic

    dm = config["demosaicker"]
    model = DDnet(num_input_frames=dm["window"], dtype=fastdvdnet.DTYPES[dm["precision"]])
    return ddnet_demosaic(model, demosaicker_params(params), window=dm["window"])


def reference_denoiser(config: dict, precision: str):
    return fastdvdnet.reference_denoiser(config, precision)


def reference_demosaicker(config: dict, params: dict[str, Tensor], precision: str):
    dm = demosaicker_params(params)
    return lambda mosaic: ref_ddnet.demosaic(dm, mosaic, precision)


def flops_per_call(config: dict, b: int, h: int, w: int) -> int:
    """The prior's call on ``b`` frames."""
    return fastdvdnet.flops_per_call(config, b, h, w)

