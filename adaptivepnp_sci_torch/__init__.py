"""PyTorch / CUDA port of ``adaptivepnp_sci_tpu`` for one NVIDIA H100.

Module names follow the JAX package so each counterpart is easy to find.
Plain tensor code is PyTorch; the repository's three Pallas kernels (the
x-update and the TV prox of the flagship path, the fused conv pair of the
FastDVDnet prior's bf16 mode) are hand-written CUDA kernels for Hopper
(``csrc/``), built with ``nvcc`` at first use and bound through
:mod:`adaptivepnp_sci_torch.ops.cuda_kernels`.
On CPU tensors every kernel wrapper runs its plain PyTorch version instead.

This package imports neither JAX nor the JAX package: it runs where JAX is
not installed.
"""

from adaptivepnp_sci_torch.adapt.online import AdaptConfig
from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_torch.models.ffdnet import FFDNet
from adaptivepnp_sci_torch.solvers.end_to_end import (
    EndToEndResult,
    reconstruct_single_dispatch,
)
from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, gap_tv
from adaptivepnp_sci_torch.solvers.priors import Prior, fastdvd_prior, ffdnet_prior
from adaptivepnp_sci_torch.solvers.two_stage_admm import ADMMConfig, two_stage_admm

__all__ = [
    "ADMMConfig",
    "AdaptConfig",
    "EndToEndResult",
    "FFDNet",
    "FastDVDnet",
    "GapTVConfig",
    "Prior",
    "fastdvd_prior",
    "ffdnet_prior",
    "gap_tv",
    "reconstruct_single_dispatch",
    "two_stage_admm",
]
