"""PyTorch / CUDA port of ``adaptivepnp_sci_tpu`` for one NVIDIA H100.

Module names follow the JAX package so each counterpart is easy to find:
``solvers`` (GAP-TV, the two-stage ADMM with its ``select_best`` guard,
relaxation, closed-form demosaic and in-scan demosaicker adaptation, its
sequence, batched and tiled drivers, the end-to-end entry point, the
one-stage GAP with a deep prior, the grayscale solver, the priors and the
DDnet demosaicker), ``models`` (FFDNet, FastDVDnet, DDnet and the Flax weight
and Adam-state bridge), ``adapt`` (online adaptation of the denoiser, with a
fresh or a carried Adam, and of DDnet), ``configs.scenes`` (the scene
tables), ``ops`` (with Menon 2007 demosaicking and the patch ops),
``data`` (synthetic scenes and the ``.mat`` scene and result files),
``utils.image`` (host PSNR/SSIM), ``pipelines`` (the drivers over a
multi-measurement scene), ``train`` (offline training of the three denoisers,
:class:`Trainer`) and ``cli`` (``python -m adaptivepnp_sci_torch.cli``).
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
from adaptivepnp_sci_torch.configs.scenes import admm_config_for
from adaptivepnp_sci_torch.models.ddnet import DDnet
from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_torch.models.ffdnet import FFDNet, ffdnet_gray
from adaptivepnp_sci_torch.ops.menon2007 import menon2007
from adaptivepnp_sci_torch.solvers.end_to_end import (
    EndToEndResult,
    reconstruct_single_dispatch,
)
from adaptivepnp_sci_torch.solvers.gap_deep import GapDeepConfig, gap_deep
from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, gap_tv
from adaptivepnp_sci_torch.solvers.gray import GrayConfig, gap_denoise_gray
from adaptivepnp_sci_torch.solvers.priors import (
    Prior,
    ddnet_demosaic,
    fastdvd_prior,
    ffdnet_prior,
)
from adaptivepnp_sci_torch.solvers.two_stage_admm import (
    ADMMConfig,
    make_dm_spec,
    two_stage_admm,
    two_stage_admm_batched,
    two_stage_admm_sequence,
    two_stage_admm_tiled,
)
from adaptivepnp_sci_torch.train import Trainer, TrainerConfig

__all__ = [
    "ADMMConfig",
    "AdaptConfig",
    "DDnet",
    "EndToEndResult",
    "FFDNet",
    "FastDVDnet",
    "GapDeepConfig",
    "GapTVConfig",
    "GrayConfig",
    "Prior",
    "Trainer",
    "TrainerConfig",
    "admm_config_for",
    "ddnet_demosaic",
    "fastdvd_prior",
    "ffdnet_gray",
    "ffdnet_prior",
    "gap_deep",
    "gap_denoise_gray",
    "gap_tv",
    "make_dm_spec",
    "menon2007",
    "reconstruct_single_dispatch",
    "two_stage_admm",
    "two_stage_admm_batched",
    "two_stage_admm_sequence",
    "two_stage_admm_tiled",
]
