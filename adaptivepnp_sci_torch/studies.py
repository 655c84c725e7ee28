"""Shared parts of the A/B, sweep and decomposition tools (the ports of the
JAX package's ``scripts/ab_*.py``, ``bench_fastdvd_bf16.py``,
``bench_2048_adaptive.py``, ``decompose_*_floor.py``, ``sweep_*.py``,
``diag_teacher_sigma.py`` and ``eval_teacher_inloop.py``): the flagship's
and the FastDVDnet row's schedules, a scene's tensors on the device, and the
timer.

Each tool is ``python -m adaptivepnp_sci_torch.<tool>`` and runs on the card
unless ``--device cpu`` is given. A time is the host clock around a call
that ends with ``torch.cuda.synchronize()``, the least of ``n`` calls after
one warm-up (the kernels' first launches, cuDNN's plans). Where the JAX
scripts timed one compiled program (a ``lax.scan`` of the solver), the port
runs an eager Python loop of kernel and library launches on the card;
nothing returns to the host before the end of a call.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable

import torch
from torch import Tensor

from adaptivepnp_sci_torch.adapt.online import AdaptConfig
from adaptivepnp_sci_torch.cli import REPO_WEIGHTS
from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, as_f32
from adaptivepnp_sci_torch.solvers.two_stage_admm import ADMMConfig


#: the flagship: FFDNet-color, sigma (25, 12, 6)/255 x (15, 6, 4), two Adam
#: steps at lr 2e-6 every 15 iterations
FLAGSHIP_SIGMA = (25 / 255, 12 / 255, 6 / 255)
FLAGSHIP_ITERS = (15, 6, 4)
FLAGSHIP_ADAPT = AdaptConfig(lr=2e-6, update_per_iter=2, interval_iter=15, initial_iter=1)
#: the FastDVDnet row: sigma (12, 6)/255 x (24, 12), two Adam steps at lr
#: 2e-7 every 12 iterations
FASTDVD_SIGMA = (12 / 255, 6 / 255)
FASTDVD_ITERS = (24, 12)
FASTDVD_ADAPT = AdaptConfig(lr=2e-7, update_per_iter=2, interval_iter=12, initial_iter=1)
#: the 40-iteration GAP-TV warm start of every tool
WARM = GapTVConfig(iters=40)


def flagship_config(adapt: AdaptConfig | None = FLAGSHIP_ADAPT, **kw: Any) -> ADMMConfig:
    """The flagship's ``ADMMConfig`` (``adapt=None``: fixed weights); ``kw``
    replaces fields, e.g. a cut ``iters``."""
    return ADMMConfig(**{"sigma": FLAGSHIP_SIGMA, "iters": FLAGSHIP_ITERS,
                         "denoiser": "ffdnet", "adapt": adapt, **kw})


def fastdvd_config(adapt: AdaptConfig | None = FASTDVD_ADAPT, **kw: Any) -> ADMMConfig:
    """The FastDVDnet row's ``ADMMConfig`` (rho 0.55); ``kw`` replaces fields."""
    return ADMMConfig(**{"sigma": FASTDVD_SIGMA, "iters": FASTDVD_ITERS,
                         "denoiser": "fastdvd", "adapt": adapt, **kw})


def with_adapt(config: ADMMConfig, **kw: Any) -> ADMMConfig:
    """``config`` with fields of its ``AdaptConfig`` replaced."""
    return dataclasses.replace(config, adapt=dataclasses.replace(config.adapt, **kw))


def cut_iters(iters: tuple[int, ...], cut: int | None) -> tuple[int, ...]:
    """A schedule's stages shortened to at most ``cut`` iterations each
    (None: as they are)."""
    return iters if cut is None else tuple(min(n, cut) for n in iters)


def synchronize(device: torch.device | str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(fn: Callable[[], Any], n: int, device: torch.device | str) -> float:
    """The least of ``n`` host-clock times of ``fn()`` after one warm-up
    call, each ended by a device synchronisation (``n = 0``: the warm-up's
    time)."""
    ts = []
    for _ in range(n + 1):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        ts.append(time.perf_counter() - t0)
    return min(ts[1:] or ts)


def on_device(scene: Any, device: torch.device | str) -> tuple[Tensor, Tensor, Tensor]:
    """``(meas, mask, orig_bayer)`` of a ``make_scene`` scene as float32
    tensors on ``device``."""
    return (as_f32(scene.meas, device), as_f32(scene.mask, device),
            as_f32(scene.orig_bayer, device))


def mean_db(res: Any) -> tuple[float, float]:
    """A result's mean per-frame PSNR and SSIM."""
    return float(res.psnr_per_frame.mean()), float(res.ssim_per_frame.mean())


def load_ffdnet_weights(source: str | dict[str, Tensor]) -> dict[str, Tensor]:
    """FFDNet-color's state dict from a reference ``.pth``, a ``/``-keyed
    ``.npz`` of Flax variables or a trainer ``.pt``; a state dict is
    returned as it is."""
    from adaptivepnp_sci_torch.distill_fastdvd import load_teacher

    return load_teacher(source) if isinstance(source, str) else source


def parser(doc: str, ffdnet: bool = False) -> argparse.ArgumentParser:
    """A tool's argument parser with ``--device`` (and ``--ffdnet``)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain versions of the kernels")
    if ffdnet:
        ap.add_argument("--ffdnet", required=True,
                        help="FFDNet-color weights: .pth, /-keyed .npz or trainer .pt")
    return ap
