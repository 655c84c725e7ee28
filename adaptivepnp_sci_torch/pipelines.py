"""Experiment drivers over a multi-measurement scene
(port of ``adaptivepnp_sci_tpu.pipelines``): the warm start, the
online-adaptive reconstruction with its per-scene schedule, the
ground-truth-free choices of demosaicker and prior weights, and the adapted
state on disk.

The functions keep the JAX package's argument names (``variables=`` for the
denoiser's state dict, where the port's solvers say ``params=``) and add
``device`` (default ``"cuda"``). Every solve they start runs in full float32,
with TF32 off.

Random draws: the JAX package passes ``PRNGKey(t)`` to measurement ``t``; the
port draws the adaptation noise and crop offsets from one CPU
``torch.Generator`` carried through the measurements (the same draws on any
device), so the numbers differ from JAX's. The held-out pixels
of :func:`holdout_cv_residuals` come from
:func:`adaptivepnp_sci_torch.solvers.two_stage_admm.holdout_mask`, the
guard's mask function.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import numpy as np
import torch

from adaptivepnp_sci_torch.configs.scenes import WARM_START_ITERS, admm_config_for
from adaptivepnp_sci_torch.data.mat_io import SceneData
from adaptivepnp_sci_torch.ops import bayer, physics
from adaptivepnp_sci_torch.solvers import two_stage_admm as tsa
from adaptivepnp_sci_torch.solvers.gap_deep import GapDeepConfig, gap_deep
from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, as_f32, gap_tv
from adaptivepnp_sci_torch.solvers.priors import Prior, ddnet_demosaic

log = logging.getLogger(__name__)


@dataclass
class ReconstructionOutput:
    x_bayer: np.ndarray          # (T, B, H, W)
    x_rgb: np.ndarray | None     # (T, B, H, W, 3)
    psnr: np.ndarray             # (T, B)
    ssim: np.ndarray             # (T, B)
    psnr_all_iter: np.ndarray    # (T, iters)
    seconds_per_meas: list[float]
    variables: Any               # the final (possibly adapted) denoiser state dict
    #: the final adapted demosaicker state dict (``dm_update`` runs)
    dm_variables: Any = None


def save_adapted_state(path: str, variables: Mapping[str, torch.Tensor],
                       opt_state: Mapping | None = None) -> None:
    """Save adapted denoiser weights (a state dict) and, optionally, the
    carried Adam's state dict to one ``torch.save`` file, so that refined
    weights outlive the run. The JAX package writes an orbax directory
    instead; neither package reads the other's."""
    cpu = {k: v.detach().cpu() for k, v in variables.items()}
    torch.save({"variables": cpu, "opt_state": opt_state}, path)


def load_adapted_state(path: str, like_variables: Mapping[str, torch.Tensor] | None = None,
                       like_opt_state: Any = None) -> tuple[dict, Any]:
    """Read what :func:`save_adapted_state` wrote: ``(variables,
    opt_state)``, on the CPU, with ``weights_only=True`` (tensors and plain
    containers only). ``like_variables`` (optional) must have the same
    names. ``like_opt_state`` is accepted for the JAX package's signature
    and not read: the Adam state dict carries its own structure."""
    del like_opt_state
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    variables = ckpt["variables"]
    if like_variables is not None and set(like_variables) != set(variables):
        raise ValueError(f"{path}: the saved parameter names differ from the model's")
    return variables, ckpt["opt_state"]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_warm_start(
    scene: SceneData,
    iters: int = WARM_START_ITERS,
    denoiser: str = "tv",
    prior: Prior | None = None,
    variables: Mapping[str, torch.Tensor] | None = None,
    sigma: tuple[float, ...] = (50 / 255, 25 / 255, 12 / 255),
    device: torch.device | str = "cuda",
) -> ReconstructionOutput:
    """Warm start over all measurements of a scene.

    ``denoiser='tv'`` is GAP-TV; a deep prior with its variables selects the
    one-stage GAP with a deep prior (:func:`gap_deep`), its ``sigma``
    continuation split evenly over ``iters``.
    """
    if denoiser == "tv":
        cfg = GapTVConfig(iters=iters)
    else:
        if prior is None or variables is None:
            raise ValueError("deep warm start needs prior + variables")
        per = max(iters // len(sigma), 1)
        cfg = GapDeepConfig(sigma=sigma, iters=(per,) * len(sigma), denoiser=denoiser)
    outs, psnrs, ssims, traces, times = [], [], [], [], []
    with tsa.full_f32():
        for t in range(scene.n_meas):
            t0 = time.perf_counter()
            orig = scene.orig_bayer[t] if scene.orig_bayer is not None else None
            if denoiser == "tv":
                res = gap_tv(scene.meas[t], scene.mask, cfg, orig_bayer=orig, device=device)
            else:
                res = gap_deep(scene.meas[t], scene.mask, cfg, prior, variables,
                               orig_bayer=orig, device=device)
            outs.append(_to_numpy(res.x_bayer))
            times.append(time.perf_counter() - t0)
            psnrs.append(_to_numpy(res.psnr_per_frame))
            ssims.append(_to_numpy(res.ssim_per_frame))
            traces.append(_to_numpy(res.psnr_trace))
            log.info("warmstart %s meas %d/%d: %.2f dB in %.2fs", scene.name, t + 1,
                     scene.n_meas, psnrs[-1].mean(), times[-1])
    return ReconstructionOutput(np.stack(outs), None, np.stack(psnrs), np.stack(ssims),
                                np.stack(traces), times, None)


def _gap_tv_warm(meas: np.ndarray, mask: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """The 40-iteration GAP-TV warm start of one measurement ``(B, H, W)``."""
    return gap_tv(meas, mask, GapTVConfig(iters=WARM_START_ITERS), device=device).x_bayer


def holdout_cv_residuals(
    y_bayer: np.ndarray,
    phi_bayer: np.ndarray,
    x0_bayer: np.ndarray | torch.Tensor,
    candidates: list[dict],
    holdout_frac: float = 0.05,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> list[float]:
    """Held-out measurement residual of a fixed-weight solve per candidate
    configuration (lower = better), a ground-truth-free statistic for
    choosing among configurations.

    A ``holdout_frac`` subset of snapshot pixels
    (:func:`~adaptivepnp_sci_torch.solvers.two_stage_admm.holdout_mask`
    with ``seed``) leaves the solve's data term; every candidate runs its own
    schedule from the same warm start, and is scored by how well its
    reconstruction predicts the true measurement at the held-out pixels.

    Each candidate is a dict of :func:`two_stage_admm` keyword arguments with
    ``config``, ``prior``, ``variables`` and optionally ``demosaic_fn``.
    Adaptation and the ``select_best`` guard are stripped, as in the JAX
    package.
    """
    y = as_f32(y_bayer, device)
    phi = as_f32(phi_bayer, device)
    hold = tsa.holdout_mask(seed, holdout_frac, tuple(y.shape), device)
    y_train = y * (1.0 - hold)
    phi_train = phi * (1.0 - hold)[None]
    phi_p = bayer.pack(phi)
    y_p = bayer.pack(y)
    hold_p = bayer.pack(hold)

    out = []
    with tsa.full_f32():
        for cand in candidates:
            kw = dict(cand)
            cfg = dataclasses.replace(kw.pop("config"), adapt=None, select_best=False)
            kw["params"] = kw.pop("variables")
            res = tsa.two_stage_admm(y_train, phi_train, cfg, x0_bayer=x0_bayer,
                                     device=device, **kw)
            err = (physics.forward(bayer.pack(res.x_bayer), phi_p) - y_p) ** 2
            out.append(float(torch.sum(err * hold_p) / torch.clamp(hold_p.sum(), min=1)))
    return out


def probe_demosaic_residuals(
    y_bayer: np.ndarray,
    phi_bayer: np.ndarray,
    x0_bayer: np.ndarray | torch.Tensor,
    prior: Prior,
    variables: Mapping[str, torch.Tensor],
    dm_model: torch.nn.Module,
    dm_variables: Mapping[str, torch.Tensor] | None,
    config_malvar: tsa.ADMMConfig,
    config_ddnet: tsa.ADMMConfig,
    holdout_frac: float = 0.05,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> tuple[float, float]:
    """Held-out measurement residuals ``(resid_malvar, resid_ddnet)`` of
    fixed-weight solves with each demosaicker at the full schedule
    (:func:`holdout_cv_residuals`); lower = better."""
    r_m, r_d = holdout_cv_residuals(
        y_bayer, phi_bayer, x0_bayer,
        [
            dict(config=dataclasses.replace(config_malvar, demosaic_method="malvar"),
                 prior=prior, variables=variables),
            dict(config=dataclasses.replace(config_ddnet, demosaic_method="ddnet"),
                 prior=prior, variables=variables,
                 demosaic_fn=ddnet_demosaic(dm_model, dm_variables)),
        ],
        holdout_frac=holdout_frac, seed=seed, device=device,
    )
    return r_m, r_d


def select_demosaicker(
    scene: SceneData,
    prior: Prior,
    variables: Mapping[str, torch.Tensor],
    dm_model: torch.nn.Module,
    dm_variables: Mapping[str, torch.Tensor] | None,
    warm_start: np.ndarray | None = None,
    config_malvar: tsa.ADMMConfig | None = None,
    config_ddnet: tsa.ADMMConfig | None = None,
    holdout_frac: float = 0.05,
    device: torch.device | str = "cuda",
) -> str:
    """Ground-truth-free per-scene demosaicker choice, ``'malvar'`` or
    ``'ddnet'``: both paths' scene schedules run fixed-weight on the first
    measurement with a held-out data term, and the one that predicts the
    held-out measurement better wins (ties go to Malvar).
    ``config_malvar``/``config_ddnet`` default to the scene's table rows (by
    ``scene.name`` and ``prior.name``). CLI: ``reconstruct --auto-demosaic``."""
    if config_malvar is None:
        config_malvar = admm_config_for(scene.name, prior.name, False, False)
    if config_ddnet is None:
        config_ddnet = admm_config_for(scene.name, prior.name, True, False)
    x0 = (warm_start[0] if warm_start is not None
          else _gap_tv_warm(scene.meas[0], scene.mask, device))
    r_m, r_d = probe_demosaic_residuals(
        scene.meas[0], scene.mask, x0, prior, variables, dm_model, dm_variables,
        config_malvar, config_ddnet, holdout_frac=holdout_frac, device=device)
    pick = "malvar" if r_m <= r_d else "ddnet"
    log.info("demosaicker auto-select: held-out resid malvar %.4e ddnet %.4e -> %s",
             r_m, r_d, pick)
    return pick


def select_prior_variables(
    scene: SceneData,
    prior: Prior,
    candidates: dict[str, Any],
    config: tsa.ADMMConfig | None = None,
    warm_start: np.ndarray | None = None,
    holdout_frac: float = 0.05,
    device: torch.device | str = "cuda",
) -> str:
    """Ground-truth-free per-scene choice among prior weight variants
    (``candidates``: label -> state dict): the key of the variant whose
    fixed-weight solve of the first measurement best predicts the held-out
    measurement (:func:`holdout_cv_residuals`; the first of equals wins).
    CLI: ``reconstruct --ckpt auto``."""
    if config is None:
        config = admm_config_for(scene.name, prior.name, False, False)
    x0 = (warm_start[0] if warm_start is not None
          else _gap_tv_warm(scene.meas[0], scene.mask, device))
    labels = list(candidates)
    resids = holdout_cv_residuals(
        scene.meas[0], scene.mask, x0,
        [dict(config=config, prior=prior, variables=candidates[k]) for k in labels],
        holdout_frac=holdout_frac, device=device)
    pick = labels[int(np.argmin(resids))]
    log.info("prior-weight auto-select: held-out resid %s -> %s",
             " ".join(f"{k}={r:.4e}" for k, r in zip(labels, resids)), pick)
    return pick


def run_reconstruction(
    scene: SceneData,
    prior: Prior,
    variables: Mapping[str, torch.Tensor] | None,
    denoiser: str = "ffdnet",
    deep_demosaicking: bool = False,
    update: bool = True,
    reuse_model: bool = True,
    warm_start: np.ndarray | None = None,   # (T, B, H, W)
    demosaic_fn: Callable | None = None,
    config: tsa.ADMMConfig | None = None,
    dm_model: torch.nn.Module | None = None,
    dm_variables: Mapping[str, torch.Tensor] | None = None,
    dm_update: bool = False,
    dm_lr: float = 1e-6,
    dm_update_per_iter: int = 1,
    dm_in_scan: bool = False,
    dm_fresh_opt: bool = False,
    tile: int | None = None,
    tile_overlap: int = 0,
    tile_chunk: int | None = None,
    device: torch.device | str = "cuda",
) -> ReconstructionOutput:
    """Two-stage online-adaptive reconstruction of every measurement of
    ``scene``, with the scene's table row unless ``config`` is given.

    ``reuse_model``: the adapted weights and the carried Adam state
    (``ADMMResult.opt_state``) of measurement t start measurement t + 1;
    otherwise every measurement starts from ``variables``.
    ``warm_start=None`` runs the 40-iteration GAP-TV warm start inline (the
    two-stage solver is not made for cold starts).

    ``tile``: solve each measurement as ``tile x tile`` tiles that share one
    adaptation (:func:`two_stage_admm_tiled`), with ``tile_overlap`` pixels of
    context around each tile and ``tile_chunk`` tiles a group.

    ``dm_update`` adapts the DDnet demosaicker ``dm_model`` (from
    ``dm_variables``) by self-consistency, carried from measurement to
    measurement: inside every solver iteration with ``dm_in_scan``
    (:func:`make_dm_spec`), else once per measurement on its warm start
    before the solve (:func:`make_dm_adapt_fn`). ``dm_fresh_opt`` builds a
    new Adam for every step.

    The adaptation's random draws (input noise, crop offsets) come from one
    CPU ``torch.Generator``, seeded with 0 and carried through all
    measurements in turn, so a run on the card draws what a run on the CPU
    draws; the JAX package instead passes ``PRNGKey(t)`` to measurement ``t``.
    """
    if config is None:
        config = admm_config_for(scene.name, denoiser, deep_demosaicking, update)
    generator = torch.Generator().manual_seed(0)
    initial_variables = variables
    opt_state = None

    dm_adapt = dm_opt = dm_spec = dm_opt_state = None
    if dm_update and dm_model is not None and dm_in_scan:
        dm_spec = tsa.make_dm_spec(dm_model, dm_lr, dm_update_per_iter, fresh_opt=dm_fresh_opt)
    elif dm_update and dm_model is not None:
        from adaptivepnp_sci_torch.adapt.ddnet_online import make_dm_adapt_fn

        dm_adapt = make_dm_adapt_fn(dm_model, dm_lr, dm_update_per_iter, fresh_opt=dm_fresh_opt)
    outs, rgbs, psnrs, ssims, traces, times = [], [], [], [], [], []
    with tsa.full_f32():
        for t in range(scene.n_meas):
            if not reuse_model:
                variables, opt_state = initial_variables, None
            t0 = time.perf_counter()
            orig = scene.orig_bayer[t] if scene.orig_bayer is not None else None
            if warm_start is not None:
                x0 = as_f32(warm_start[t], device)
            else:
                x0 = _gap_tv_warm(scene.meas[t], scene.mask, device)
            if dm_adapt is not None:
                dm_variables, dm_opt, dm_loss = dm_adapt(dm_variables, dm_opt, x0)
                demosaic_fn = ddnet_demosaic(dm_model, dm_variables)
                log.info("dm adaptation loss %.6f", float(dm_loss))
            common = dict(prior=prior, params=variables, orig_bayer=orig,
                          demosaic_fn=demosaic_fn, x0_bayer=x0, opt_state=opt_state,
                          dm_spec=dm_spec, dm_variables=dm_variables if dm_spec else None,
                          dm_opt_state=dm_opt_state, generator=generator, device=device)
            if tile is not None:
                res = tsa.two_stage_admm_tiled(scene.meas[t], scene.mask, config, tile=tile,
                                               overlap=tile_overlap, tile_chunk=tile_chunk,
                                               **common)
            else:
                res = tsa.two_stage_admm(scene.meas[t], scene.mask, config, **common)
            outs.append(_to_numpy(res.x_bayer))
            times.append(time.perf_counter() - t0)
            if reuse_model and update:
                variables, opt_state = res.variables, res.opt_state
            if dm_spec is not None and reuse_model:
                dm_variables, dm_opt_state = res.dm_variables, res.dm_opt_state
            rgbs.append(_to_numpy(res.x_rgb))
            psnrs.append(_to_numpy(res.psnr_per_frame))
            ssims.append(_to_numpy(res.ssim_per_frame))
            traces.append(_to_numpy(res.psnr_trace))
            log.info("%s meas %d/%d: PSNR %.2f dB SSIM %.4f in %.2fs", scene.name, t + 1,
                     scene.n_meas, psnrs[-1].mean(), ssims[-1].mean(), times[-1])
    return ReconstructionOutput(
        np.stack(outs), np.stack(rgbs), np.stack(psnrs), np.stack(ssims), np.stack(traces),
        times, variables,
        dm_variables if (dm_spec is not None or dm_adapt is not None) else None,
    )
