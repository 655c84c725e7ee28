"""Multi-process validation of the port's parallel paths, on one machine
(port of ``scripts/multihost_validation.py``).

The launcher starts ``nproc`` worker processes (``--worker``), which join one
``torch.distributed`` job (a ``file://`` rendezvous in a temporary
directory, so concurrent runs never race for a port) and run the cases of
:data:`CASES` over real cross-process collectives. Each rank writes its
results to ``{out}/rank{r}.npz``; the launcher then runs every case once
more in its own process without a mesh (the one-process oracle) and holds
each rank's results against it at :data:`TOLERANCES`.

The cases: the ring halo windows and their backward; the halo's too-many-
shards refusal; the frame-sharded FastDVDnet prior in both forms (with one
frame per rank), and its gradient; the data-parallel FFDNet step; the
data-parallel FastDVDnet ``Trainer`` (train-mode BatchNorm over the global
batch); a two-stage ADMM solve with the sharded prior, without and with one
adaptation trigger; the tiled driver with its tiles over ranks (FFDNet with
the raw guard, FastDVDnet with the held-out guard and adaptation noise, and
the in-scan DDnet update); the batched driver. Then the frame-sharded solve
(``frame_*``: each measurement's frames over the ranks, every rank given the
whole inputs and returning the whole result): ``two_stage_admm(mesh=)``
with TV and ``gap_tv(mesh=)``, FFDNet adapting under the raw guard,
FastDVDnet plain and adapting with noise, a crop and the held-out guard,
DDnet adapted in the loop, ``reconstruct_single_dispatch(mesh=)``,
``gap_deep(mesh=)``, ``gap_denoise_gray(mesh=)``, the adaptation loss's
gradient (and the same with the frame sum's backward summed over the ranks,
a run that must fail), and the refusals; and the adapting batched driver
over ``data`` (``batched_adapt``). On the card (``--size card``,
the default there) the cases add the bf16 prior (the conv-pair kernel) and
run at 64x64 (the tiled driver at 128x128); ``--device cpu`` runs them at
16x16 (``--size cpu``).

Run from the repository root:

    python -m adaptivepnp_sci_torch.multihost_validation --backend gloo   # 2 ranks, one card
    python -m adaptivepnp_sci_torch.multihost_validation --nproc 1        # NCCL, one card
    python -m adaptivepnp_sci_torch.multihost_validation --device cpu     # 2 CPU ranks, gloo

Two NCCL ranks cannot share one card; several ranks on one card use gloo,
whose collectives take CUDA tensors. Every worker runs one intra-op thread.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
WEIGHTS = ROOT / "weights"


@dataclass(frozen=True)
class Sizes:
    """Scene and batch sizes of one run of the cases."""

    side: int          # frames of the prior and solver cases, and the batched scenes
    tiled: int         # the tiled scene
    patch: int         # the Trainer's clips


SIZES = {"cpu": Sizes(side=16, tiled=32, patch=16), "card": Sizes(side=64, tiled=128, patch=32),
         "full": Sizes(side=512, tiled=2048, patch=96)}


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _fastdvd_params():
    from adaptivepnp_sci_torch.models.convert import fastdvdnet_from_flax, load_variables_npz

    return fastdvdnet_from_flax(load_variables_npz(str(WEIGHTS / "fastdvd.npz")))


def small_ffdnet():
    """FFDNet(nc=8, nb=3) with PyTorch's initialisation under seed 0 (the
    same weights in every process)."""
    from adaptivepnp_sci_torch.models.ffdnet import FFDNet

    torch.manual_seed(0)
    return FFDNet(nc=8, nb=3)


def flax_style_ffdnet_params(nc: int, nb: int, seed: int) -> dict:
    """FFDNet-color weights in Flax's default scheme, as numpy: LeCun fan-in
    truncated-normal kernels (kh, kw, I, O) and zero biases, in Flax's
    ``params/conv_{i}/{kernel,bias}`` layout."""
    rng = np.random.default_rng(seed)
    chans = [13] + [nc] * (nb - 1) + [12]
    params = {}
    for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        shape = (3, 3, cin, cout)
        z = rng.standard_normal(shape)
        while np.any(bad := np.abs(z) > 2.0):
            z[bad] = rng.standard_normal(int(bad.sum()))
        std = np.sqrt(1.0 / (9 * cin)) / 0.87962566103423978  # truncation correction
        params[f"conv_{i}"] = {"kernel": (z * std).astype(np.float32),
                               "bias": np.zeros(cout, np.float32)}
    return {"params": params}


def _flat(tensors) -> np.ndarray:
    return torch.cat([t.detach().reshape(-1).float().cpu() for t in tensors]).numpy()


def _state_flat(state: dict) -> np.ndarray:
    return _flat([state[k] for k in sorted(state) if state[k].is_floating_point()])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------- the cases
#
# Each case takes the meshes (None: one process, no mesh: the oracle), the
# device and the sizes, and returns named arrays.


def case_halo(meshes, dev, sz):
    from adaptivepnp_sci_torch.parallel import halo_windows, make_mesh
    from adaptivepnp_sci_torch.parallel.mesh import gather, shard

    mesh = meshes["frame"] if meshes else make_mesh(1, 1)
    rgb = torch.from_numpy(_rng(0).random((8, 4, 4, 3), dtype=np.float32)).to(dev)
    wts = torch.from_numpy(_rng(1).random((8, 5, 4, 4, 3), dtype=np.float32)).to(dev)
    local = shard(rgb, mesh, "frame").clone().requires_grad_(True)
    win5 = gather(halo_windows(local, mesh, "frame", 5), mesh, "frame")
    win3 = gather(halo_windows(local, mesh, "frame", 3), mesh, "frame")
    (win5 * wts).sum().backward()
    return {"win5": _np(win5), "win3": _np(win3),
            "grad": _np(gather(local.grad, mesh, "frame"))}


def case_too_many_shards(meshes, dev, sz):
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.parallel.sharded import fastdvd_prior_sharded
    from adaptivepnp_sci_torch.solvers.priors import working_copy

    if not meshes or meshes["frame"].axis_size("frame") < 2:
        return {}
    prior = fastdvd_prior_sharded(FastDVDnet(), meshes["frame"], shared_triplet=False)
    net = working_copy(prior, None, dev)
    n = meshes["frame"].axis_size("frame")
    try:
        prior.apply(net, torch.zeros(n, 8, 8, 3, device=dev), torch.tensor(0.1, device=dev))
    except ValueError as err:
        return {"raised": np.array(1), "too_many_shards": np.array("too many shards" in str(err))}
    return {"raised": np.array(0)}


def _prior_outputs(meshes, dev, sz, dtype, tag):
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.parallel.sharded import fastdvd_prior_sharded
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior, working_copy

    params = _fastdvd_params()
    model = FastDVDnet(dtype=dtype)
    out = {}
    sigma = torch.tensor(0.1, device=dev)
    for b in (8, 2):
        rgb = torch.from_numpy(_rng(2 + b).random((b, sz.side, sz.side, 3),
                                                  dtype=np.float32)).to(dev)
        for form, shared in (("shared", True), ("window", False)):
            n = meshes["frame"].axis_size("frame") if meshes else 1
            if not shared and b // n < 2:
                continue  # the per-window form needs two frames a rank
            prior = (fastdvd_prior_sharded(model, meshes["frame"], shared_triplet=shared)
                     if meshes else fastdvd_prior(model))
            net = working_copy(prior, params, dev)
            with torch.no_grad():
                out[f"{tag}_{form}_b{b}"] = _np(prior.apply(net, rgb, sigma))
    return out


def case_prior(meshes, dev, sz):
    return _prior_outputs(meshes, dev, sz, None, "fp32")


def case_prior_bf16(meshes, dev, sz):
    return _prior_outputs(meshes, dev, sz, torch.bfloat16, "bf16")


def case_prior_grad(meshes, dev, sz):
    """The gradient of an adaptation-style loss through the prior, after
    ``Prior.reduce_grads``."""
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.parallel.sharded import fastdvd_prior_sharded
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior, working_copy

    model = FastDVDnet()
    prior = fastdvd_prior_sharded(model, meshes["frame"]) if meshes else fastdvd_prior(model)
    net = working_copy(prior, _fastdvd_params(), dev)
    rgb = torch.from_numpy(_rng(20).random((8, sz.side, sz.side, 3), dtype=np.float32)).to(dev)
    target = torch.from_numpy(_rng(21).random((8, sz.side, sz.side, 3),
                                              dtype=np.float32)).to(dev)
    with torch.enable_grad():
        loss = torch.mean((prior.apply(net, rgb, torch.tensor(0.05, device=dev)) - target) ** 2)
        loss.backward()
    grads = [p.grad for p in net.parameters()]
    if prior.reduce_grads is not None:
        prior.reduce_grads(grads)
    return {"loss": _np(loss), "grads": _flat(grads)}


def case_dp_step(meshes, dev, sz):
    from adaptivepnp_sci_torch.parallel.mesh import make_mesh
    from adaptivepnp_sci_torch.parallel.sharded import make_dp_train_step

    net = small_ffdnet().to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    rng = _rng(1)
    noisy = rng.random((16, 8, 8, 3), dtype=np.float32)
    clean = rng.random((16, 8, 8, 3), dtype=np.float32)
    sigma = np.full((16,), 0.1, np.float32)
    step, place = make_dp_train_step(net, opt, meshes["data"] if meshes else make_mesh(1, 1))
    loss = step(*place(noisy, clean, sigma))
    return {"loss": _np(loss), "params": _flat(net.parameters())}


def case_trainer(meshes, dev, sz):
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.train import Trainer, TrainerConfig
    from adaptivepnp_sci_torch.train.tasks import fastdvd_task

    cfg = TrainerConfig(lr=1e-6, steps_per_epoch=1, milestones=(0, 1), seed=0,
                        mesh=meshes["frame"] if meshes else None)
    trainer = Trainer(fastdvd_task(FastDVDnet()), _fastdvd_params(), cfg, device=dev)
    trainer.generator = torch.Generator().manual_seed(0)  # the same draws on any device
    rng = _rng(5)
    losses = [trainer.train_step(rng.random((4, 5, sz.patch, sz.patch, 3), dtype=np.float32))
              for _ in range(2)]
    state = trainer.variables
    stats = [state[k] for k in sorted(state) if k.endswith(("running_mean", "running_var"))]
    params = [state[k] for k in sorted(state)
              if k.endswith(("weight", "bias")) and "running" not in k]
    return {"losses": _np(torch.stack(losses)), "params": _flat(params), "stats": _flat(stats)}


def _solver_case(meshes, dev, sz, adapt: bool):
    from adaptivepnp_sci_torch import ADMMConfig, AdaptConfig, FastDVDnet, two_stage_admm
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.parallel.sharded import fastdvd_prior_sharded
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior

    model = FastDVDnet()
    prior = fastdvd_prior_sharded(model, meshes["frame"]) if meshes else fastdvd_prior(model)
    scene = make_scene(b=8, h=sz.side, w=sz.side, seed=3)
    # one trigger at k = 2: one Adam step at lr 2e-6
    cfg = ADMMConfig(sigma=(12 / 255,), iters=(3,), denoiser="fastdvd",
                     adapt=AdaptConfig(lr=2e-6, update_per_iter=1, initial_iter=0,
                                       interval_iter=2) if adapt else None)
    params = _fastdvd_params()
    res = two_stage_admm(scene.meas, scene.mask, cfg, prior, params,
                         orig_bayer=scene.orig_bayer, device=dev,
                         generator=torch.Generator().manual_seed(0))
    out = {"x_bayer": _np(res.x_bayer), "psnr": _np(res.psnr_per_frame)}
    if adapt:
        out["variables"] = _state_flat(res.variables)
    return out


def case_solver(meshes, dev, sz):
    return _solver_case(meshes, dev, sz, adapt=False)


def case_solver_adapt(meshes, dev, sz):
    return _solver_case(meshes, dev, sz, adapt=True)


#: the scene seed of each tiled case
TILED_SEEDS = {"tiled": 7, "tiled_guard": 42, "tiled_dm": 9}


def _tiled_out(res) -> dict:
    out = {"x_bayer": _np(res.x_bayer), "x_rgb": _np(res.x_rgb), "psnr": _np(res.psnr_per_frame),
           "variables": _state_flat(res.variables)}
    if res.resid_trace is not None:
        out["resid_trace"] = _np(res.resid_trace)
    if res.dm_variables is not None:
        out["dm_variables"] = _state_flat(res.dm_variables)
    return out


def case_tiled(meshes, dev, sz):
    """FFDNet tiles over ranks: adaptation at k = 2 and 4, the raw guard."""
    from adaptivepnp_sci_torch import ADMMConfig, AdaptConfig, ffdnet_prior, two_stage_admm_tiled
    from adaptivepnp_sci_torch.data.synthetic import make_scene

    scene = make_scene(b=8, h=sz.tiled, w=sz.tiled, seed=TILED_SEEDS["tiled"])
    cfg = ADMMConfig(sigma=(25 / 255, 12 / 255), iters=(3, 2),
                     adapt=AdaptConfig(lr=2e-6, update_per_iter=1, initial_iter=0,
                                       interval_iter=2), select_best=True)
    net = small_ffdnet()
    res = two_stage_admm_tiled(scene.meas, scene.mask, cfg, tile=sz.tiled // 2,
                               prior=ffdnet_prior(net), params=net.state_dict(),
                               orig_bayer=scene.orig_bayer, device=dev,
                               mesh=meshes["data"] if meshes else None)
    return _tiled_out(res)


def case_tiled_guard(meshes, dev, sz):
    """FastDVDnet tiles over ranks in groups of 2, with overlap, adaptation
    noise and the held-out guard (``drivers_parity``'s configuration)."""
    from adaptivepnp_sci_torch import (ADMMConfig, AdaptConfig, FastDVDnet, GapTVConfig,
                                       fastdvd_prior, gap_tv, two_stage_admm_tiled)
    from adaptivepnp_sci_torch.data.synthetic import make_scene

    scene = make_scene(b=8, h=sz.tiled, w=sz.tiled, seed=TILED_SEEDS["tiled_guard"])
    cfg = ADMMConfig(sigma=(12 / 255, 6 / 255), iters=(6, 4), denoiser="fastdvd",
                     adapt=AdaptConfig(lr=2e-7, update_per_iter=2, interval_iter=5),
                     select_best=True, select_best_holdout=0.05)
    warm = gap_tv(scene.meas, scene.mask, GapTVConfig(iters=40), device=dev)
    res = two_stage_admm_tiled(
        scene.meas, scene.mask, cfg, tile=sz.tiled // 2, prior=fastdvd_prior(FastDVDnet()),
        params=_fastdvd_params(), orig_bayer=scene.orig_bayer, x0_bayer=warm.x_bayer,
        overlap=sz.tiled // 8, tile_chunk=2, generator=torch.Generator().manual_seed(0),
        device=dev,
        mesh=meshes["data"] if meshes else None)
    return _tiled_out(res)


def case_tiled_dm(meshes, dev, sz):
    """Tiles over ranks with DDnet adapted in the loop (``dm_update``)."""
    from adaptivepnp_sci_torch import ADMMConfig, DDnet, ffdnet_prior, make_dm_spec
    from adaptivepnp_sci_torch import two_stage_admm_tiled
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.convert import ddnet_from_flax, load_variables_npz

    scene = make_scene(b=8, h=sz.tiled, w=sz.tiled, seed=TILED_SEEDS["tiled_dm"])
    cfg = ADMMConfig(sigma=(25 / 255,), iters=(2,), demosaic_method="ddnet")
    net = small_ffdnet()
    dd = ddnet_from_flax(load_variables_npz(str(WEIGHTS / "ddnet.npz")))
    res = two_stage_admm_tiled(
        scene.meas, scene.mask, cfg, tile=sz.tiled // 2, prior=ffdnet_prior(net),
        params=net.state_dict(), orig_bayer=scene.orig_bayer,
        dm_spec=make_dm_spec(DDnet(), lr=1e-6), dm_variables=dd, device=dev,
        mesh=meshes["data"] if meshes else None)
    return _tiled_out(res)


def case_batched(meshes, dev, sz):
    from adaptivepnp_sci_torch import ADMMConfig, ffdnet_prior, two_stage_admm_batched
    from adaptivepnp_sci_torch.data.synthetic import make_scene

    scene = make_scene(b=4, h=sz.side, w=sz.side, seed=14, n_meas=4)
    net = small_ffdnet()
    res = two_stage_admm_batched(np.moveaxis(scene.meas, -1, 0), scene.mask,
                                 ADMMConfig(sigma=(25 / 255,), iters=(2,)),
                                 ffdnet_prior(net), net.state_dict(), device=dev,
                                 mesh=meshes["data"] if meshes else None)
    return {"x_bayer": _np(res.x_bayer), "psnr": _np(res.psnr_per_frame)}


# ------------------------------------------------------ the frame-sharded solve
#
# Each case runs with the frame axis over the ranks (``meshes["frame"]``),
# at world size 1 on a one-rank mesh (the one-process path), and without a
# mesh as the oracle.

#: the scene seed of the frame-sharded cases (the JAX package's
#: ``test_solver_with_frame_sharded_inputs`` scene for ``frame_fastdvd``)
FRAME_SEED = 13
#: one trigger at k = 2: one Adam step at lr 2e-6
FRAME_ADAPT = dict(lr=2e-6, update_per_iter=1, initial_iter=0, interval_iter=2)


def _frame_mesh(meshes):
    return meshes["frame"] if meshes else None


def _admm_out(res) -> dict:
    out = {"x_bayer": _np(res.x_bayer), "x_rgb": _np(res.x_rgb), "psnr": _np(res.psnr_per_frame),
           "trace": _np(res.psnr_trace)}
    if getattr(res, "resid_trace", None) is not None:
        out["resid_trace"] = _np(res.resid_trace)
    if isinstance(res.variables, dict):
        out["variables"] = _state_flat(res.variables)
    if getattr(res, "dm_variables", None) is not None:
        out["dm_variables"] = _state_flat(res.dm_variables)
    return out


def case_frame_tv(meshes, dev, sz):
    """ADMM-TV under the raw guard, and the GAP-TV warm start, over frames."""
    from adaptivepnp_sci_torch import ADMMConfig, GapTVConfig, gap_tv, two_stage_admm
    from adaptivepnp_sci_torch.data.synthetic import make_scene

    sc = make_scene(b=8, h=sz.side, w=sz.side, seed=FRAME_SEED)
    mesh = _frame_mesh(meshes)
    res = two_stage_admm(sc.meas, sc.mask, ADMMConfig(sigma=(0.0,), iters=(3,), denoiser="tv",
                                                      select_best=True),
                         orig_bayer=sc.orig_bayer, device=dev, mesh=mesh)
    warm = gap_tv(sc.meas, sc.mask, GapTVConfig(iters=5), orig_bayer=sc.orig_bayer, device=dev,
                  mesh=mesh)
    return {**_admm_out(res), "warm_x": _np(warm.x_bayer), "warm_psnr": _np(warm.psnr_per_frame),
            "warm_trace": _np(warm.psnr_trace)}


def case_frame_ffdnet(meshes, dev, sz):
    """FFDNet adapting at k = 2 and 4 (the packed loss), the raw guard."""
    from adaptivepnp_sci_torch import ADMMConfig, AdaptConfig, ffdnet_prior, two_stage_admm
    from adaptivepnp_sci_torch.data.synthetic import make_scene

    sc = make_scene(b=8, h=sz.side, w=sz.side, seed=FRAME_SEED)
    net = small_ffdnet()
    cfg = ADMMConfig(sigma=(25 / 255, 12 / 255), iters=(3, 2), adapt=AdaptConfig(**FRAME_ADAPT),
                     select_best=True)
    res = two_stage_admm(sc.meas, sc.mask, cfg, ffdnet_prior(net), net.state_dict(),
                         orig_bayer=sc.orig_bayer, device=dev, mesh=_frame_mesh(meshes))
    return _admm_out(res)


def case_frame_fastdvd(meshes, dev, sz):
    """FastDVDnet on ``weights/``, no adaptation (the JAX package's
    frame-sharded solver test)."""
    from adaptivepnp_sci_torch import ADMMConfig, FastDVDnet, fastdvd_prior, two_stage_admm
    from adaptivepnp_sci_torch.data.synthetic import make_scene

    sc = make_scene(b=8, h=sz.side, w=sz.side, seed=FRAME_SEED)
    res = two_stage_admm(sc.meas, sc.mask, ADMMConfig(sigma=(12 / 255,), iters=(3,),
                                                      denoiser="fastdvd"),
                         fastdvd_prior(FastDVDnet()), _fastdvd_params(),
                         orig_bayer=sc.orig_bayer, device=dev, mesh=_frame_mesh(meshes))
    return _admm_out(res)


def case_frame_fastdvd_adapt(meshes, dev, sz):
    """FastDVDnet adapting at k = 2 and 4 with its input noise, the spatial
    input mask and a crop of half the side, under the held-out guard (its
    masked warm start 10 iterations); a CPU generator seeded with 0."""
    from adaptivepnp_sci_torch import ADMMConfig, AdaptConfig, FastDVDnet, GapTVConfig, gap_tv
    from adaptivepnp_sci_torch import fastdvd_prior, two_stage_admm
    from adaptivepnp_sci_torch.data.synthetic import make_scene

    sc = make_scene(b=8, h=sz.side, w=sz.side, seed=FRAME_SEED)
    cfg = ADMMConfig(sigma=(12 / 255, 6 / 255), iters=(4, 2), denoiser="fastdvd",
                     adapt=AdaptConfig(lr=2e-7, update_per_iter=2, initial_iter=0,
                                       interval_iter=2, crop=sz.side // 2),
                     select_best=True, select_best_holdout=0.05, select_best_warm_iters=10)
    mesh = _frame_mesh(meshes)
    warm = gap_tv(sc.meas, sc.mask, GapTVConfig(iters=10), device=dev, mesh=mesh)
    res = two_stage_admm(sc.meas, sc.mask, cfg, fastdvd_prior(FastDVDnet(), adapt_mask=("s", 0.1)),
                         _fastdvd_params(), x0_bayer=warm.x_bayer, orig_bayer=sc.orig_bayer,
                         device=dev, mesh=mesh, generator=torch.Generator().manual_seed(0))
    return _admm_out(res)


def case_frame_ddnet(meshes, dev, sz):
    """FFDNet with DDnet adapted in the loop (``dm_update``, the halo
    windows)."""
    from adaptivepnp_sci_torch import ADMMConfig, DDnet, ffdnet_prior, make_dm_spec
    from adaptivepnp_sci_torch import two_stage_admm
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.convert import ddnet_from_flax, load_variables_npz

    sc = make_scene(b=8, h=sz.side, w=sz.side, seed=FRAME_SEED)
    net = small_ffdnet()
    dd = ddnet_from_flax(load_variables_npz(str(WEIGHTS / "ddnet.npz")))
    cfg = ADMMConfig(sigma=(25 / 255,), iters=(2,), demosaic_method="ddnet")
    mesh = _frame_mesh(meshes)
    res = two_stage_admm(sc.meas, sc.mask, cfg, ffdnet_prior(net), net.state_dict(),
                         orig_bayer=sc.orig_bayer, dm_spec=make_dm_spec(DDnet(), lr=1e-6),
                         dm_variables=dd, device=dev, mesh=mesh)
    return _admm_out(res)


def case_frame_dispatch(meshes, dev, sz):
    """``reconstruct_single_dispatch``: a 10-iteration warm start, then FFDNet
    adapting at k = 2 and 4."""
    from adaptivepnp_sci_torch import (ADMMConfig, AdaptConfig, GapTVConfig, ffdnet_prior,
                                       reconstruct_single_dispatch)
    from adaptivepnp_sci_torch.data.synthetic import make_scene

    sc = make_scene(b=8, h=sz.side, w=sz.side, seed=FRAME_SEED)
    net = small_ffdnet()
    res = reconstruct_single_dispatch(
        sc.meas, sc.mask, GapTVConfig(iters=10),
        ADMMConfig(sigma=(25 / 255, 12 / 255), iters=(3, 2), adapt=AdaptConfig(**FRAME_ADAPT)),
        ffdnet_prior(net), net.state_dict(), orig=sc.orig_bayer, device=dev,
        mesh=_frame_mesh(meshes))
    return _admm_out(res)


def case_frame_gap_deep(meshes, dev, sz):
    """``gap_deep`` with FastDVDnet adapting at k = 2 (its input noise)."""
    from adaptivepnp_sci_torch import (AdaptConfig, FastDVDnet, GapDeepConfig, fastdvd_prior,
                                       gap_deep)
    from adaptivepnp_sci_torch.data.synthetic import make_scene

    sc = make_scene(b=8, h=sz.side, w=sz.side, seed=FRAME_SEED)
    res = gap_deep(sc.meas, sc.mask, GapDeepConfig(sigma=(12 / 255,), iters=(3,),
                                                   denoiser="fastdvd",
                                                   adapt=AdaptConfig(**FRAME_ADAPT)),
                   fastdvd_prior(FastDVDnet()), _fastdvd_params(), orig_bayer=sc.orig_bayer,
                   device=dev, mesh=_frame_mesh(meshes))
    return _admm_out(res)


def case_frame_gray(meshes, dev, sz):
    """The gray solver with TV, plain and accelerated."""
    from adaptivepnp_sci_torch import GrayConfig, gap_denoise_gray
    from adaptivepnp_sci_torch.data.synthetic import make_scene

    sc = make_scene(b=8, h=sz.side, w=sz.side, seed=FRAME_SEED)
    out = {}
    for tag, acc in (("plain", False), ("accelerated", True)):
        res = gap_denoise_gray(sc.meas, sc.mask, GrayConfig(iters=(5,), accelerate=acc),
                               orig=sc.orig_bayer, device=dev, mesh=_frame_mesh(meshes))
        out.update({f"{tag}_x": _np(res.x), f"{tag}_psnr": _np(res.psnr_per_frame),
                    f"{tag}_trace": _np(res.psnr_trace)})
    return out


def _loss_grads(meshes, dev, sz, frames_cls):
    """The adaptation loss and its gradient (after ``Prior.reduce_grads``)
    in both loss modes, and one adaptation trigger's weights, with the frames
    over the ranks as ``frames_cls`` shards them (None: one process)."""
    from adaptivepnp_sci_torch import AdaptConfig, FastDVDnet, fastdvd_prior, ffdnet_prior
    from adaptivepnp_sci_torch.adapt.online import make_adapt_fn, measurement_loss_fn
    from adaptivepnp_sci_torch.ops import bayer
    from adaptivepnp_sci_torch.solvers.priors import working_copy

    rng = _rng(40)
    b, side = 8, sz.side
    rgb = torch.from_numpy(rng.random((b, side, side, 3), dtype=np.float32)).to(dev)
    phi = torch.from_numpy((rng.random((b, side, side)) > 0.5).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.random((side, side), dtype=np.float32)).to(dev)
    frames = None
    if meshes is not None and meshes["frame"].axis_size("frame") > 1:
        frames = frames_cls.of(meshes["frame"], b)
    out = {}
    net_ff = small_ffdnet()
    for mode, prior, params in (("packed4", ffdnet_prior(net_ff), net_ff.state_dict()),
                                ("bayer1", fastdvd_prior(FastDVDnet()), _fastdvd_params())):
        if frames is not None:
            prior = prior.frame_sharded(frames.mesh)
        local = (lambda t: t) if frames is None else frames.local
        x, ph = local(rgb), local(phi)
        sigma = torch.tensor(12 / 255, device=dev)
        net = working_copy(prior, params, dev)
        with torch.enable_grad():
            loss = measurement_loss_fn(prior, net, x, sigma, bayer.pack(y), bayer.pack(ph), y,
                                       ph, frames)()
            loss.backward()
        grads = [p.grad for p in net.parameters()]
        if prior.reduce_grads is not None:
            prior.reduce_grads(grads)
        out[f"{mode}_loss"] = _np(loss)
        out[f"{mode}_grads"] = _flat(grads)
        net = working_copy(prior, params, dev)
        adapt = make_adapt_fn(prior, AdaptConfig(lr=2e-6, update_per_iter=2))
        with torch.no_grad():
            adapt(net, x, sigma, bayer.pack(y), bayer.pack(ph), y, ph,
                  torch.Generator().manual_seed(0), frames=frames)
        out[f"{mode}_variables"] = _state_flat(net.state_dict())
    return out


def case_frame_loss_grad(meshes, dev, sz):
    from adaptivepnp_sci_torch.adapt.online import FrameShard

    return _loss_grads(meshes, dev, sz, FrameShard)


def case_frame_loss_grad_all_reduce_sum(meshes, dev, sz):
    """``frame_loss_grad`` with the loss's frame sum taken by ``all_reduce_sum``,
    whose backward sums every rank's upstream gradient: the gradient comes
    out ``frame`` times too large. A run that must fail its comparison."""
    from adaptivepnp_sci_torch.adapt.online import FrameShard
    from adaptivepnp_sci_torch.parallel.mesh import all_reduce_sum

    class SummedBackward(FrameShard):
        def sum(self, t, dim=0):
            return all_reduce_sum(torch.sum(t, dim=dim), self.mesh, "frame")

    return _loss_grads(meshes, dev, sz, SummedBackward)


def case_frame_refusals(meshes, dev, sz):
    """What a frame-sharded solve refuses (more than one frame rank only):
    the tiled driver, a ``demosaic_fn`` and a prior without a frame-sharded
    form, each with ``NotImplementedError`` naming the frame axis; and DDnet
    on one frame a rank, with the halo's "too many shards" ``ValueError``."""
    from adaptivepnp_sci_torch import ADMMConfig, DDnet, ffdnet_prior, make_dm_spec
    from adaptivepnp_sci_torch import two_stage_admm, two_stage_admm_tiled
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.solvers.priors import Prior

    mesh = _frame_mesh(meshes)
    if mesh is None or mesh.axis_size("frame") < 2:
        return {}
    sc = make_scene(b=8, h=sz.side, w=sz.side, seed=FRAME_SEED)
    net = small_ffdnet()
    cfg = ADMMConfig(sigma=(25 / 255,), iters=(1,))
    calls = {
        "tiled": lambda: two_stage_admm_tiled(sc.meas, sc.mask, cfg, tile=sz.side // 2,
                                              prior=ffdnet_prior(net), params=net.state_dict(),
                                              device=dev, mesh=mesh),
        "demosaic_fn": lambda: two_stage_admm(sc.meas, sc.mask, cfg, ffdnet_prior(net),
                                              net.state_dict(), device=dev, mesh=mesh,
                                              demosaic_fn=lambda f: f[..., None].expand(
                                                  *f.shape, 3)),
        "prior": lambda: two_stage_admm(sc.meas, sc.mask, cfg,
                                        Prior("ffdnet", net, lambda m, r, s: m(r, s)),
                                        net.state_dict(), device=dev, mesh=mesh),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = np.array(False)
        except NotImplementedError as err:
            out[name] = np.array("'frame'" in str(err))
    n = mesh.axis_size("frame")
    try:
        two_stage_admm(sc.meas, sc.mask[:n], ADMMConfig(sigma=(25 / 255,), iters=(1,),
                                                        demosaic_method="ddnet"),
                       ffdnet_prior(net), net.state_dict(), dm_spec=make_dm_spec(DDnet()),
                       device=dev, mesh=mesh)
        out["too_many_shards"] = np.array(False)
    except ValueError as err:
        out["too_many_shards"] = np.array("too many shards" in str(err))
    return out


def case_batched_adapt(meshes, dev, sz):
    """The batched driver over ``data``, 4 measurements adapting one after
    another: FastDVDnet with its input noise (a CPU generator seeded with 0;
    a rank makes the draws of the measurements before its share), FFDNet
    (no draws), and FFDNet with DDnet adapted in the loop."""
    from adaptivepnp_sci_torch import (ADMMConfig, AdaptConfig, DDnet, FastDVDnet, fastdvd_prior,
                                       ffdnet_prior, make_dm_spec, two_stage_admm_batched)
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.convert import ddnet_from_flax, load_variables_npz

    sc = make_scene(b=4, h=sz.side, w=sz.side, seed=14, n_meas=4)
    y = np.moveaxis(sc.meas, -1, 0)
    orig = sc.orig_bayer  # (T, B, H, W)
    mesh = meshes["data"] if meshes else None
    net = small_ffdnet()
    adapt = AdaptConfig(**FRAME_ADAPT)
    runs = {
        "fastdvd": two_stage_admm_batched(
            y, sc.mask, ADMMConfig(sigma=(12 / 255,), iters=(3,), denoiser="fastdvd",
                                   adapt=adapt),
            fastdvd_prior(FastDVDnet()), _fastdvd_params(), orig_batch=orig, device=dev,
            mesh=mesh),
        "ffdnet": two_stage_admm_batched(
            y, sc.mask, ADMMConfig(sigma=(25 / 255,), iters=(3,), adapt=adapt),
            ffdnet_prior(net), net.state_dict(), orig_batch=orig, device=dev, mesh=mesh),
        "dm": two_stage_admm_batched(
            y, sc.mask, ADMMConfig(sigma=(25 / 255,), iters=(2,), demosaic_method="ddnet"),
            ffdnet_prior(net), net.state_dict(), orig_batch=orig,
            dm_spec=make_dm_spec(DDnet(), lr=1e-6),
            dm_variables=ddnet_from_flax(load_variables_npz(str(WEIGHTS / "ddnet.npz"))),
            device=dev, mesh=mesh),
    }
    out = {}
    for tag, res in runs.items():
        out[f"{tag}_x_bayer"] = _np(res.x_bayer)
        out[f"{tag}_psnr"] = _np(res.psnr_per_frame)
        for field in ("variables", "dm_variables"):
            if getattr(res, field) is not None:
                out[f"{tag}_{field}"] = _state_flat(getattr(res, field))
    return out


# ------------------------------------------------- full width (the card only)
#
# The bf16 FastDVDnet path of the repository's configurations: the prior on
# 8 frames of 512^2; the 2048^2 scene in tiles of 512 in groups of 4 under the
# Bosphorus row's schedule with the adaptation shared over the tiles; a
# FastDVDnet training step at the published width, batch 16 x 96^2.

#: the Bosphorus row's schedule: sigma (12, 6)/255 x (24, 12), adaptation at
#: k = 12 and 24, 2 Adam steps at lr 2e-7
FULL_SCHEDULE = dict(sigma=(12 / 255, 6 / 255), iters=(24, 12))
FULL_ADAPT = dict(lr=2e-7, update_per_iter=2, interval_iter=12, initial_iter=1)
#: 16 tiles (a quarter of the scene's side: 512 at 2048^2) in groups of 4
FULL_TILE_CHUNK = 4
FULL_TRAIN_BATCH, FULL_TRAIN_STEPS, FULL_TRAIN_WARMUP = 16, 5, 5


def _sync(meshes, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if meshes:
        import torch.distributed as dist

        dist.barrier()


def case_prior_full(meshes, dev, sz):
    """The bf16 prior on 8 frames of ``side^2``: one warm-up call, the median
    of 5 timed calls, then one call under ``torch.profiler`` (host activity:
    its collectives)."""
    from torch.profiler import ProfilerActivity, profile

    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.parallel.sharded import fastdvd_prior_sharded
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior, working_copy

    model = FastDVDnet(dtype=torch.bfloat16, remat=False)
    prior = fastdvd_prior_sharded(model, meshes["frame"]) if meshes else fastdvd_prior(model)
    net = working_copy(prior, _fastdvd_params(), dev)
    rgb = torch.from_numpy(_rng(30).random((8, sz.side, sz.side, 3), dtype=np.float32)).to(dev)
    sigma = torch.tensor(12 / 255, device=dev)
    times = []
    with torch.no_grad():
        out = prior.apply(net, rgb, sigma)
        for _ in range(5):
            _sync(meshes, dev)
            t0 = time.perf_counter()
            out = prior.apply(net, rgb, sigma)
            _sync(meshes, dev)
            times.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            prior.apply(net, rgb, sigma)
            _sync(meshes, dev)
    return {"out": _np(out), "seconds_per_call": np.array(float(np.median(times))),
            **collective_profile(prof, "call_")}


def case_tiled_full(meshes, dev, sz):
    """The ``side``-sized scene's snapshot (GAP-TV warm start, then the tiled
    bf16 FastDVDnet solve), timed once, after a warm-up on a scene of half
    the side (one group of 4 tiles of the same size: the same kernels,
    shapes and per-group collectives) under ``torch.profiler`` (host
    activity: the collectives of one group). The worker counts the timed
    run's launches."""
    from torch.profiler import ProfilerActivity, profile

    from adaptivepnp_sci_torch import (ADMMConfig, AdaptConfig, FastDVDnet, GapTVConfig,
                                       fastdvd_prior, gap_tv, two_stage_admm_tiled)
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.ops import cuda_kernels

    prior = fastdvd_prior(FastDVDnet(dtype=torch.bfloat16, remat=False))
    cfg = ADMMConfig(**FULL_SCHEDULE, denoiser="fastdvd", adapt=AdaptConfig(**FULL_ADAPT))
    params = _fastdvd_params()

    def snapshot(scene):
        warm = gap_tv(scene.meas, scene.mask, GapTVConfig(iters=40),
                      orig_bayer=scene.orig_bayer, device=dev)
        res = two_stage_admm_tiled(
            scene.meas, scene.mask, cfg, tile=sz.tiled // 4, prior=prior, params=params,
            orig_bayer=scene.orig_bayer, x0_bayer=warm.x_bayer, tile_chunk=FULL_TILE_CHUNK,
            generator=torch.Generator(device=dev).manual_seed(0), device=dev,
            mesh=meshes["data"] if meshes else None)
        return warm, res

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        snapshot(make_scene(b=8, h=sz.tiled // 2, w=sz.tiled // 2, seed=42))
    scene = make_scene(b=8, h=sz.tiled, w=sz.tiled, seed=42)
    _sync(meshes, dev)
    cuda_kernels.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    warm, res = snapshot(scene)
    _sync(meshes, dev)
    seconds = time.perf_counter() - t0
    return {"psnr": _np(res.psnr_per_frame), "warm_psnr": _np(warm.psnr_per_frame),
            "variables": _state_flat(res.variables), "seconds_per_snapshot": np.array(seconds),
            **collective_profile(prof, "warmup_")}


def case_train_full(meshes, dev, sz):
    """FastDVDnet ``Trainer`` steps at batch 16 x ``patch^2``: 5 warm-up
    steps, the mean of 5 timed ones, then one step under ``torch.profiler``
    (host activity: its collectives)."""
    from torch.profiler import ProfilerActivity, profile

    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.train import Trainer, TrainerConfig
    from adaptivepnp_sci_torch.train.tasks import fastdvd_task

    cfg = TrainerConfig(lr=1e-4, seed=0, mesh=meshes["frame"] if meshes else None)
    trainer = Trainer(fastdvd_task(FastDVDnet()), _fastdvd_params(), cfg, device=dev)
    rng = _rng(31)
    losses, times = [], []
    for i in range(FULL_TRAIN_WARMUP + FULL_TRAIN_STEPS):
        clips = rng.random((FULL_TRAIN_BATCH, 5, sz.patch, sz.patch, 3), dtype=np.float32)
        _sync(meshes, dev)
        t0 = time.perf_counter()
        losses.append(trainer.train_step(clips))
        _sync(meshes, dev)
        if i >= FULL_TRAIN_WARMUP:
            times.append(time.perf_counter() - t0)
    params = _state_flat(trainer.variables)
    clips = rng.random((FULL_TRAIN_BATCH, 5, sz.patch, sz.patch, 3), dtype=np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(clips)
        _sync(meshes, dev)
    return {"losses": _np(torch.stack(losses)), "seconds_per_step": np.array(np.mean(times)),
            "params": params, **collective_profile(prof, "step_")}


#: the FFDNet flagship: FFDNet-color nc 96, nb 12 on the seeded Flax-style
#: weights, a 40-iteration GAP-TV warm start, sigma (25, 12, 6)/255 x (15, 6,
#: 4), one trigger at k = 15 (2 Adam steps at lr 2e-6)
FLAGSHIP_SCHEDULE = dict(sigma=(25 / 255, 12 / 255, 6 / 255), iters=(15, 6, 4))
FLAGSHIP_ADAPT = dict(lr=2e-6, update_per_iter=2, interval_iter=15, initial_iter=1)
#: the frame-sharded snapshots' timed runs, after one profiled warm-up
FRAME_FULL_RUNS = {"frame_flagship_full": 1, "frame_fastdvd_full": 1,
                   "frame_fastdvd_fixed_full": 1, "frame_fastdvd_fp32_full": 1}


def _snapshot_full(meshes, dev, sz, prior, params, cfg, runs):
    """``reconstruct_single_dispatch`` of the ``side``-sized smooth scene
    (seed 42) over the frame axis: one warm-up under ``torch.profiler``
    (host activity: its collectives), then ``runs`` timed runs, the launches
    counted from the last alone."""
    from torch.profiler import ProfilerActivity, profile

    from adaptivepnp_sci_torch import GapTVConfig, reconstruct_single_dispatch
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.ops import cuda_kernels

    sc = make_scene(b=8, h=sz.side, w=sz.side, seed=42)

    def run():
        return reconstruct_single_dispatch(sc.meas, sc.mask, GapTVConfig(iters=40), cfg, prior,
                                           params, orig=sc.orig_bayer, device=dev,
                                           mesh=_frame_mesh(meshes))

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        _sync(meshes, dev)
    times = []
    for _ in range(runs):
        _sync(meshes, dev)
        cuda_kernels.reset_launches()
        t0 = time.perf_counter()
        res = run()
        _sync(meshes, dev)
        times.append(time.perf_counter() - t0)
    return {"psnr": _np(res.psnr_per_frame), "x_bayer": _np(res.x_bayer),
            "finite": np.array(bool(torch.isfinite(res.x_bayer).all()
                                    & torch.isfinite(res.x_rgb).all())),
            "variables": _state_flat(res.variables),
            "seconds_per_snapshot": np.array(float(np.median(times))),
            "seconds_runs": np.array(times), **collective_profile(prof, "warmup_")}


def case_frame_flagship_full(meshes, dev, sz):
    """The FFDNet flagship through ``reconstruct_single_dispatch(mesh=)``."""
    from adaptivepnp_sci_torch import ADMMConfig, AdaptConfig, ffdnet_prior
    from adaptivepnp_sci_torch.models.convert import ffdnet_from_flax
    from adaptivepnp_sci_torch.models.ffdnet import FFDNet

    cfg = ADMMConfig(**FLAGSHIP_SCHEDULE, adapt=AdaptConfig(**FLAGSHIP_ADAPT))
    return _snapshot_full(meshes, dev, sz, ffdnet_prior(FFDNet(nc=96, nb=12)),
                          ffdnet_from_flax(flax_style_ffdnet_params(96, 12, seed=0)), cfg,
                          FRAME_FULL_RUNS["frame_flagship_full"])


def _fastdvd_full(meshes, dev, sz, name, dtype, remat, adapt):
    """The FastDVDnet Bosphorus row (``weights/``, the adaptation noise from
    the default CPU generator) through ``reconstruct_single_dispatch(mesh=)``."""
    from adaptivepnp_sci_torch import ADMMConfig, AdaptConfig, FastDVDnet, fastdvd_prior

    cfg = ADMMConfig(**FULL_SCHEDULE, denoiser="fastdvd",
                     adapt=AdaptConfig(**FULL_ADAPT) if adapt else None)
    return _snapshot_full(meshes, dev, sz, fastdvd_prior(FastDVDnet(dtype=dtype, remat=remat)),
                          _fastdvd_params(), cfg, FRAME_FULL_RUNS[name])


def case_frame_fastdvd_full(meshes, dev, sz):
    """The bf16 row (remat off) as the ``fastdvd`` phase runs it."""
    return _fastdvd_full(meshes, dev, sz, "frame_fastdvd_full", torch.bfloat16, False, True)


def case_frame_fastdvd_fixed_full(meshes, dev, sz):
    """The bf16 row without its adaptation."""
    return _fastdvd_full(meshes, dev, sz, "frame_fastdvd_fixed_full", torch.bfloat16, False,
                         False)


def case_frame_fastdvd_fp32_full(meshes, dev, sz):
    """The float32 row (remat on) as the ``fastdvd`` phase runs it."""
    return _fastdvd_full(meshes, dev, sz, "frame_fastdvd_fp32_full", None, True, True)


CASES: dict[str, Callable] = {
    "halo": case_halo, "too_many_shards": case_too_many_shards, "prior": case_prior,
    "prior_bf16": case_prior_bf16, "prior_grad": case_prior_grad, "dp_step": case_dp_step,
    "trainer": case_trainer, "solver": case_solver, "solver_adapt": case_solver_adapt,
    "tiled": case_tiled, "tiled_guard": case_tiled_guard, "tiled_dm": case_tiled_dm,
    "batched": case_batched,
    "frame_tv": case_frame_tv, "frame_ffdnet": case_frame_ffdnet,
    "frame_fastdvd": case_frame_fastdvd, "frame_fastdvd_adapt": case_frame_fastdvd_adapt,
    "frame_ddnet": case_frame_ddnet, "frame_dispatch": case_frame_dispatch,
    "frame_gap_deep": case_frame_gap_deep, "frame_gray": case_frame_gray,
    "frame_loss_grad": case_frame_loss_grad,
    "frame_loss_grad_all_reduce_sum": case_frame_loss_grad_all_reduce_sum,
    "frame_refusals": case_frame_refusals, "batched_adapt": case_batched_adapt,
    "prior_full": case_prior_full, "tiled_full": case_tiled_full, "train_full": case_train_full,
    "frame_flagship_full": case_frame_flagship_full,
    "frame_fastdvd_full": case_frame_fastdvd_full,
    "frame_fastdvd_fixed_full": case_frame_fastdvd_fixed_full,
    "frame_fastdvd_fp32_full": case_frame_fastdvd_fp32_full,
}
#: the frame-sharded solve's cases and the adapting batched driver's
FRAME_CASES = [c for c in CASES if c.startswith("frame_") and not c.endswith("_full")]
FRAME_CASES.append("batched_adapt")
#: the cases of a run at each size (the bf16 prior only where it has a kernel)
DEFAULT_CASES = {"cpu": list(CASES)[:13] + FRAME_CASES, "card": list(CASES)[:13] + FRAME_CASES,
                 "full": ["prior_full", "tiled_full", "train_full", *FRAME_FULL_RUNS]}
DEFAULT_CASES["cpu"].remove("prior_bf16")
#: cases whose every result is a flag that a refusal was made (none at one rank)
REFUSALS = {"too_many_shards", "frame_refusals"}
#: cases that must differ from the one-process run
MUST_FAIL = {"frame_loss_grad_all_reduce_sum"}
#: cases that time themselves, and profile only what they do not time
SELF_TIMED = {"prior_full", "tiled_full", "train_full", *FRAME_FULL_RUNS}

#: (The adaptation and training cases step at lr 2e-6 or below: Adam moves a
#: weight by about lr whatever its gradient's size, so where two summation
#: orders give a near-zero gradient opposite signs the weights part by 2 lr a
#: step, which these bars must hold; the data-parallel FFDNet step keeps the
#: JAX test's lr 1e-3.)
#: the largest difference allowed between a rank's arrays and the one-process
#: oracle's, in units of the larger of 1 and the oracle array's largest
#: magnitude (BatchNorm's running variances reach ~1.3e3): float32, where
#: summation orders differ across ranks, and the bf16 prior (two roundings of
#: one sum can differ by a bf16 ulp)
TOLERANCES = {"default": 1e-5, "prior_bf16": 2e-2}


def run_case(name: str, meshes: dict | None, device: str, sizes: Sizes) -> dict:
    """One case's arrays, float32 convolutions in full precision (TF32 off,
    as the solvers and the trainer run them)."""
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32

    with full_f32():
        return CASES[name](meshes, torch.device(device), sizes)


def collective_profile(prof, prefix: str = "") -> dict[str, np.ndarray]:
    """The collectives in a ``torch.profiler`` run: the count and the host
    milliseconds of the backend's events (``gloo:*`` run the whole
    collective on gloo's thread, waits included; ``nccl:*`` only enqueue
    it), and the device milliseconds of NCCL's kernels. Read from the
    profiler's raw events, by name, as ``key_averages`` sums them, without
    building its event tree (a FastDVDnet snapshot leaves ~150,000 events,
    and the tree takes seconds to build on the host)."""
    from torch.autograd import DeviceType

    host: dict[str, list[float]] = {}
    dev_ms = 0.0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        # a gloo collective of CUDA tensors also leaves a device-side event
        # of its name (its copies): the host events are the collectives
        if name.startswith(("gloo:", "nccl:")) and e.device_type() == DeviceType.CPU:
            host.setdefault(name, []).append(e.duration_ns() / 1e6)
        elif "nccl" in name.lower() and "kernel" in name.lower():
            dev_ms += e.duration_ns() / 1e6
    timed = {k: v for k, v in host.items() if sum(v) > 0}
    return {f"{prefix}collectives_ms": np.array(sum(map(sum, timed.values()))),
            f"{prefix}collectives_count": np.array(sum(map(len, timed.values()))),
            f"{prefix}collectives_by_key": np.array(
                [f"{k} x{len(v)} {sum(v):.3f} ms" for k, v in timed.items()], dtype=str),
            f"{prefix}nccl_device_ms": np.array(dev_ms)}


# --------------------------------------------------------------- the worker


def worker(rank: int, nproc: int, init: str, device: str, backend: str, cases: list[str],
           size: str, out: str) -> None:
    torch.set_num_threads(1)
    from adaptivepnp_sci_torch.ops import cuda_kernels
    from adaptivepnp_sci_torch.parallel import make_mesh
    from adaptivepnp_sci_torch.parallel.distributed import initialize
    import torch.distributed as dist

    initialize(init, nproc, rank, backend=backend, device=device)
    initialize(init, nproc, rank, backend=backend, device=device)  # joined: a no-op
    meshes = {"frame": make_mesh(1, nproc), "data": make_mesh(nproc, 1)}
    if device == "cuda":
        cuda_kernels.build()  # loads the libraries the parent built
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    results: dict[str, np.ndarray] = {}
    for name in cases:
        cuda_kernels.reset_launches()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.perf_counter()
        if name in SELF_TIMED or device != "cuda":
            arrays = run_case(name, meshes, device, SIZES[size])
        else:
            with profile(activities=activities) as prof:
                arrays = run_case(name, meshes, device, SIZES[size])
            arrays.update(collective_profile(prof))
        if device == "cuda":
            torch.cuda.synchronize()
            results[f"{name}__peak_mem_bytes"] = np.array(torch.cuda.max_memory_allocated())
        results[f"{name}__seconds"] = np.array(time.perf_counter() - t0)
        for k, v in cuda_kernels.launches.items():
            results[f"{name}__launches__{k}"] = np.array(v)
        # the conv pair's launches by (C, H, W) of the activation
        results[f"{name}__launches_by_shape"] = np.array(
            [[*shape, n] for shape, n in sorted(cuda_kernels.convpair_launches.items())],
            np.int64).reshape(-1, 4)
        for k, v in arrays.items():
            results[f"{name}__{k}"] = np.asarray(v)
        print(f"rank {rank}: {name} done", flush=True)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **results)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: OK", flush=True)


def split_results(arrays: dict[str, np.ndarray]) -> dict[str, dict[str, np.ndarray]]:
    """``{case: {key: array}}`` from a rank's ``case__key`` arrays."""
    out: dict[str, dict[str, np.ndarray]] = {}
    for key, v in arrays.items():
        case, _, rest = key.partition("__")
        out.setdefault(case, {})[rest] = v
    return out


def launch(nproc: int, out: str, device: str, backend: str, cases: list[str], size: str,
           timeout: float = 600.0) -> list[dict[str, dict[str, np.ndarray]]]:
    """Run ``cases`` at ``SIZES[size]`` on ``nproc`` worker processes on
    ``device`` (``"cuda"`` or ``"cpu"``), joined over ``backend`` through a
    ``file://`` rendezvous in ``out``; returns each rank's results by case.
    Raises ``RuntimeError`` (with the workers' log tails) when a worker fails
    or the run outlasts ``timeout`` seconds; every worker is stopped."""
    init = f"file://{os.path.join(out, 'rendezvous')}"
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    procs, logs = [], []
    for rank in range(nproc):
        log = open(os.path.join(out, f"worker{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "adaptivepnp_sci_torch.multihost_validation",
             "--worker", str(rank), str(nproc), init, "--device", device, "--backend", backend,
             "--cases", ",".join(cases), "--size", size, "--out", out],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env, start_new_session=True))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    tails = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0 or f"rank {rank}: OK" not in text:
            tails.append(f"--- worker {rank} (rc={p.returncode}) ---\n"
                         + "\n".join(text.strip().splitlines()[-40:]))
    if tails:
        raise RuntimeError("multihost validation failed:\n" + "\n".join(tails))
    return [split_results(dict(np.load(os.path.join(out, f"rank{r}.npz"))))
            for r in range(nproc)]


#: the worker's measurements beside a case's results: launches, times,
#: memory, the collectives' profile
_MEASURED = ("launches", "seconds", "peak_mem", "collectives", "nccl_", "warmup_", "call_",
             "step_")


def outputs(case: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """A rank's results of one case without the worker's measurements."""
    return {k: v for k, v in case.items() if not k.startswith(_MEASURED)}


def compare(name: str, got: dict[str, np.ndarray], want: dict[str, np.ndarray],
            tol: float | None = None) -> float:
    """The largest scaled difference (:data:`TOLERANCES`) of a rank's arrays from the oracle's
    (launch counts and times left out); raises ``AssertionError`` past the
    case's tolerance (or ``tol``), or when the oracle lacks one of them or the
    rank has none (the oracle may have more: one process runs every form)."""
    tol = TOLERANCES.get(name, TOLERANCES["default"]) if tol is None else tol
    worst = 0.0
    if not got:
        raise AssertionError(f"{name}: no results")
    for key, g in got.items():
        if key not in want:
            raise AssertionError(f"{name}: {key} missing from the oracle")
        w = want[key]
        if g.shape != w.shape:
            raise AssertionError(f"{name}/{key}: shape {g.shape}, want {w.shape}")
        if w.dtype.kind in "fc":
            scale = max(1.0, float(np.max(np.abs(w)))) if w.size else 1.0
            d = float(np.max(np.abs(g.astype(np.float64) - w))) / scale if w.size else 0.0
            worst = max(worst, d)
            if not d <= tol:
                raise AssertionError(f"{name}/{key}: max |d| {d} > {tol}")
        elif not np.array_equal(g, w):
            raise AssertionError(f"{name}/{key}: {g} != {w}")
    return worst


def grad_norm_ratios(got: dict[str, np.ndarray], want: dict[str, np.ndarray]
                     ) -> dict[str, float]:
    """``||g_rank|| / ||g_one||`` of each ``*_grads`` array of a case."""
    return {k: float(np.linalg.norm(got[k]) / np.linalg.norm(want[k]))
            for k in got if k.endswith("_grads")}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", nargs=3, metavar=("RANK", "NPROC", "INIT"))
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--cases", default=None, help=f"comma-separated subset of {','.join(CASES)}")
    ap.add_argument("--size", default=None, choices=tuple(SIZES),
                    help="default: card on cuda, cpu on cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from adaptivepnp_sci_torch.parallel.distributed import default_backend

    backend = args.backend or default_backend(args.device)
    size = args.size or ("card" if args.device == "cuda" else "cpu")
    cases = DEFAULT_CASES[size] if args.cases is None else args.cases.split(",")
    if args.worker:
        rank, nproc, init = int(args.worker[0]), int(args.worker[1]), args.worker[2]
        worker(rank, nproc, init, args.device, backend, cases, size, args.out)
        return 0
    torch.set_num_threads(1)
    if args.device == "cuda":
        from adaptivepnp_sci_torch.ops import cuda_kernels

        cuda_kernels.build()  # once, before the ranks load the libraries
    with tempfile.TemporaryDirectory() as out:
        ranks = launch(args.nproc, out, args.device, backend, cases, size)
    for name in cases:
        want = run_case(name, None, args.device, SIZES[size])
        for rank, res in enumerate(ranks):
            got = outputs(res[name])
            if name in REFUSALS:
                ok = args.nproc < 2 or all(bool(v) for v in got.values())
                print(f"rank {rank}: {name}: {'refused' if ok else 'NOT refused'}")
                if not ok:
                    return 1
                continue
            if name in MUST_FAIL and args.nproc > 1:
                ratios = grad_norm_ratios(got, want)
                ok = any(abs(r - 1.0) > 1e-3 for r in ratios.values())
                print(f"rank {rank}: {name} {'fails as it must' if ok else 'does NOT fail'}: "
                      f"gradient norm ratios {ratios}", flush=True)
                if not ok:
                    return 1
                continue
            worst = compare(name, got, want)
            print(f"rank {rank}: {name} matches the one-process run (max |d| {worst:.3g})",
                  flush=True)
    print(f"multihost validation: {args.nproc} processes OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
