"""Command-line entry points (port of ``adaptivepnp_sci_tpu.cli``).

  python -m adaptivepnp_sci_torch.cli synth --out scene.mat --size 512 --frames 8
  python -m adaptivepnp_sci_torch.cli warmstart --data scene.mat --out warm.mat
  python -m adaptivepnp_sci_torch.cli reconstruct --data scene.mat --warm warm.mat \\
      --denoiser fastdvd --bf16 --out results.mat
  python -m adaptivepnp_sci_torch.cli eval results.mat --data scene.mat
  python -m adaptivepnp_sci_torch.cli serve --watch in/ --out out/ --once
  python -m adaptivepnp_sci_torch.cli train --network fastdvd --ckpt-dir ckpt/
  python -m adaptivepnp_sci_torch.cli denoise --network fastdvd --ckpt ckpt/final.pt

``warmstart``, ``reconstruct``, ``serve``, ``train`` and ``denoise`` run on
``--device`` (default ``cuda``; ``--device cpu`` runs the plain PyTorch
versions of the kernels on the CPU); there is no silent fallback from one to
the other. ``synth`` and ``eval`` run on the host. The flags are the JAX
package's, with these differences: checkpoints are ``.pth`` (the
reference's), ``.npz`` (the ``/``-keyed files of ``weights/``) or ``.pt``
(this package's trainer checkpoints; ``train`` writes ``{ckpt-dir}/final.pt``),
never orbax directories; ``--random-init`` and ``train`` draw PyTorch's
default initialisation under a fixed seed, not the JAX package's
``PRNGKey`` Flax weights.
"""

from __future__ import annotations

import argparse
import os
import pathlib
from typing import Any, Callable

import numpy as np

REPO_WEIGHTS = pathlib.Path(__file__).resolve().parent.parent / "weights"


def _seeded_init(build: Callable[[], Any], seed: int) -> dict:
    """The state dict of ``build()``'s PyTorch default initialisation, drawn
    from the CPU generator seeded with ``seed`` (the caller's generator state
    is restored)."""
    import torch

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build().state_dict()


def _load_weights(path: str | None, pth_loader: Callable[[str], dict],
                  from_flax: Callable[[dict], dict], init_fn: Callable[[], dict],
                  defaults: tuple[str, ...] = (), random_init: bool = False) -> dict:
    """A state dict from a reference ``.pth`` (``pth_loader``), a ``/``-keyed
    ``.npz`` of Flax variables (``from_flax``) or a trainer checkpoint
    ``.pt`` (:func:`~adaptivepnp_sci_torch.train.trainer.load_checkpoint_variables`).
    Without a path,
    the first default checkpoint that exists; ``init_fn()`` (untrained
    weights) only with ``random_init``: a random denoiser reconstructs
    garbage, so it is never a silent fallback. Orbax checkpoint directories
    are refused."""
    from adaptivepnp_sci_torch.models.convert import load_variables_npz

    if not path:
        if random_init:
            return init_fn()
        path = next((d for d in defaults if os.path.exists(d)), None)
        if path is None:
            raise SystemExit(
                "error: no --ckpt given and no default checkpoint found "
                f"(searched: {', '.join(defaults)}). Pass --ckpt, or "
                "--random-init for an untrained-model smoke test."
            )
    if os.path.isdir(path):
        raise SystemExit(
            f"error: {path} is a directory (an orbax checkpoint of the JAX "
            "package); this package reads .pth, /-keyed .npz and .pt checkpoints only")
    if not os.path.exists(path):
        raise SystemExit(f"error: checkpoint {path} not found")
    if path.endswith(".pth"):
        return pth_loader(path)
    if path.endswith(".npz"):
        return from_flax(load_variables_npz(path))
    if path.endswith(".pt"):
        from adaptivepnp_sci_torch.train.trainer import load_checkpoint_variables

        try:
            return load_checkpoint_variables(path)
        except ValueError as e:
            raise SystemExit(f"error: {e}") from e
    raise SystemExit(f"error: {path}: unknown checkpoint format (expected .pth, .npz or .pt)")


def _build_denoiser(denoiser: str, ckpt: str | None, random_init: bool = False,
                    bf16: bool = False):
    """``(model, prior, variables)`` for a CLI run (``reconstruct``, ``serve``)."""
    import torch

    from adaptivepnp_sci_torch.models import convert

    if denoiser == "ffdnet":
        from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color
        from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior

        model = ffdnet_color()
        variables = _load_weights(
            ckpt, convert.load_ffdnet, convert.ffdnet_from_flax,
            lambda: _seeded_init(ffdnet_color, 0),
            defaults=(str(REPO_WEIGHTS / "ffdnet_color.pth"),), random_init=random_init)
        return model, ffdnet_prior(model), variables
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior

    # bf16: the DenBlocks' conv/BN chains in bf16 with float32 residuals; the
    # bf16 activations fit without recomputation in the adaptation's backward
    model = FastDVDnet(dtype=torch.bfloat16 if bf16 else None, remat=not bf16)
    variables = _load_weights(
        ckpt, convert.load_fastdvdnet, convert.fastdvdnet_from_flax,
        lambda: _seeded_init(FastDVDnet, 0),
        defaults=(str(REPO_WEIGHTS / "fastdvd.npz"),), random_init=random_init)
    return model, fastdvd_prior(model), variables


def _check_device(device: str) -> str:
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"error: --device {device} but no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return device


def _cmd_warmstart(args) -> None:
    from adaptivepnp_sci_torch.data.mat_io import load_cacti_mat, save_warm_start
    from adaptivepnp_sci_torch.pipelines import run_warm_start

    device = _check_device(args.device)
    scene = load_cacti_mat(args.data, name=args.name)
    prior = variables = None
    if args.denoiser == "ffdnet":
        from adaptivepnp_sci_torch.models.convert import load_ffdnet
        from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color
        from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior

        if not args.ckpt:
            raise SystemExit("--denoiser ffdnet requires --ckpt <ffdnet.pth>")
        prior = ffdnet_prior(ffdnet_color())
        variables = load_ffdnet(args.ckpt)
    out = run_warm_start(scene, iters=args.iters, denoiser=args.denoiser, prior=prior,
                         variables=variables, device=device)
    save_warm_start(args.out, out.x_bayer)
    print(f"warm start PSNR {out.psnr.mean():.2f} dB -> {args.out}")


def trainable_names(model, filters: tuple[str, ...]) -> tuple[str, ...]:
    """The names of ``model``'s parameters whose Flax ``params`` path contains
    one of ``filters``: the parameters the JAX package's
    ``--trainable-filter`` selects for the same strings."""
    from adaptivepnp_sci_torch.models.convert import flax_param_path

    names = tuple(n for n, _ in model.named_parameters()
                  if any(f in flax_param_path(n) for f in filters))
    if not names:
        raise SystemExit(f"error: --trainable-filter {','.join(filters)} matches no "
                         "parameter of the denoiser")
    return names


def _cmd_reconstruct(args) -> None:
    import dataclasses

    import torch

    from adaptivepnp_sci_torch.configs.scenes import admm_config_for
    from adaptivepnp_sci_torch.data.mat_io import load_cacti_mat, load_warm_start, save_results
    from adaptivepnp_sci_torch.models import convert
    from adaptivepnp_sci_torch.pipelines import run_reconstruction

    device = _check_device(args.device)
    auto_ckpt = args.ckpt == "auto"
    if auto_ckpt and args.denoiser != "fastdvd":
        raise SystemExit(
            "error: --ckpt auto selects among the shipped FastDVDnet weight "
            "variants (weights/fastdvd{,_smooth}.npz); FFDNet ships one "
            "checkpoint — pass a path instead"
        )
    if (args.dm_update or args.dm_in_scan) and not args.deep_demosaicking:
        raise SystemExit(
            "error: --dm-update/--dm-in-scan adapt the DDnet demosaicker and "
            "require --deep-demosaicking"
        )
    if args.auto_demosaic and args.deep_demosaicking:
        raise SystemExit(
            "error: --auto-demosaic picks Malvar vs DDnet itself; drop "
            "--deep-demosaicking (or keep it to force DDnet)"
        )
    scene = load_cacti_mat(args.data, name=args.name)
    model, prior, variables = _build_denoiser(
        args.denoiser, None if auto_ckpt else args.ckpt, random_init=args.random_init,
        bf16=args.bf16)
    warm = load_warm_start(args.warm, scene.n_frames) if args.warm else None

    if auto_ckpt:
        # ground-truth-free choice of the weight variant by held-out
        # measurement cross-validation
        from adaptivepnp_sci_torch.pipelines import select_prior_variables

        candidates = {
            "natural": variables,
            "smooth": convert.fastdvdnet_from_flax(
                convert.load_variables_npz(str(REPO_WEIGHTS / "fastdvd_smooth.npz"))),
        }
        pick = select_prior_variables(scene, prior, candidates, warm_start=warm, device=device)
        print(f"auto-ckpt: {pick}")
        variables = candidates[pick]

    deep_dd = args.deep_demosaicking
    demosaic_fn = dd = dd_vars = None
    if args.deep_demosaicking or args.auto_demosaic:
        from adaptivepnp_sci_torch.models.ddnet import DDnet
        from adaptivepnp_sci_torch.solvers.priors import ddnet_demosaic

        dd = DDnet(dtype=torch.bfloat16 if args.bf16 else None)
        dd_vars = _load_weights(
            args.ddnet_ckpt, convert.load_ddnet, convert.ddnet_from_flax,
            lambda: _seeded_init(DDnet, 1),
            defaults=(str(REPO_WEIGHTS / "ddnet.npz"),), random_init=args.random_init)
        if args.auto_demosaic:
            from adaptivepnp_sci_torch.pipelines import select_demosaicker

            pick = select_demosaicker(scene, prior, variables, dd, dd_vars, warm_start=warm,
                                      device=device)
            print(f"auto-demosaic: {pick}")
            deep_dd = pick == "ddnet"
        if deep_dd and not args.dm_update:
            demosaic_fn = ddnet_demosaic(dd, dd_vars)
        if not deep_dd:
            dd = dd_vars = None

    config = None
    adapt_flags = (args.adapt_carried_opt or args.adapt_lr or args.adapt_update_per_iter
                   or args.trainable_filter or args.adapt_crop)
    solver_flags = (args.select_best is not None or args.relax
                    or args.select_holdout is not None)
    if adapt_flags or solver_flags:
        # override fields of the scene's table row
        config = admm_config_for(scene.name, args.denoiser, deep_dd, not args.no_update)
        if adapt_flags and config.adapt is None:
            raise SystemExit(
                "error: adaptation overrides given but the selected config "
                "has no adaptation (did you pass --no-update?)"
            )
        over: dict[str, Any] = {}
        if args.adapt_carried_opt:
            over["fresh_opt_per_trigger"] = False
        if args.adapt_lr:
            lrs = tuple(float(v) for v in args.adapt_lr.split(","))
            over["lr"] = lrs[0] if len(lrs) == 1 else lrs
        if args.adapt_update_per_iter:
            ns = tuple(int(v) for v in args.adapt_update_per_iter.split(","))
            over["update_per_iter"] = ns[0] if len(ns) == 1 else ns
        if args.trainable_filter:
            over["trainable_filter"] = trainable_names(
                model, tuple(args.trainable_filter.split(",")))
        if args.adapt_crop:
            over["crop"] = args.adapt_crop
        if over:
            config = dataclasses.replace(config, adapt=dataclasses.replace(config.adapt, **over))
        solver_over: dict[str, Any] = {}
        if args.select_best is not None:
            solver_over["select_best"] = args.select_best
        if args.select_holdout is not None:
            solver_over["select_best_holdout"] = args.select_holdout
            if args.select_holdout > 0:
                solver_over["select_best"] = True
        if args.relax:
            rs = tuple(float(v) for v in args.relax.split(","))
            solver_over["denoiser_relax"] = rs[0] if len(rs) == 1 else rs
        if solver_over:
            config = dataclasses.replace(config, **solver_over)

    out = run_reconstruction(
        scene, prior, variables,
        denoiser=args.denoiser,
        deep_demosaicking=deep_dd,
        update=not args.no_update,
        reuse_model=not args.no_reuse_model,
        warm_start=warm,
        demosaic_fn=demosaic_fn,
        config=config,
        dm_model=dd, dm_variables=dd_vars,
        dm_update=args.dm_update, dm_lr=args.dm_lr,
        dm_update_per_iter=args.dm_update_per_iter,
        dm_in_scan=args.dm_in_scan,
        dm_fresh_opt=args.dm_fresh_opt,
        tile=args.tile,
        tile_overlap=args.tile_overlap,
        tile_chunk=args.tile_chunk,
        device=device,
    )
    if args.out:
        save_results(
            args.out, out.x_bayer, out.x_rgb, out.psnr, out.ssim, out.psnr_all_iter,
            orig_real=scene.orig_real,
            meas_bayer=np.transpose(scene.meas, (1, 2, 0)) * scene.maxb,
        )
    print(
        f"{args.name or args.data}: PSNR {out.psnr.mean():.2f} dB, "
        f"SSIM {out.ssim.mean():.4f}, "
        f"{np.mean(out.seconds_per_meas):.2f}s/measurement"
    )


def _cmd_train(args) -> None:
    """Offline denoiser training on synthetic clips (256 of ``--patch``
    pixels) or the arrays of ``--data``; writes ``{ckpt-dir}/final.pt``."""
    from adaptivepnp_sci_torch.train import Trainer, TrainerConfig
    from adaptivepnp_sci_torch.train.datasets import (
        batch_iterator,
        load_array_dir,
        synthetic_video_dataset,
        temporal_chunks,
    )
    from adaptivepnp_sci_torch.train.tasks import ddnet_task, fastdvd_task, ffdnet_task

    device = _check_device(args.device)
    length = 1 if args.network == "ffdnet" else 5
    if args.data:
        clips = np.concatenate([temporal_chunks(v, length) for v in load_array_dir(args.data)])
    else:
        clips = synthetic_video_dataset(256, length=length, size=args.patch, seed=args.seed)
    if args.network == "ffdnet":
        clips = clips[:, 0]

    # the published widths: FFDNet-color nc 96 / nb 12, FastDVDnet (32, 64, 128),
    # DDnet's; PyTorch's default initialisation drawn under --seed
    if args.network == "ffdnet":
        from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color as build

        make_task = ffdnet_task
    elif args.network == "fastdvd":
        from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet as build

        make_task = fastdvd_task
    else:
        from adaptivepnp_sci_torch.models.ddnet import DDnet as build

        make_task = ddnet_task
    trainer = Trainer(
        make_task(build()), _seeded_init(build, args.seed),
        TrainerConfig(lr=args.lr, steps_per_epoch=max(len(clips) // args.batch, 1),
                      ckpt_dir=args.ckpt_dir, seed=args.seed),
        device=device)
    if args.resume:
        try:
            trainer.restore(args.resume)
        except ValueError as e:
            raise SystemExit(f"error: {e}") from e
    trainer.fit(batch_iterator(clips, args.batch, seed=args.seed), max_steps=args.steps)
    final = os.path.join(args.ckpt_dir, "final.pt")
    trainer.save(final)
    print(f"trained {args.network} for {trainer.step} steps -> {final}")


def _cmd_denoise(args) -> None:
    """Standalone denoiser test (the reference's per-denoiser test scripts,
    ``packages/ffdnet/test_ffdnet_ipol.py:559-692`` /
    ``packages/fastdvdnet/test_fastdvdnet.py:51-147``): load clean data, add
    gaussian noise at ``--sigma`` (drawn with NumPy from ``--seed``), denoise,
    report PSNR. ``--network ddnet`` is the joint demosaick-and-denoise eval
    (``packages/DDnet/joint_test_fastdvdnet.py:108-140``)."""
    import torch

    from adaptivepnp_sci_torch.models import convert
    from adaptivepnp_sci_torch.ops import metrics
    from adaptivepnp_sci_torch.solvers.priors import module_copy

    device = _check_device(args.device)
    rng = np.random.default_rng(args.seed)
    if args.data:
        clean = np.load(args.data).astype(np.float32)
        if clean.max() > 2.0:
            clean = clean / 255.0
    else:
        from adaptivepnp_sci_torch.train.datasets import synthetic_video_dataset

        clean = synthetic_video_dataset(1, length=8, size=args.size, seed=args.seed)[0]
    if args.gray:
        if args.network != "ffdnet":
            raise SystemExit("error: --gray is only supported with --network ffdnet")
        # the reference's gray mode noises the grayscale image (BT.601 luma)
        if clean.ndim == 4 and clean.shape[-1] == 3:
            luma = np.array([0.299, 0.587, 0.114], np.float32)
            clean = (clean @ luma)[..., None]
    sigma = args.sigma / 255.0
    noisy = (clean + rng.normal(0, sigma, clean.shape)).astype(np.float32)
    if args.network != "ddnet":
        # the FFDNet and FastDVDnet scripts clip the noisy input; the DDnet
        # joint eval feeds it unclipped (joint_test_fastdvdnet.py:108)
        noisy = np.clip(noisy, 0, 1)

    x = torch.from_numpy(noisy).to(device)
    sig = torch.tensor(sigma, dtype=torch.float32, device=device)
    with torch.no_grad():
        if args.network == "ffdnet":
            from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color, ffdnet_gray

            model = ffdnet_gray() if args.gray else ffdnet_color()
            variables = _load_weights(args.ckpt, convert.load_ffdnet, convert.ffdnet_from_flax,
                                      lambda: {})
            out = module_copy(model, variables, device)(x, sig)
        elif args.network == "ddnet":
            import torch.nn.functional as F

            from adaptivepnp_sci_torch.models.ddnet import DDnet
            from adaptivepnp_sci_torch.ops import bayer
            from adaptivepnp_sci_torch.solvers.priors import window_indices_mirror

            variables = _load_weights(args.ckpt, convert.load_ddnet, convert.ddnet_from_flax,
                                      lambda: {})
            rgb_sparse = bayer.embed_rgb(bayer.mosaic(x))            # (B, H, W, 3)
            # reflect-pad to multiples of 4 for the two U-Net downsamplings
            hh, ww = rgb_sparse.shape[1:3]
            hp, wp = (-hh) % 4, (-ww) % 4
            inp = rgb_sparse
            if hp or wp:
                inp = F.pad(inp.permute(0, 3, 1, 2), (0, wp, 0, hp),
                            mode="reflect").permute(0, 2, 3, 1)
            idx = window_indices_mirror(inp.shape[0]).to(device)
            out = module_copy(DDnet(), variables, device)(inp[idx])[:, :hh, :ww]
            # min-max normalisation, guarded against a constant output
            out = (out - out.min()) / torch.clamp(out.max() - out.min(), min=1e-12)
            # the report's "noisy" input is the sparse-RGB mosaic
            x = rgb_sparse
        else:
            from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
            from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior

            prior = fastdvd_prior(FastDVDnet())
            variables = _load_weights(args.ckpt, convert.load_fastdvdnet,
                                      convert.fastdvdnet_from_flax, lambda: {})
            out = prior.apply(module_copy(prior.model, variables, device), x, sig)
        out = torch.clamp(out, 0, 1)
        ref = torch.from_numpy(clean).to(device)
        if args.network == "ddnet":
            # the joint eval's batch_psnr: the mean of per-frame PSNRs
            p_in = float(metrics.psnr_per_frame(ref, x).mean())
            p_out = float(metrics.psnr_per_frame(ref, out).mean())
        else:
            p_in = float(metrics.psnr(ref, x))
            p_out = float(metrics.psnr(ref, out))
    print(f"sigma {args.sigma}: noisy {p_in:.2f} dB -> denoised {p_out:.2f} dB")
    if args.out:
        np.save(args.out, out.cpu().numpy())


def _cmd_synth(args) -> None:
    import scipy.io as sio

    from adaptivepnp_sci_torch.data.synthetic import make_scene

    style = args.style or ("textured" if args.textured else "smooth")
    s = make_scene(b=args.frames, h=args.size, w=args.size, seed=args.seed,
                   n_meas=args.n_meas, style=style, photo_source=args.photo_source)
    meas = s.meas if s.meas.ndim == 3 else s.meas[..., None]
    orig = s.orig_bayer if s.orig_bayer.ndim == 4 else s.orig_bayer[None]
    t, b, h, w = orig.shape
    # stored 0-255-scaled like real CACTI files (the loader divides by maxb)
    sio.savemat(
        args.out,
        {
            "meas_bayer": meas.reshape(h, w, -1) * 255.0,
            "mask_bayer": np.transpose(s.mask, (1, 2, 0)),
            "orig_bayer": np.transpose(orig.reshape(t * b, h, w), (1, 2, 0)) * 255.0,
            "orig": np.transpose(s.orig_rgb.reshape(t * b, h, w, 3), (1, 2, 3, 0)) * 255.0,
        },
    )
    print(f"synthetic scene -> {args.out}")


def _orig_real_to_tbhwc(rgb: np.ndarray, t_n: int, h: int, w: int) -> np.ndarray | None:
    """Normalize a stored ``orig_real`` RGB ground truth to (T, B, H, W, 3).

    The key is carried verbatim from the input scene, so its layout depends
    on where the scene came from: (T,B,H,W,3) from the pipelines,
    (H,W,3,T*B) from scipy-written v5 scenes, (T*B,3,W,H) from h5py-read
    v7.3 scenes (MATLAB-reversed). None for a layout not recognized.
    """
    if rgb.ndim == 5 and rgb.shape[-1] == 3:
        return rgb
    if rgb.ndim == 4 and rgb.shape[:2] == (h, w) and rgb.shape[2] == 3:
        out = np.transpose(rgb, (3, 0, 1, 2))          # (T*B, H, W, 3)
    elif rgb.ndim == 4 and rgb.shape[1] == 3 and rgb.shape[2:] == (w, h):
        out = np.transpose(rgb, (0, 3, 2, 1))          # (T*B, H, W, 3)
    else:
        return None
    if t_n <= 0 or out.shape[0] % t_n:
        return None
    return out.reshape(t_n, -1, *out.shape[1:])


def _cmd_eval(args) -> None:
    """Metrics report for a saved results ``.mat``: the stored per-measurement
    PSNR/SSIM summary and, when ground truth is available (``--data
    scene.mat``, or the ``orig_real`` key the results writer stores),
    PSNR/SSIM recomputed from the stored reconstruction. Host/NumPy only."""
    import scipy.io as sio

    from adaptivepnp_sci_torch.utils.image import calculate_psnr, calculate_ssim

    res = sio.loadmat(args.results)
    psnr = np.asarray(res["psnr"], np.float64)
    ssim = np.asarray(res["ssim"], np.float64)
    # the solver stores zeros when the scene carried no ground truth
    stored_real = bool(np.any(psnr))
    print(f"{args.results}: {psnr.shape[0]} measurement(s), "
          f"{psnr.shape[1] if psnr.ndim > 1 else 1} frame(s) each")
    if stored_real:
        for t in range(psnr.shape[0]):
            print(f"  meas {t}: PSNR {np.mean(psnr[t]):6.2f} dB  SSIM {np.mean(ssim[t]):.4f}")
        print(f"  mean:   PSNR {psnr.mean():6.2f} dB  SSIM {ssim.mean():.4f}")
    else:
        print("  stored PSNR/SSIM are all zero (reconstructed without ground truth)")

    h, w, tb = np.asarray(res["v_recon_bayer"]).shape
    orig_bayer = None
    if args.data:
        from adaptivepnp_sci_torch.data.mat_io import load_cacti_mat

        orig_bayer = load_cacti_mat(args.data, name="eval").orig_bayer
    if orig_bayer is None and "orig_real" in res:
        rgb = np.asarray(res["orig_real"], np.float32) / 255.0
        rgb = _orig_real_to_tbhwc(rgb, psnr.shape[0], h, w)
        if rgb is not None:
            from adaptivepnp_sci_torch.data.synthetic import cfa_masks

            orig_bayer = (rgb * cfa_masks(rgb.shape[-3:-1])).sum(-1)
        else:
            print(f"  orig_real layout {res['orig_real'].shape} not recognized; "
                  "skipping recompute")
    if orig_bayer is None:
        print("no ground truth available (pass --data); stored summary only")
        return

    t_n, b_n = orig_bayer.shape[:2]
    if t_n * b_n != tb:
        print(f"  ground truth ({t_n}x{b_n} frames) does not match the "
              f"reconstruction ({tb} frames); skipping recompute")
        return
    flat = np.asarray(res["v_recon_bayer"], np.float32)  # (H, W, T*B)
    x = np.transpose(flat, (2, 0, 1)).reshape(t_n, b_n, h, w)
    re_p = np.array([[calculate_psnr(x[t, b] * 255.0, orig_bayer[t, b] * 255.0)
                      for b in range(b_n)] for t in range(t_n)])
    re_s = np.array([[calculate_ssim(x[t, b] * 255.0, orig_bayer[t, b] * 255.0)
                      for b in range(b_n)] for t in range(t_n)])
    print(f"  recomputed vs ground truth: PSNR {re_p.mean():6.2f} dB  SSIM {re_s.mean():.4f}")
    dp = abs(re_p.mean() - psnr.mean())
    if stored_real and dp > 0.5:
        print(f"  WARNING: recomputed PSNR differs from stored by {dp:.2f} dB "
              "(different ground truth?)")


def _cmd_serve(args) -> None:
    """Reconstruction service: watch a directory for measurement ``.mat``
    files, reconstruct each with the standing configuration, write results.

    One long-lived process keeps the model loaded and the kernels built, so
    every file after the first runs at steady-state speed.
    ``--carry-weights`` threads the online-adapted denoiser weights from one
    file to the next. A file that fails to load, solve or write is reported
    as ``FAILED`` and skipped; it never stops the service.
    """
    import time as _time

    from adaptivepnp_sci_torch.data.mat_io import load_cacti_mat, save_results
    from adaptivepnp_sci_torch.pipelines import run_reconstruction

    device = _check_device(args.device)
    _, prior, variables = _build_denoiser(args.denoiser, args.ckpt,
                                          random_init=args.random_init, bf16=args.bf16)
    os.makedirs(args.out, exist_ok=True)
    seen: set[str] = set()
    sizes: dict[str, int] = {}
    print(f"serving: watching {args.watch} -> {args.out} "
          f"(denoiser={args.denoiser}, scene config={args.scene})", flush=True)
    while True:
        try:
            listing = set(f for f in os.listdir(args.watch) if f.endswith(".mat"))
        except FileNotFoundError:
            raise SystemExit(f"error: watch directory {args.watch} not found")
        # forget files that left the directory (a re-created name is a new file)
        seen &= listing
        for gone in [f for f in sizes if f not in listing]:
            del sizes[gone]
        names = sorted(listing - seen)
        ready = []
        for f in names:
            # only files whose size is stable across two polls (a writer may
            # still be streaming the file)
            try:
                sz = os.path.getsize(os.path.join(args.watch, f))
            except OSError:
                sizes.pop(f, None)  # vanished mid-poll; re-listed next round
                continue
            if sizes.get(f) == sz:
                ready.append(f)
            sizes[f] = sz
        for fname in ready:
            path = os.path.join(args.watch, fname)
            dst = os.path.join(args.out, fname)
            t0 = _time.perf_counter()
            try:
                scene = load_cacti_mat(path, name=args.scene)
                out = run_reconstruction(scene, prior, variables, denoiser=args.denoiser,
                                         update=not args.no_update, reuse_model=True,
                                         device=device)
                save_results(dst, out.x_bayer, out.x_rgb, out.psnr, out.ssim,
                             out.psnr_all_iter)
            except Exception as e:  # noqa: BLE001 — a bad file or a failed
                # result write must not kill the service; report and move on
                print(f"serve: {fname} FAILED: {e}", flush=True)
                seen.add(fname)
                continue
            if args.carry_weights and out.variables is not None:
                variables = out.variables
            seen.add(fname)
            # PSNR is only real when the file carries ground truth
            q = (f"PSNR {out.psnr.mean():.2f} dB"
                 if scene.orig_bayer is not None else "PSNR n/a (no orig)")
            print(f"serve: {fname} -> {dst}  {q}  {_time.perf_counter() - t0:.2f}s",
                  flush=True)
        if args.once and not names:
            break
        if not ready:
            _time.sleep(args.poll)


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs the kernels' "
                        "plain PyTorch versions on the CPU)")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="adaptivepnp-sci-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    w = sub.add_parser("warmstart", help="GAP warm start (TV or deep prior)")
    w.add_argument("--data", required=True)
    w.add_argument("--out", required=True)
    w.add_argument("--name", default="scene")
    w.add_argument("--iters", type=int, default=40)
    w.add_argument("--denoiser", choices=["tv", "ffdnet"], default="tv",
                   help="'ffdnet' selects the one-stage GAP deep branch")
    w.add_argument("--ckpt", default=None,
                   help="denoiser checkpoint (.pth) for --denoiser ffdnet")
    _add_device(w)
    w.set_defaults(fn=_cmd_warmstart)

    r = sub.add_parser("reconstruct", help="two-stage online-adaptive ADMM")
    r.add_argument("--data", required=True)
    r.add_argument("--name", default="Beauty", help="scene name for the schedule table")
    r.add_argument("--warm", default=None)
    r.add_argument("--out", default=None)
    r.add_argument("--denoiser", choices=["ffdnet", "fastdvd"], default="ffdnet")
    r.add_argument("--ckpt", default=None,
                   help="denoiser checkpoint (.pth or /-keyed .npz); defaults to the "
                        "shipped weights/ checkpoint. With --denoiser fastdvd, 'auto' "
                        "picks per scene between the natural-statistics and "
                        "smooth-procedural weight variants, ground-truth-free "
                        "(held-out measurement cross-validation, "
                        "pipelines.select_prior_variables)")
    r.add_argument("--ddnet-ckpt", default=None)
    r.add_argument("--random-init", action="store_true",
                   help="run with untrained weights (smoke tests only): PyTorch's "
                        "default initialisation under torch.manual_seed(0) (DDnet: 1), "
                        "not the JAX package's PRNGKey Flax weights")
    r.add_argument("--deep-demosaicking", action="store_true")
    r.add_argument("--auto-demosaic", action="store_true",
                   help="pick Malvar vs DDnet per scene, ground-truth-free: held-out "
                        "measurement cross-validation of both fixed-weight schedules "
                        "on the first measurement (pipelines.select_demosaicker)")
    r.add_argument("--dm-update", action="store_true",
                   help="adapt the DDnet demosaicker online (self-consistency)")
    r.add_argument("--dm-in-scan", action="store_true",
                   help="interleave dm adaptation inside solver iterations instead "
                        "of once per measurement")
    r.add_argument("--dm-lr", type=float, default=1e-6)
    r.add_argument("--dm-update-per-iter", type=int, default=1)
    r.add_argument("--dm-fresh-opt", action="store_true",
                   help="fresh Adam per dm update step (the reference's semantics)")
    r.add_argument("--adapt-carried-opt", action="store_true",
                   help="carry ONE Adam state through the solve and across "
                        "measurements; the default is a fresh Adam per trigger stage")
    r.add_argument("--adapt-lr", default=None,
                   help="override adaptation lr; comma-separated for per-stage lists")
    r.add_argument("--adapt-update-per-iter", default=None,
                   help="override adaptation steps per trigger; comma-separated "
                        "per-stage list")
    r.add_argument("--trainable-filter", default=None,
                   help="comma-separated substrings of the JAX package's Flax "
                        "parameter paths (e.g. 'temp2'); the parameters they select "
                        "are fine-tuned, the others frozen")
    r.add_argument("--adapt-crop", type=int, default=None,
                   help="adaptation loss on a Bayer-aligned random NxN crop")
    r.add_argument("--select-best", action=argparse.BooleanOptionalAction, default=None,
                   help="measurement-consistency best-iterate guard; default: the "
                        "scene table's row")
    r.add_argument("--select-holdout", type=float, default=None,
                   help="rank the best-iterate guard by held-out cross-validation on "
                        "this pixel fraction (implies --select-best when >0; 0 = raw "
                        "ranking); default: the scene table's row")
    r.add_argument("--relax", default=None,
                   help="relaxed denoiser step xhat=(1-r)x+rD(x); comma-separated for "
                        "a per-sigma-stage schedule")
    r.add_argument("--no-update", action="store_true")
    r.add_argument("--no-reuse-model", action="store_true")
    r.add_argument("--bf16", action="store_true",
                   help="FastDVDnet/DDnet conv chains in bf16 with float32 residuals")
    r.add_argument("--tile", type=int, default=None,
                   help="large-scene mode: solve as NxN tiles sharing one adaptation")
    r.add_argument("--tile-overlap", type=int, default=0,
                   help="halo overlap in px (even) for --tile")
    r.add_argument("--tile-chunk", type=int, default=None,
                   help="solve tiles in sequential groups of this size (must divide "
                        "the tile count): bounds peak memory")
    _add_device(r)
    r.set_defaults(fn=_cmd_reconstruct)

    d = sub.add_parser("denoise", help="standalone denoiser test")
    d.add_argument("--network", choices=["ffdnet", "fastdvd", "ddnet"], default="ffdnet",
                   help="ddnet = joint demosaick+denoise eval: mosaic the noisy frames "
                        "first (packages/DDnet/joint_test_fastdvdnet.py semantics)")
    d.add_argument("--ckpt", required=True,
                   help="denoiser checkpoint (.pth, /-keyed .npz, or a trainer .pt)")
    d.add_argument("--gray", action="store_true",
                   help="ffdnet only: grayscale mode (BT.601 luma, nc=64/nb=15 network)")
    d.add_argument("--data", default=None, help=".npy clean frames; default synthetic")
    d.add_argument("--sigma", type=float, default=25.0)
    d.add_argument("--size", type=int, default=128)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--out", default=None)
    _add_device(d)
    d.set_defaults(fn=_cmd_denoise)

    t = sub.add_parser("train", help="offline denoiser training")
    t.add_argument("--network", choices=["ffdnet", "fastdvd", "ddnet"], required=True)
    t.add_argument("--data", default=None,
                   help="dir of .npy/.npz clips; default: synthetic clips")
    t.add_argument("--steps", type=int, default=2000)
    t.add_argument("--batch", type=int, default=16)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--patch", type=int, default=96)
    t.add_argument("--ckpt-dir", required=True)
    t.add_argument("--resume", default=None, help="a trainer checkpoint (.pt) to continue")
    t.add_argument("--seed", type=int, default=42)
    _add_device(t)
    t.set_defaults(fn=_cmd_train)

    s = sub.add_parser("synth", help="generate a synthetic CACTI scene")
    s.add_argument("--out", required=True)
    s.add_argument("--textured", action="store_true",
                   help="overlay drifting gratings/rectangles (harder scene)")
    s.add_argument("--style", choices=["smooth", "textured", "leaves", "photo", "photos"],
                   default=None,
                   help="scene statistics; 'leaves' = dead-leaves occlusion "
                        "model (natural-image statistics with motion), "
                        "'photo' = real photograph under global camera pan, "
                        "'photos' = any bundled real photograph under a "
                        "pan+zoom+roll similarity camera path")
    s.add_argument("--photo-source", choices=["hopper", "street"], default=None,
                   help="which real photograph style='photo' pans over")
    s.add_argument("--size", type=int, default=512)
    s.add_argument("--frames", type=int, default=8)
    s.add_argument("--n-meas", type=int, default=1)
    s.add_argument("--seed", type=int, default=42)
    s.set_defaults(fn=_cmd_synth)

    e = sub.add_parser("eval", help="metrics report for a saved results .mat (stored "
                                    "summary + recomputed PSNR/SSIM with ground truth)")
    e.add_argument("results", help="results .mat written by reconstruct")
    e.add_argument("--data", default=None,
                   help="scene .mat with orig_bayer ground truth (optional; falls back "
                        "to the results' orig_real key)")
    e.set_defaults(fn=_cmd_eval)

    v = sub.add_parser("serve", help="reconstruction service: watch a directory for .mat "
                                     "measurements, reconstruct, write results")
    v.add_argument("--watch", required=True, help="directory to poll for .mat files")
    v.add_argument("--out", required=True, help="directory for result .mat files")
    v.add_argument("--denoiser", choices=["ffdnet", "fastdvd"], default="ffdnet")
    v.add_argument("--ckpt", default=None)
    v.add_argument("--random-init", action="store_true",
                   help="untrained weights, as for reconstruct")
    v.add_argument("--bf16", action="store_true")
    v.add_argument("--scene", default="Beauty",
                   help="per-scene schedule table to serve with (default Beauty)")
    v.add_argument("--no-update", action="store_true", help="disable online adaptation")
    v.add_argument("--carry-weights", action="store_true",
                   help="thread adapted denoiser weights across files")
    v.add_argument("--poll", type=float, default=2.0, help="poll interval in seconds")
    v.add_argument("--once", action="store_true",
                   help="process the current backlog and exit")
    _add_device(v)
    v.set_defaults(fn=_cmd_serve)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
