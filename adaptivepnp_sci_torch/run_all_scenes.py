"""Six-scene reproduction run: the reference's whole experiment, end to end
(port of ``scripts/run_all_scenes.py``).

The reference runs ``ADMM_TV_Warm_Start_save.py`` and then
``two_stage_ADMM_Online_FFD_Warm.py`` (or the FastDVD driver, each with
``deep_demosaicking`` on or off) over six mid-scale 512x512x8 colour Bayer
scenes (Beauty, Bosphorus, Jockey, Runner, ShakeNDry, Traffic), each with its
own hand-tuned sigma schedule, iterations and adaptation table. The real
``.mat`` captures are not shipped, so each scene gets a deterministic
synthetic stand-in (smooth, textured, dead-leaves or a real-photograph pan),
and each scene runs the reference's chain through the library surface of the
command line:

  GAP-TV warm start (40 iterations)
    -> the warm-start ``.mat`` contract (written and read back, as the two
       reference scripts hand off through ``results/savedmat/``)
    -> two-stage online-adaptive ADMM with the scene's table row
       (``configs/scenes.admm_config_for``)
    -> a results ``.mat`` with the reference's keys, and a Markdown table.

Modes (the reference's driver and toggle combinations):
  ffd         FFDNet + Malvar
  fastdvd     FastDVDnet (bf16), held-out guard
  ffd-dd      FFDNet with DDnet demosaicking (bf16)
  fastdvd-dd  FastDVDnet with DDnet demosaicking, held-out guard

Usage: python -m adaptivepnp_sci_torch.run_all_scenes [out_dir] [mode|all]
       [--device cuda|cpu] [--scenes Runner,...] [--float32]
       (defaults: results/scenes, ffd, cuda, all six scenes, bf16 U-Nets)

The table goes to ``{out_dir}/scenes_table.md``; the repository's
``SCENES.md`` is the JAX package's record and is never written here.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

# scene -> (style, seed): distinct deterministic statistics per stand-in,
# roughly echoing each capture (Beauty a face close-up: the portrait pan;
# Bosphorus and Traffic hard edges and repeated texture; Jockey and ShakeNDry
# chaotic natural content; Runner camera motion over real-world detail)
SCENE_STANDINS: dict[str, tuple[str, int]] = {
    "Beauty": ("photo", 101),
    "Bosphorus": ("textured", 202),
    "Jockey": ("leaves", 303),
    "Runner": ("photo", 404),
    "ShakeNDry": ("leaves", 505),
    "Traffic": ("textured", 606),
}

#: mode -> (denoiser, deep_demosaicking)
MODES: dict[str, tuple[str, bool]] = {
    "ffd": ("ffdnet", False),
    "fastdvd": ("fastdvd", False),
    "ffd-dd": ("ffdnet", True),
    "fastdvd-dd": ("fastdvd", True),
}

TABLE_NAME = "scenes_table.md"


def _make_scene_data(name: str, b: int, h: int, w: int, n_meas: int):
    from adaptivepnp_sci_torch.data.mat_io import SceneData
    from adaptivepnp_sci_torch.data.synthetic import make_scene

    style, seed = SCENE_STANDINS[name]
    syn = make_scene(b=b, h=h, w=w, seed=seed, n_meas=n_meas, style=style)
    # make_scene drops the T axis when n_meas == 1
    meas = syn.meas[..., None] if syn.meas.ndim == 2 else syn.meas
    orig_b = syn.orig_bayer[None] if syn.orig_bayer.ndim == 3 else syn.orig_bayer
    orig_rgb = syn.orig_rgb[None] if syn.orig_rgb.ndim == 4 else syn.orig_rgb
    return style, SceneData(
        name=name,
        meas=np.transpose(meas, (2, 0, 1)).astype(np.float32),
        mask=syn.mask,
        orig_bayer=orig_b.astype(np.float32),
        orig_real=(orig_rgb * 255.0).astype(np.float32),
    )


def _build_models(modes: list[str], random_init: bool, bf16: bool = True):
    """``({denoiser: (prior, variables)}, DDnet or None, its variables)`` for
    ``modes``, as the command line builds them: the default checkpoints
    (``weights/fastdvd.npz``, ``weights/ddnet.npz``; FFDNet's
    ``weights/ffdnet_color.pth``), or with ``random_init`` PyTorch's default
    initialisation under a fixed seed. FastDVDnet and DDnet in bf16, or in
    float32 when ``bf16`` is False."""
    from adaptivepnp_sci_torch.cli import REPO_WEIGHTS, _build_denoiser, _load_weights, _seeded_init
    from adaptivepnp_sci_torch.models import convert
    from adaptivepnp_sci_torch.models.ddnet import DDnet

    priors: dict[str, tuple] = {}
    for m in modes:
        d = MODES[m][0]
        if d not in priors:
            _, prior, variables = _build_denoiser(d, None, random_init=random_init,
                                                  bf16=bf16 and d == "fastdvd")
            priors[d] = (prior, variables)
    dd = dd_vars = None
    if any(MODES[m][1] for m in modes):
        # bf16 U-Nets: the JAX package measured the same PSNR/SSIM, 21 % faster
        dd = DDnet(dtype=torch.bfloat16 if bf16 else None)
        dd_vars = _load_weights(None, convert.load_ddnet, convert.ddnet_from_flax,
                                lambda: _seeded_init(DDnet, 1),
                                defaults=(str(REPO_WEIGHTS / "ddnet.npz"),),
                                random_init=random_init)
    return priors, dd, dd_vars


def guard_picks(out_dir: str, name: str, mode: str, b: int) -> list[int]:
    """Per measurement, the choice of one row read back from the files that
    :func:`main` wrote into ``out_dir``: 0 for the warm start, ``k + 1`` for
    iterate ``k`` (the iterate whose traced PSNR is the result's). ``b`` is
    the number of frames a measurement."""
    import scipy.io as sio

    res = sio.loadmat(os.path.join(out_dir, f"{name}8_online_{mode}.mat"))
    warm = sio.loadmat(os.path.join(out_dir, f"_Admm_tv_{name}8.mat"))["v_Admm_tv_denoise"]
    x, psnr, trace = res["v_recon_bayer"], res["psnr"], np.atleast_2d(res["psnr_all_iter"])
    return [0 if np.array_equal(x[..., b * t:b * (t + 1)], warm[..., b * t:b * (t + 1)])
            else 1 + int(np.argmin(np.abs(trace[t] - psnr[t].mean())))
            for t in range(psnr.shape[0])]


def main(out_dir: str = "results/scenes", mode: str = "ffd", b: int = 8,
         h: int = 512, w: int = 512, n_meas: int = 2,
         scenes: list[str] | None = None, random_init: bool = False,
         device: torch.device | str = "cuda", bf16: bool = True) -> list[tuple]:
    """Run the six-scene experiment for one mode (or ``mode='all'``) on
    ``device``, FastDVDnet and DDnet in float32 unless ``bf16``; returns one
    row per scene and mode: ``(scene, mode, style, sigma/255, iters, warm dB,
    final dB, SSIM, warm s/meas, recon s/meas)``, the times the least over
    the measurements."""
    from adaptivepnp_sci_torch.configs.scenes import admm_config_for
    from adaptivepnp_sci_torch.data.mat_io import load_warm_start, save_results, save_warm_start
    from adaptivepnp_sci_torch.pipelines import run_reconstruction, run_warm_start
    from adaptivepnp_sci_torch.solvers.priors import ddnet_demosaic

    if mode != "all" and mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {', '.join(MODES)} or all")
    os.makedirs(out_dir, exist_ok=True)
    modes = list(MODES) if mode == "all" else [mode]
    priors, dd, dd_vars = _build_models(modes, random_init, bf16)

    rows = []
    for name in SCENE_STANDINS:
        if scenes is not None and name not in scenes:
            continue
        style, scene = _make_scene_data(name, b, h, w, n_meas)

        warm = run_warm_start(scene, device=device)
        warm_s = min(warm.seconds_per_meas)
        warm_path = os.path.join(out_dir, f"_Admm_tv_{name}8.mat")
        save_warm_start(warm_path, warm.x_bayer)
        # read back through the .mat contract, as the FFD driver consumes stage 1
        x0 = load_warm_start(warm_path, scene.n_frames)

        for m in modes:
            denoiser, deep_dd = MODES[m]
            prior, variables = priors[denoiser]
            demosaic_fn = ddnet_demosaic(dd, dd_vars) if deep_dd else None
            # one config object for the run and the table's schedule columns
            cfg = admm_config_for(name, denoiser, deep_dd, True)
            out = run_reconstruction(
                scene, prior, variables, denoiser=denoiser, deep_demosaicking=deep_dd,
                warm_start=x0, config=cfg, demosaic_fn=demosaic_fn, device=device)
            save_results(
                os.path.join(out_dir, f"{name}8_online_{m}.mat"),
                out.x_bayer, out.x_rgb, out.psnr, out.ssim, out.psnr_all_iter,
                orig_real=scene.orig_real,
                meas_bayer=np.transpose(scene.meas, (1, 2, 0)) * scene.maxb,
            )
            rows.append(
                (name, m, style,
                 "/".join(f"{int(round(s * 255))}" for s in cfg.sigma),
                 "/".join(str(i) for i in cfg.iters),
                 float(warm.psnr.mean()), float(out.psnr.mean()),
                 float(out.ssim.mean()), warm_s, min(out.seconds_per_meas)))
            print(f"{name:10s} [{m:10s}|{style:8s}] "
                  f"warm {rows[-1][5]:.2f} dB -> final {rows[-1][6]:.2f} dB "
                  f"/ {rows[-1][7]:.4f} SSIM, {rows[-1][9]:.2f}s/meas", flush=True)

    where = torch.cuda.get_device_name(torch.device(device)) if str(device).startswith(
        "cuda") else "the CPU"
    lines = [
        "# Six-scene reproduction run (synthetic stand-ins), adaptivepnp_sci_torch",
        "",
        f"`python -m adaptivepnp_sci_torch.run_all_scenes`, {b}x{h}x{w}, {n_meas} "
        f"measurement(s) a scene, on {where}. Each scene's table row "
        "(`configs/scenes.py`); the refined weights carry across measurements "
        "(`reuse_model`). Times are the least over the measurements.",
        "",
        "| scene | mode | stand-in | sigma/255 | iters | warm dB | final dB |"
        " SSIM | warm s/meas | recon s/meas |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(f"| {r[0]} | {r[1]} | {r[2]} | {r[3]} | {r[4]} | {r[5]:.2f} "
                     f"| {r[6]:.2f} | {r[7]:.4f} | {r[8]:.3f} | {r[9]:.3f} |")
    lines.append("")
    with open(os.path.join(out_dir, TABLE_NAME), "w") as f:
        f.write("\n".join(lines))
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default="results/scenes")
    ap.add_argument("mode", nargs="?", default="ffd", choices=[*MODES, "all"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain versions of the kernels")
    ap.add_argument("--scenes", default=None,
                    help=f"comma-separated subset of {','.join(SCENE_STANDINS)}")
    ap.add_argument("--float32", action="store_true",
                    help="FastDVDnet and DDnet in float32 (default: bf16)")
    args = ap.parse_args()
    main(args.out_dir, args.mode, scenes=args.scenes and args.scenes.split(","),
         device=_check_device(args.device), bf16=not args.float32)
