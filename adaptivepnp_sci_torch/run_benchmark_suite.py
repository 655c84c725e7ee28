"""The benchmark suite's 12 rows on a synthetic 512x512x8 scene (port of
``scripts/run_benchmark_suite.py``), written as a Markdown table.

Rows, each as the JAX script configures it:
  1.  GAP-TV warm start (40 iterations)
  2.  two-stage ADMM + FFDNet-color, fixed weights
  3.  two-stage ADMM + FastDVDnet in bf16 (remat off) with
      ``weights/fastdvd_smooth.npz`` (``weights/fastdvd.npz`` without it),
      sigma (12, 6)/255 x (24, 12), adapting at lr 2e-7 every 12;
      3b. the same with ``denoiser_relax=(0.3, 1.0)``
  4.  the online-adaptive FFDNet flagship; 4b on the textured scene, 4c on
      dead leaves, 4d on dead leaves at lr 2e-5, 4e on the photograph scene
      (``make_scene(style="photo")``)
  5a. FFDNet + bf16 DDnet (``weights/ddnet.npz``) joint demosaicking, iters
      (6, 6, 4); 5c the same on dead leaves
  5b. 4 measurements batched (``two_stage_admm_batched``), their GAP-TV
      warm starts inside the timed region
  6.  ``two_stage_admm_tiled`` at 1024^2x8 in 512^2 tiles under the flagship
      configuration

FFDNet-color takes ``--ffdnet PATH`` (``.pth``, ``/``-keyed ``.npz`` or
trainer ``.pt``), by default ``weights/ffdnet_color_init0.npz`` (the JAX
``bench.py``'s fallback variables, :func:`adaptivepnp_sci_torch.bench.
bench_ffdnet_weights`). A time is the least of 2 calls after a warm-up (6
on the adaptive FastDVDnet rows), each ended by a device synchronisation;
rows 2 to 6 time their metrics with the solve, as the JAX script does. The
table goes to ``results/RESULTS_torch.md`` unless another path is given; the
hand-written sections below the table of an existing file are kept.

Usage: python -m adaptivepnp_sci_torch.run_benchmark_suite [OUT.md] [--size 512]
       [--device cuda|cpu] [--ffdnet PATH]

``--size`` sets the scene's side (row 6: twice it, in tiles of it).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
from pathlib import Path
from typing import Any, Callable

import torch

from adaptivepnp_sci_torch import studies
from adaptivepnp_sci_torch.solvers.two_stage_admm import ADMMConfig

OUT = "results/RESULTS_torch.md"
#: the batched row's measurements
N_BATCHED = 4
ROWS = ("1", "2", "3", "3b", "4", "4b", "4c", "4d", "4e", "5a", "5c", "5b", "6")
#: timed calls after the warm-up: the JAX script's n = 2, and 6 on the
#: adaptive FastDVDnet rows (their adaptation varies the most)
ROW_N = {k: 6 if k in ("3", "3b") else 2 for k in ROWS}
#: each row's scene: ``make_scene``'s arguments beside 8 frames of the
#: suite's side and seed 42 (``scale``: the side's multiple)
ROW_SCENES = {k: {} for k in ROWS} | {
    "4b": {"textured": True}, "4c": {"style": "leaves"}, "4d": {"style": "leaves"},
    "4e": {"style": "photo"}, "5c": {"style": "leaves"}, "5b": {"seed": 43, "n_meas": N_BATCHED},
    "6": {"scale": 2}}


#: each row's name in the table
ROW_NAMES = {
    "1": "1. GAP-TV warm start (40 it)",
    "2": "2. two-stage ADMM + FFDNet (fixed)",
    "3": "3. two-stage ADMM + FastDVDnet (smooth-variant wts, bf16)",
    "3b": "3b. + per-stage relax (0.3, 1.0) [extension]",
    "4": "4. online-adaptive FFDNet (flagship)",
    "4b": "4b. flagship on hard textured scene",
    "4c": "4c. flagship on dead-leaves (natural-statistics) scene",
    "4d": "4d. + tuned adaptation lr 2e-5 [extension]",
    "4e": "4e. flagship on real-photo scene (global pan)",
    "5a": "5a. FFDNet + DDnet joint demosaicking",
    "5c": "5c. DDnet joint demosaicking on dead-leaves",
    "5b": f"5b. batched x{N_BATCHED} throughput ({N_BATCHED * 8} frames)",
    "6": "6. tiled 1024²x8 adaptive (4x pixels, 512² tiles)",
}


def row_scene(key: str, size: int) -> dict[str, Any]:
    """``make_scene``'s arguments for row ``key`` at side ``size``."""
    kw = dict(ROW_SCENES[key])
    side = size * kw.pop("scale", 1)
    return {"b": 8, "h": side, "w": side, "seed": 42, **kw}


def suite_configs(cut: int | None = None, interval: int | None = None) -> dict[str, ADMMConfig]:
    """Each row's ``ADMMConfig`` (row 1 has none), as the JAX script writes
    them; ``cut`` shortens every stage to at most that many iterations and
    ``interval`` replaces the adaptation's interval (a cut schedule's
    triggers)."""
    flag = studies.flagship_config()
    fixed = studies.flagship_config(adapt=None)
    fd = studies.fastdvd_config()
    cfg = {"2": fixed, "3": fd, "3b": dataclasses.replace(fd, denoiser_relax=(0.3, 1.0)),
           "4": flag, "4d": studies.with_adapt(flag, lr=2e-5),
           "5a": ADMMConfig(sigma=studies.FLAGSHIP_SIGMA, iters=(6, 6, 4), denoiser="ffdnet",
                            demosaic_method="ddnet")}
    cfg.update({"4b": cfg["4"], "4c": cfg["4"], "4e": cfg["4"], "5c": cfg["5a"], "5b": fixed,
                "6": flag})
    for k, c in cfg.items():
        c = dataclasses.replace(c, iters=studies.cut_iters(c.iters, cut))
        if interval is not None and c.adapt is not None:
            c = studies.with_adapt(c, interval_iter=interval)
        cfg[k] = c
    return cfg


def timed_result(fn: Callable[[], Any], n: int, device: torch.device | str) -> tuple[float, Any]:
    """``(s/call, the last call's result)``: the least of ``n`` calls after a
    warm-up (``studies.timed``)."""
    out = {}

    def call():
        out["r"] = fn()

    t = studies.timed(call, n, device)
    return t, out["r"]


def fastdvd_weights() -> str:
    """The smooth-procedural FastDVDnet variant for the smooth benchmark
    scene, the shipped default without it."""
    smooth = studies.REPO_WEIGHTS / "fastdvd_smooth.npz"
    return str(smooth if smooth.exists() else studies.REPO_WEIGHTS / "fastdvd.npz")


def run_rows(size: int = 512, device: torch.device | str = "cuda",
             ffdnet: str | dict | None = None, cut: int | None = None,
             interval: int | None = None, n: int | None = None,
             rows: tuple[str, ...] = ROWS, model=None
             ) -> list[tuple[str, str, float, float, float, Any]]:
    """``(key, name, s/run, PSNR, SSIM, result)`` of each row in ``rows``
    (a row whose weight file is absent reads NaN, result None). ``n``
    replaces every row's timed calls (0: the warm-up alone); ``model``
    replaces FFDNet-color."""
    from adaptivepnp_sci_torch.bench import bench_ffdnet_weights
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.ddnet import DDnet
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color
    from adaptivepnp_sci_torch.solvers.end_to_end import reconstruct_single_dispatch
    from adaptivepnp_sci_torch.solvers.gap_tv import gap_tv
    from adaptivepnp_sci_torch.solvers.priors import (
        ddnet_demosaic,
        fastdvd_prior,
        ffdnet_prior,
    )
    from adaptivepnp_sci_torch.solvers.two_stage_admm import (
        two_stage_admm_batched,
        two_stage_admm_tiled,
    )
    from adaptivepnp_sci_torch.train.trainer import load_checkpoint_variables

    wcfg, cfg = studies.WARM, suite_configs(cut, interval)
    params = ffdnet if isinstance(ffdnet, dict) else bench_ffdnet_weights(ffdnet)
    prior = ffdnet_prior(ffdnet_color() if model is None else model)
    fastdvd, ddnet = fastdvd_weights(), str(studies.REPO_WEIGHTS / "ddnet.npz")
    scenes: dict[tuple, tuple] = {}

    def scene(key):  # rows on one scene share its tensors
        kw = tuple(row_scene(key, size).items())
        if kw not in scenes:
            scenes[kw] = studies.on_device(make_scene(**dict(kw)), device)
        return scenes[kw]

    def run_row(key, reps):
        y, phi, orig = scene(key)
        if key == "1":
            t = studies.timed(lambda: gap_tv(y, phi, wcfg, device=device), reps, device)
            return t, gap_tv(y, phi, wcfg, orig_bayer=orig, device=device)
        if key == "5b":
            y = y.permute(2, 0, 1)

            def run():
                x0 = torch.stack([gap_tv(y[i], phi, wcfg, device=device).x_bayer
                                  for i in range(N_BATCHED)])
                return two_stage_admm_batched(y, phi, cfg[key], prior, params, x0_batch=x0,
                                              orig_batch=orig, device=device)
        elif key == "6":
            def run():
                x0 = gap_tv(y, phi, wcfg, device=device).x_bayer
                return two_stage_admm_tiled(y, phi, cfg[key], tile=size, prior=prior,
                                            params=params, orig_bayer=orig, x0_bayer=x0,
                                            device=device)
        else:
            pr, p, kw = prior, params, {}
            if key in ("3", "3b"):
                pr = fastdvd_prior(FastDVDnet(dtype=torch.bfloat16, remat=False))
                p = load_checkpoint_variables(fastdvd)
            elif key in ("5a", "5c"):
                kw["demosaic_fn"] = ddnet_demosaic(DDnet(dtype=torch.bfloat16),
                                                   load_checkpoint_variables(ddnet))

            def run():
                return reconstruct_single_dispatch(y, phi, wcfg, cfg[key], pr, p, orig=orig,
                                                   device=device, **kw)
        return timed_result(run, reps, device)

    absent = {"3": fastdvd, "3b": fastdvd, "5a": ddnet, "5c": ddnet}
    out = []
    for key in rows:
        if key in absent and not os.path.exists(absent[key]):
            out.append((key, ROW_NAMES[key], float("nan"), float("nan"), float("nan"), None))
            continue
        t, res = run_row(key, ROW_N[key] if n is None else n)
        out.append((key, ROW_NAMES[key], t, *studies.mean_db(res), res))
    return out


def card_line(device: torch.device | str) -> str:
    """The device: the card's name and power limit as ``nvidia-smi`` prints
    them (its name alone without ``nvidia-smi``), or ``cpu``."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def table(rows: list[tuple], size: int, device: torch.device | str) -> str:
    lines = [
        f"# RESULTS (PyTorch port) — benchmark suite (synthetic {size}x{size}x8 Bayer scene)",
        "",
        f"Device: {card_line(device)}. Times are the least of N calls after a",
        f"warm-up (N={ROW_N['2']}, or {ROW_N['3']} on the adaptive FastDVDnet rows), each "
        "ended by a", "device synchronisation. North-star budget: 10 s/snapshot.",
        "",
        "| config | s/run | frames/s | PSNR (dB) | SSIM |",
        "|---|---|---|---|---|",
    ]
    for key, name, t, p, s, _ in rows:
        frames = N_BATCHED * 8 if key == "5b" else 8
        fps = frames / t if t == t and t > 0 else float("nan")
        lines.append(f"| {name} | {t:.3f} | {fps:.1f} | {p:.2f} | {s:.4f} |")
    return "\n".join(lines) + "\n"


def main(out_path: str = OUT, size: int = 512, device: torch.device | str = "cuda",
         ffdnet: str | None = None) -> list[tuple]:
    """Run every row, print the table and write it to ``out_path`` (the
    sections from its first ``## `` heading on kept). Returns the rows."""
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32

    with full_f32():
        rows = run_rows(size, device, ffdnet)
    text = table(rows, size, device)
    out = Path(out_path)
    if out.exists():
        old = out.read_text()
        idx = old.find("\n## ")
        if idx != -1:
            text += old[idx:]
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    print(text, flush=True)
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__)
    ap.add_argument("out", nargs="?", default=OUT)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--ffdnet", default=None,
                    help="FFDNet-color weights: .pth, /-keyed .npz or trainer .pt "
                         "(default: weights/ffdnet_color_init0.npz of the package)")
    args = ap.parse_args()
    main(args.out, args.size, _check_device(args.device), args.ffdnet)
