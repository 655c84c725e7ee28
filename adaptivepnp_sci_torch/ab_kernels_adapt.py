"""Whole-program A/B of the hand-written kernels and of the adaptation's
optimizer semantics (port of ``scripts/ab_pallas_adapt.py``; 512x512x8
synthetic scene).

A. The CUDA kernels (K1, the fused x-update; K2, the TV prox) against the
   plain PyTorch path on the same device (``use_kernels=False`` /
   ``True``), for the three configurations that reach them: GAP-TV (40
   iterations), ADMM with fixed-weight FFDNet, and the flagship with
   online adaptation. On the CPU only the plain column runs.
B. Carried Adam against the reference's fresh Adam per trigger
   (``AdaptConfig.fresh_opt_per_trigger``) on the flagship, and on the
   FastDVDnet row with ``weights/fastdvd.npz`` (float32, as the JAX script)
   when that file exists.

s/run is the least of ``n`` after a warm-up. The table goes to stdout, and
to ``--out PATH`` when it is given (never to a file of the repository by
default).

Usage: python -m adaptivepnp_sci_torch.ab_kernels_adapt --ffdnet PATH [--out PATH]
       [--size 512] [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from adaptivepnp_sci_torch import studies


def kernel_arms(device: torch.device | str) -> tuple[bool, ...]:
    """``use_kernels`` values A times: the plain path, and on the card the
    kernels."""
    return (False, True) if torch.device(device).type == "cuda" else (False,)


def gap_tv_row(scene: Any, device: torch.device | str, n: int = 2, iters: int = 40
               ) -> list[tuple[float, Any]]:
    """``(s/run, result)`` of GAP-TV for each of :func:`kernel_arms`."""
    from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, gap_tv

    y, phi, orig = studies.on_device(scene, device)
    out = []
    for use in kernel_arms(device):
        cfg = GapTVConfig(iters=iters, use_kernels=use)
        t = studies.timed(lambda: gap_tv(y, phi, cfg, device=device), n, device)
        out.append((t, gap_tv(y, phi, cfg, orig_bayer=orig, device=device)))
    return out


def admm_row(scene: Any, config, prior, params, device: torch.device | str, n: int = 2
             ) -> list[tuple[float, Any]]:
    """``(s/run, result)`` of the warm start and the two-stage solve for
    each of :func:`kernel_arms`, both stages switched together."""
    from adaptivepnp_sci_torch.solvers.end_to_end import reconstruct_single_dispatch

    y, phi, orig = studies.on_device(scene, device)
    out = []
    for use in kernel_arms(device):
        cfg = dataclasses.replace(config, use_kernels=use)
        wcfg = dataclasses.replace(studies.WARM, use_kernels=use)

        def run():
            return reconstruct_single_dispatch(y, phi, wcfg, cfg, prior, params, orig=orig,
                                               device=device)

        t = studies.timed(run, n, device)
        out.append((t, run()))
    return out


def adam_row(scene: Any, config, prior, params, device: torch.device | str, n: int = 2
             ) -> list[tuple[float, Any]]:
    """``(s/run, result)`` with the carried Adam, then with a fresh Adam per
    trigger."""
    from adaptivepnp_sci_torch.solvers.end_to_end import reconstruct_single_dispatch

    y, phi, orig = studies.on_device(scene, device)
    out = []
    for fresh in (False, True):
        cfg = studies.with_adapt(config, fresh_opt_per_trigger=fresh)

        def run():
            return reconstruct_single_dispatch(y, phi, studies.WARM, cfg, prior, params,
                                               orig=orig, device=device)

        t = studies.timed(run, n, device)
        out.append((t, run()))
    return out


def main(ffdnet: str | dict, out_path: str | None = None, size: int = 512,
         device: torch.device | str = "cuda", model=None, fixed=None, flagship=None,
         fastdvd=None, fastdvd_weights: str = str(studies.REPO_WEIGHTS / "fastdvd.npz"),
         n: int = 2) -> list[tuple[str, str, float, float, float, Any]]:
    """Print the two tables (and write them to ``out_path``); returns
    ``(config, arm, s/run, PSNR, SSIM, result)`` per run, ``arm`` one of ``plain``,
    ``kernels``, ``carried``, ``fresh``. ``ffdnet``: a weights file or a
    state dict for ``model`` (FFDNet-color by default); ``fixed``,
    ``flagship`` and ``fastdvd`` replace the three ``ADMMConfig`` (for a cut
    schedule)."""
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior, ffdnet_prior
    from adaptivepnp_sci_torch.train.trainer import load_checkpoint_variables

    scene = make_scene(b=8, h=size, w=size, seed=42)
    params = studies.load_ffdnet_weights(ffdnet)
    prior = ffdnet_prior(ffdnet_color() if model is None else model)
    fixed = studies.flagship_config(adapt=None) if fixed is None else fixed
    flagship = studies.flagship_config() if flagship is None else flagship
    where = "card" if torch.device(device).type == "cuda" else "CPU"
    rows = []

    def record(config, arms, names):
        for name, (t, r) in zip(names, arms):
            rows.append((config, name, t, *studies.mean_db(r), r))

    names = ("plain", "kernels")
    record("1. GAP-TV (40 it)", gap_tv_row(scene, device, n), names)
    record("2. ADMM+FFDNet fixed", admm_row(scene, fixed, prior, params, device, n), names)
    record("4. flagship adaptive", admm_row(scene, flagship, prior, params, device, n), names)
    names = ("carried", "fresh")
    record("flagship FFDNet", adam_row(scene, flagship, prior, params, device, n), names)
    if os.path.exists(fastdvd_weights):
        fcfg = studies.fastdvd_config() if fastdvd is None else fastdvd
        record("FastDVD", adam_row(scene, fcfg, fastdvd_prior(FastDVDnet()),
                                   load_checkpoint_variables(fastdvd_weights), device, n), names)

    lines = [f"# A/B results ({where}, {size}x{size}x8 synthetic scene)", "",
             "## CUDA kernels vs the plain PyTorch path", "",
             "| config | s/run (plain) | s/run (kernels) | PSNR plain | PSNR kernels |",
             "|---|---|---|---|---|"]
    for config in dict.fromkeys(r[0] for r in rows if r[1] in ("plain", "kernels")):
        arms = [r for r in rows if r[0] == config]
        ts = [f"{r[2]:.3f}" for r in arms] + ["n/a (CPU)"] * (2 - len(arms))
        ps = [f"{r[3]:.2f}" for r in arms] + ["n/a (CPU)"] * (2 - len(arms))
        lines.append(f"| {config} | {ts[0]} | {ts[1]} | {ps[0]} | {ps[1]} |")
    lines += ["", "## Adaptation optimizer semantics (carried vs fresh Adam)", "",
              "| config | s/run | PSNR (dB) | SSIM |", "|---|---|---|---|"]
    labels = {"carried": "carried (extension)", "fresh": "fresh-per-trigger (reference)"}
    for config, arm, t, p, s, _ in rows:
        if arm in labels:
            lines.append(f"| {config}, {labels[arm]} | {t:.3f} | {p:.2f} | {s:.4f} |")
    text = "\n".join(lines) + "\n"
    if out_path is not None:
        with open(out_path, "w") as f:
            f.write(text)
    print(text, flush=True)
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__, ffdnet=True)
    ap.add_argument("--out", help="also write the tables here")
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args()
    main(args.ffdnet, args.out, args.size, _check_device(args.device))
