"""Frames/s reconstructing a 512x512x8 colour-Bayer CACTI snapshot (port of
the JAX package's root ``bench.py``).

The flagship is the reference's headline configuration (two-stage ADMM with
online-adapted FFDNet, scene 'Beauty'): a 40-iteration GAP-TV warm start,
then the two-stage ADMM with FFDNet-color, Malvar demosaicking and online
adaptation (lr 2e-6, 2 Adam steps every 15 iterations), sigma (25, 12, 6)/255
x (15, 6, 4) iterations, all through ``reconstruct_single_dispatch`` on
``make_scene(b=8, h=512, w=512, seed=42)``. ``fixed`` drops the adaptation,
``warmstart`` runs the warm start and one TV step.

FFDNet's weights: a reference ``.pth`` (or a ``/``-keyed ``.npz``, or a
trainer ``.pt``) given by ``--ffdnet``; without one, the variables the JAX
``bench.py`` falls back to (Flax's initialisation from ``PRNGKey(0)``,
stored in ``weights/ffdnet_color_init0.npz`` beside this module).

``vs_baseline`` is against the north star: one snapshot in 10 s (0.8
frames/s) on one chip. The time is the least of 6 after one warm-up, each
call ended by a device synchronisation (``studies.timed``); TF32 is off.

Prints ONE JSON line with the keys of the JAX ``bench.py`` (``device`` is
the card's name, or ``cpu``); the flagship mode adds the dead-leaves scene's
PSNR and SSIM.

Usage: python -m adaptivepnp_sci_torch.bench [flagship|fixed|warmstart]
       [--device cuda|cpu] [--size 512] [--ffdnet PATH]
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from typing import Any

import torch

from adaptivepnp_sci_torch import studies
from adaptivepnp_sci_torch.solvers.two_stage_admm import ADMMConfig

#: Flax's initialisation of FFDNet-color from ``PRNGKey(0)`` (24 arrays,
#: 852 108 float32 values): the JAX ``bench.py``'s weights when no reference
#: ``.pth`` is present
INIT0 = Path(__file__).resolve().parent / "weights" / "ffdnet_color_init0.npz"
MODES = ("flagship", "fixed", "warmstart")
METRIC = ("frames/sec reconstructed at 512x512x8 Bayer "
          "(two-stage ADMM + FFDNet + online adaptation)")
#: the north star: 8 frames in 10 s per snapshot
BASELINE_FPS = 0.8


def bench_ffdnet_weights(path: str | None = None) -> dict[str, torch.Tensor]:
    """FFDNet-color's state dict: the weights at ``path`` (a reference
    ``.pth``, a ``/``-keyed ``.npz`` or a trainer ``.pt``) when it is given
    and exists, as the JAX ``bench.py`` takes the reference ``.pth`` when it
    is present; otherwise :data:`INIT0` (a warning names a path that is
    given but absent).

    :data:`INIT0` was written once, with JAX on the CPU, from the repository
    root by::

        python -c '
        import jax, jax.numpy as jnp, numpy as np
        from adaptivepnp_sci_tpu.models.ffdnet import ffdnet_color
        v = ffdnet_color().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.float32(0.1))
        np.savez("adaptivepnp_sci_torch/weights/ffdnet_color_init0.npz", **{
            "/".join(k.key for k in p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(v)[0]})
        '
    """
    from adaptivepnp_sci_torch.models.convert import ffdnet_from_flax, load_variables_npz

    if path is not None:
        if os.path.exists(path):
            return studies.load_ffdnet_weights(path)
        print(f"bench: {path} does not exist; FFDNet takes {INIT0.name}", file=sys.stderr)
    return ffdnet_from_flax(load_variables_npz(str(INIT0)))


def admm_config(mode: str) -> ADMMConfig:
    """The second stage of ``mode``: one TV step (``warmstart``), fixed
    FFDNet (``fixed``) or the adaptive flagship."""
    if mode == "warmstart":
        return ADMMConfig(sigma=(0.0,), iters=(1,), denoiser="tv")
    if mode == "fixed":
        return studies.flagship_config(adapt=None)
    if mode == "flagship":
        return studies.flagship_config()
    raise ValueError(f"unknown mode {mode!r}; one of {MODES}")


def reconstruct(scene: Any, config: ADMMConfig, prior, params: dict,
                device: torch.device | str):
    """The warm start, the solve and the metrics of ``scene`` in one call."""
    from adaptivepnp_sci_torch.solvers.end_to_end import reconstruct_single_dispatch

    y, phi, orig = studies.on_device(scene, device)
    return reconstruct_single_dispatch(y, phi, studies.WARM, config, prior, params,
                                       orig=orig, device=device)


def device_name(device: torch.device | str) -> str:
    return torch.cuda.get_device_name(device) if torch.device(device).type == "cuda" else "cpu"


def main(mode: str = "flagship", device: torch.device | str = "cuda", size: int = 512,
         ffdnet: str | None = None, n: int = 6) -> tuple[dict[str, Any], dict[str, Any]]:
    """Time ``mode`` and print its JSON line (rounded as the JAX ``bench.py``
    rounds it); returns the line's numbers unrounded and the results
    (``"smooth"``, and ``"leaves"`` in the flagship mode). ``ffdnet``: the
    path for :func:`bench_ffdnet_weights`."""
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color
    from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32

    b = 8
    config = admm_config(mode)
    params = bench_ffdnet_weights(ffdnet)
    prior = ffdnet_prior(ffdnet_color())
    scene = make_scene(b=b, h=size, w=size, seed=42)
    results: dict[str, Any] = {}

    def run():
        results["smooth"] = reconstruct(scene, config, prior, params, device)

    with full_f32():
        seconds = studies.timed(run, n, device)
        fps = b / seconds
        psnr, ssim = studies.mean_db(results["smooth"])
        # the smooth scene is an easy ~50 dB regime; the dead-leaves scene's
        # natural-image statistics keep the quality line honest
        extra = {}
        if mode == "flagship":
            nat = make_scene(b=b, h=size, w=size, seed=42, style="leaves")
            results["leaves"] = reconstruct(nat, config, prior, params, device)
            extra = dict(zip(("psnr_db_natural", "ssim_natural"),
                             studies.mean_db(results["leaves"])))
    line = {"metric": METRIC, "value": fps, "unit": "frames/s",
            "vs_baseline": fps / BASELINE_FPS, "seconds_per_snapshot": seconds,
            "psnr_db": psnr, "ssim": ssim, **extra, "device": device_name(device)}
    digits = {"value": 3, "vs_baseline": 3, "seconds_per_snapshot": 3, "psnr_db": 2,
              "ssim": 4, "psnr_db_natural": 2, "ssim_natural": 4}
    print(json.dumps({k: round(v, digits[k]) if k in digits else v for k, v in line.items()}),
          flush=True)
    return line, results


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__)
    ap.add_argument("mode", nargs="?", default="flagship", choices=MODES)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--ffdnet", default=None,
                    help="FFDNet-color weights: .pth, /-keyed .npz or trainer .pt "
                         f"(default: {INIT0.name})")
    args = ap.parse_args()
    main(args.mode, _check_device(args.device), args.size, args.ffdnet)
