"""A/B DDnet's U-Net precision on the joint-demosaicking configuration
(port of ``scripts/ab_ddnet_precision.py``; 512x512x8).

``DDnet(dtype=torch.bfloat16)``: bf16 convolution chains with float32
residuals, upsample and branch mixing, float32 parameters, against float32
DDnet, on the FFDNet denoiser with the DDnet demosaicker (``weights/
ddnet.npz``), sigma (25, 12, 6)/255 x (6, 6, 4), fixed weights, on the
smooth scene (5a) and the dead-leaves scene (5c). Prints s/run (the least
of ``n`` after a warm-up), PSNR and SSIM.

Usage: python -m adaptivepnp_sci_torch.ab_ddnet_precision --ffdnet PATH [--size 512]
       [--device cuda|cpu]
"""

from __future__ import annotations

from typing import Any

import torch

from adaptivepnp_sci_torch import studies

ITERS = (6, 6, 4)
#: scene label -> make_scene keyword arguments
SCENES = {"5a smooth": {"seed": 42}, "5c leaves": {"seed": 42, "style": "leaves"}}
DTYPES = (("fp32", None), ("bf16", torch.bfloat16))


def ddnet_row(scene: Any, prior, params: dict, dd: torch.nn.Module, dd_params: dict, config,
              device: torch.device | str, n: int = 3) -> tuple[float, Any]:
    """``(s/run, result)`` of the warm start and the solve with the DDnet
    ``dd`` as the demosaicker."""
    from adaptivepnp_sci_torch.solvers.end_to_end import reconstruct_single_dispatch
    from adaptivepnp_sci_torch.solvers.priors import ddnet_demosaic

    y, phi, orig = studies.on_device(scene, device)
    dm = ddnet_demosaic(dd, dd_params)

    def run():
        return reconstruct_single_dispatch(y, phi, studies.WARM, config, prior, params,
                                           orig=orig, device=device, demosaic_fn=dm)

    t = studies.timed(run, n, device)
    return t, run()


def main(ffdnet: str | dict, size: int = 512, device: torch.device | str = "cuda",
         model=None, config=None, weights: str = str(studies.REPO_WEIGHTS / "ddnet.npz"),
         n: int = 3) -> list[tuple[str, str, float, float, float, Any]]:
    """Print the table; returns ``(scene, dtype, s/run, PSNR, SSIM,
    result)`` per row."""
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.ddnet import DDnet
    from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color
    from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior
    from adaptivepnp_sci_torch.train.trainer import load_checkpoint_variables

    prior = ffdnet_prior(ffdnet_color() if model is None else model)
    params = studies.load_ffdnet_weights(ffdnet)
    dd_params = load_checkpoint_variables(weights)
    config = (studies.flagship_config(adapt=None, iters=ITERS, demosaic_method="ddnet")
              if config is None else config)
    print("| scene | DDnet dtype | s/run | PSNR (dB) | SSIM |")
    print("|---|---|---|---|---|")
    rows = []
    for sname, kw in SCENES.items():
        scene = make_scene(b=8, h=size, w=size, **kw)
        for dname, dtype in DTYPES:
            t, r = ddnet_row(scene, prior, params, DDnet(dtype=dtype), dd_params, config,
                             device, n)
            p, s = studies.mean_db(r)
            print(f"| {sname} | {dname} | {t:.3f} | {p:.2f} | {s:.4f} |", flush=True)
            rows.append((sname, dname, t, p, s, r))
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__, ffdnet=True)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args()
    main(args.ffdnet, args.size, _check_device(args.device))
