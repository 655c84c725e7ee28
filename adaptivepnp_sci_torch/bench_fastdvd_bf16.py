"""FastDVDnet in bf16 with float32 residuals against float32 on the row's
adaptive configuration (port of ``scripts/bench_fastdvd_bf16.py``;
512x512x8, ``weights/fastdvd.npz``, adaptation on).

``FastDVDnet(dtype=None)`` against ``FastDVDnet(dtype=torch.bfloat16)``
(the bf16 conv pairs on the fused kernel on the card); prints s/run (the
least of ``n`` after a warm-up), PSNR and SSIM for both.

Usage: python -m adaptivepnp_sci_torch.bench_fastdvd_bf16 [--size 512] [--device cuda|cpu]
"""

from __future__ import annotations

from typing import Any

import torch

from adaptivepnp_sci_torch import studies

#: name -> FastDVDnet's dtype
MODES = (("fp32", None), ("bf16+fp32res", torch.bfloat16))


def fastdvd_row(scene: Any, model: torch.nn.Module, params: dict, config,
                device: torch.device | str, n: int = 2) -> tuple[float, Any]:
    """``(s/run, result)`` of the warm start and the two-stage solve with
    the FastDVDnet ``model``."""
    from adaptivepnp_sci_torch.solvers.end_to_end import reconstruct_single_dispatch
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior

    y, phi, orig = studies.on_device(scene, device)
    prior = fastdvd_prior(model)

    def run():
        return reconstruct_single_dispatch(y, phi, studies.WARM, config, prior, params,
                                           orig=orig, device=device)

    t = studies.timed(run, n, device)
    return t, run()


def main(size: int = 512, device: torch.device | str = "cuda", config=None,
         weights: str = str(studies.REPO_WEIGHTS / "fastdvd.npz"), n: int = 2
         ) -> list[tuple[str, float, float, float, Any]]:
    """Print one line per mode; returns ``(mode, s/run, PSNR, SSIM,
    result)``."""
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.train.trainer import load_checkpoint_variables

    scene = make_scene(b=8, h=size, w=size, seed=42)
    params = load_checkpoint_variables(weights)
    config = studies.fastdvd_config() if config is None else config
    rows = []
    for name, dtype in MODES:
        t, r = fastdvd_row(scene, FastDVDnet(dtype=dtype), params, config, device, n)
        p, s = studies.mean_db(r)
        print(f"{name:14s}: {t:.3f} s/run  PSNR {p:.2f} dB  SSIM {s:.4f}", flush=True)
        rows.append((name, t, p, s, r))
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args()
    main(args.size, _check_device(args.device))
