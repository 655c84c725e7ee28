"""A/B FFDNet's convolution precision on the flagship adaptive configuration
(512x512x8; port of ``scripts/ab_ffdnet_precision.py``).

Modes: fp32 (the flagship's), mixed (bf16 interior convolutions, float32
endpoint convolutions: ``FFDNet(interior_dtype=torch.bfloat16)``) and bf16
(everything reduced: ``FFDNet(dtype=torch.bfloat16)``). On the card the bf16
convolutions run on the tensor cores through cuDNN, the float32 ones with
TF32 off. One state dict serves all three modes: the type is a cast at apply
time. Prints s/run (the least of ``n`` after a warm-up), PSNR and SSIM.

Usage: python -m adaptivepnp_sci_torch.ab_ffdnet_precision --ffdnet PATH [--size 512]
       [--device cuda|cpu]
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from adaptivepnp_sci_torch import studies
from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color

#: mode -> the FFDNet keyword arguments that select it
MODES: dict[str, dict[str, torch.dtype]] = {
    "fp32": {},
    "mixed": {"interior_dtype": torch.bfloat16},
    "bf16": {"dtype": torch.bfloat16},
}


def precision_row(scene: Any, model: torch.nn.Module, params: dict, config,
                  device: torch.device | str, n: int = 2) -> tuple[float, Any]:
    """``(s/run, result)`` of the warm start and the two-stage solve
    (``config``) of ``scene`` with the FFDNet ``model`` holding ``params``."""
    from adaptivepnp_sci_torch.solvers.end_to_end import reconstruct_single_dispatch
    from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior

    y, phi, orig = studies.on_device(scene, device)
    prior = ffdnet_prior(model)

    def run():
        return reconstruct_single_dispatch(y, phi, studies.WARM, config, prior, params,
                                           orig=orig, device=device)

    t = studies.timed(run, n, device)
    return t, run()


def main(ffdnet: str | dict, size: int = 512, device: torch.device | str = "cuda",
         config=None, build: Callable[..., torch.nn.Module] = ffdnet_color, n: int = 2
         ) -> list[tuple[str, float, float, float]]:
    """Print the table; returns ``(mode, s/run, PSNR, SSIM)`` per mode.
    ``ffdnet``: a weights file or a state dict; ``config`` defaults to the
    flagship's; ``build(**mode_kw)`` makes the model."""
    from adaptivepnp_sci_torch.data.synthetic import make_scene

    scene = make_scene(b=8, h=size, w=size, seed=42)
    params = studies.load_ffdnet_weights(ffdnet)
    config = studies.flagship_config() if config is None else config
    print("| mode | s/run | PSNR (dB) | SSIM |")
    print("|---|---|---|---|")
    rows = []
    for name, kw in MODES.items():
        t, r = precision_row(scene, build(**kw), params, config, device, n)
        p, s = studies.mean_db(r)
        print(f"| {name} | {t:.3f} | {p:.2f} | {s:.4f} |", flush=True)
        rows.append((name, t, p, s))
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__, ffdnet=True)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args()
    main(args.ffdnet, args.size, _check_device(args.device))
