"""Attribute the FastDVDnet row's 36-iteration fixed-weight solver floor
(port of ``scripts/decompose_fastdvd_floor.py``; 512x512x8, FastDVDnet in
bf16 with the fused conv-pair kernel, ``weights/fastdvd.npz``):

  A. denoiser alone: 36 FastDVDnet applies of the row's sigma schedule on a
     (8, 512, 512, 3) cube, each fed the last one's output, the float32 <->
     bf16 casts included;
  B. the solver with an identity prior: the warm start and the whole
     two-stage ADMM (x-update, Malvar, theta and dual updates, the PSNR
     trace) with the prior's apply replaced by identity;
  C. the real floor (A inside B).

If C ~= A + B the program is additive and the larger term names the target;
if C >> A + B, something is lost where the solver's float32 meets the
denoiser's bf16. Each part is an eager loop of launches on the card (the
JAX script timed one compiled ``lax.scan``), the least of ``n`` after a
warm-up, each run ended by a device synchronisation
(:func:`adaptivepnp_sci_torch.decompose_flagship_floor.decompose`).

Usage: python -m adaptivepnp_sci_torch.decompose_fastdvd_floor [--size 512]
       [--device cuda|cpu]
"""

from __future__ import annotations

from typing import Any

import torch

from adaptivepnp_sci_torch import studies


def main(size: int = 512, device: torch.device | str = "cuda", config=None,
         weights: str = str(studies.REPO_WEIGHTS / "fastdvd.npz"), n: int = 6
         ) -> dict[str, Any]:
    """Print the decomposition; returns
    :func:`~adaptivepnp_sci_torch.decompose_flagship_floor.decompose`'s dict.
    ``config`` replaces the row's fixed-weight ``ADMMConfig``."""
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.decompose_flagship_floor import decompose
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior
    from adaptivepnp_sci_torch.train.trainer import load_checkpoint_variables

    scene = make_scene(b=8, h=size, w=size, seed=42)
    config = studies.fastdvd_config(adapt=None) if config is None else config
    prior = fastdvd_prior(FastDVDnet(dtype=torch.bfloat16, remat=False))
    d = decompose(scene, prior, load_checkpoint_variables(weights), config, None, device, n)
    it = d["iters"]
    print(f"A. denoiser-only loop ({it} it): {d['A']:.3f} s "
          f"({1e3 * d['A'] / it:.1f} ms/it)", flush=True)
    print(f"B. solver floor, identity prior:   {d['B']:.3f} s "
          f"({1e3 * d['B'] / it:.1f} ms/it)", flush=True)
    print(f"C. real floor (A inside B):        {d['C']:.3f} s "
          f"({1e3 * d['C'] / it:.1f} ms/it)", flush=True)
    print(f"A+B = {d['A'] + d['B']:.3f} s; composition overhead "
          f"C-(A+B) = {d['C'] - d['A'] - d['B']:+.3f} s", flush=True)
    return d


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args()
    main(args.size, _check_device(args.device))
