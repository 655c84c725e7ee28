"""Attribute the FFDNet flagship's time to its parts (port of
``scripts/decompose_flagship_floor.py``; 512x512x8).

  A. denoiser alone: the 25 FFDNet applies of the flagship's sigma schedule
     on the (8, 512, 512, 3) cube, each fed the last one's output;
  B. the solver with an identity prior: the GAP-TV warm start (40 it.) and
     the whole two-stage ADMM (x-update, Malvar, theta and dual updates,
     the per-iteration PSNR trace) with the prior's apply replaced by
     identity;
  C. the fixed-weight floor (A inside B, no adaptation);
  D. the flagship (C and the online adaptation, lr 2e-6, 2 steps every 15
     iterations); D - C prices the adaptation's gradient steps.

Each part is an eager Python loop of launches on the card (the JAX script
timed one compiled ``lax.scan``), timed as the least of ``n`` after a
warm-up, each run ended by a device synchronisation. The work of one FFDNet
apply at 8x512x512x3: its FLOPs counted by
``torch.utils.flop_counter.FlopCounterMode`` (the convolutions, 2 per
multiply-add), its bytes worked out from the shapes (every convolution
reads its input and weights once and writes its output once, float32), to
place the per-apply time against the card's float32 rate and memory rate.

Usage: python -m adaptivepnp_sci_torch.decompose_flagship_floor --ffdnet PATH [--size 512]
       [--device cuda|cpu]
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import Tensor

from adaptivepnp_sci_torch import studies


def apply_cost(net: torch.nn.Module, x: Tensor, sigma: float) -> tuple[float, float]:
    """``(GFLOP, GB)`` of one ``net(x, sigma)``: the FLOPs that
    ``FlopCounterMode`` counts, and the bytes its convolutions must move
    (each input and weight read once, each output written once, at the
    activations' element size)."""
    from torch.utils.flop_counter import FlopCounterMode

    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    moved = []

    def count(mod, inp, out):
        moved.append((inp[0].numel() + out.numel()) * inp[0].element_size()
                     + sum(p.numel() * p.element_size() for p in mod.parameters()))

    hooks = [c.register_forward_hook(count) for c in convs]
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            net(x, torch.tensor(sigma, device=x.device))
    finally:
        for h in hooks:
            h.remove()
    return fc.get_total_flops() / 1e9, sum(moved) / 1e9


def draw_cube(shape: tuple[int, ...]) -> Tensor:
    """Part A's input, uniform on [0, 1) from a CPU generator seeded with 0:
    the one draw of this module."""
    return torch.rand(shape, generator=torch.Generator().manual_seed(0))


def denoise_loop(prior, net: torch.nn.Module, x: Tensor, sigmas: Tensor) -> Tensor:
    """The denoiser alone over ``sigmas``: each apply is fed the last one's
    output."""
    for s in sigmas:
        x = prior.apply(net, x, s)
    return x


def decompose(scene: Any, prior, params: dict, fixed, flagship=None,
              device: torch.device | str = "cuda", n: int = 6) -> dict[str, Any]:
    """Times (s) of A, B and C, and of D when ``flagship`` is given, with
    each part's output (``A_out``, ...)."""
    from adaptivepnp_sci_torch.adapt.online import make_schedule
    from adaptivepnp_sci_torch.solvers.end_to_end import reconstruct_single_dispatch
    from adaptivepnp_sci_torch.solvers.priors import working_copy
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32

    y, phi, _ = studies.on_device(scene, device)
    b, h, w = phi.shape
    net = working_copy(prior, params, device)
    x0 = draw_cube((b, h, w, 3)).to(device)
    sigmas = torch.as_tensor(make_schedule(fixed.sigma, fixed.iters, None)[0], device=device)
    out: dict[str, Any] = {"iters": int(np.sum(fixed.iters))}

    def part_a():
        with full_f32(), torch.no_grad():
            out["A_out"] = denoise_loop(prior, net, x0, sigmas)

    out["A"] = studies.timed(part_a, n, device)
    identity = prior._replace(apply=lambda net, x, s: x)
    parts = [("B", identity, fixed), ("C", prior, fixed)]
    if flagship is not None:
        parts.append(("D", prior, flagship))
    for key, pr, cfg in parts:
        def run(pr=pr, cfg=cfg, key=key):
            out[f"{key}_out"] = reconstruct_single_dispatch(y, phi, studies.WARM, cfg, pr,
                                                            params, device=device).x_bayer

        out[key] = studies.timed(run, n, device)
    return out


def main(ffdnet: str | dict, size: int = 512, device: torch.device | str = "cuda",
         model=None, fixed=None, flagship=None, n: int = 6) -> dict[str, Any]:
    """Print the decomposition; returns :func:`decompose`'s dict with the
    cost of one apply (``gflop``, ``gbytes``)."""
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color
    from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior, working_copy
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32

    scene = make_scene(b=8, h=size, w=size, seed=42)
    fixed = studies.flagship_config(adapt=None) if fixed is None else fixed
    flagship = studies.flagship_config() if flagship is None else flagship
    prior = ffdnet_prior(ffdnet_color() if model is None else model)
    params = studies.load_ffdnet_weights(ffdnet)
    with full_f32():
        gflop, gbytes = apply_cost(working_copy(prior, params, device),
                                   draw_cube((8, size, size, 3)).to(device), 12 / 255)
    d = decompose(scene, prior, params, fixed, flagship, device, n)
    d.update(gflop=gflop, gbytes=gbytes)
    it = d["iters"]
    print(f"one FFDNet apply (8x{size}x{size}x3): {gflop:.0f} GFLOP, {gbytes:.1f} GB moved "
          "(FlopCounterMode; bytes from the shapes)", flush=True)
    print(f"A. denoiser alone ({it} it): {d['A']:.3f} s ({1e3 * d['A'] / it:.1f} ms/it -> "
          f"{gflop * it / d['A'] / 1e3:.1f} TF/s, {gbytes * it / d['A']:.0f} GB/s)", flush=True)
    print(f"B. warm start + solver, identity prior: {d['B']:.3f} s", flush=True)
    print(f"C. fixed-weight floor (A inside B): {d['C']:.3f} s "
          f"(C-(A+B) = {d['C'] - d['A'] - d['B']:+.3f} s)", flush=True)
    print(f"D. flagship (C + adaptation): {d['D']:.3f} s "
          f"(adaptation increment D-C = {d['D'] - d['C']:+.3f} s)", flush=True)
    return d


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__, ffdnet=True)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args()
    main(args.ffdnet, args.size, _check_device(args.device))
