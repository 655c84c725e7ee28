"""Batched throughput over 1, 2, 4, 8 and 16 measurements on one card (port
of ``scripts/bench_batched.py``): how far batching snapshots goes, and where
the card's memory ends it.

Each batch is ``make_scene(b=8, 512, 512, seed=43, n_meas=t)`` under the
fixed-weight FFDNet configuration (sigma (25, 12, 6)/255 x (15, 6, 4)): a
40-iteration GAP-TV warm start of each measurement (a loop over them, where
the JAX script maps ``gap_tv`` with ``vmap``), then one
``two_stage_admm_batched`` solve with those warm starts, both inside the
timed region. A time is the least of 4 calls after a warm-up, each ended by
a device synchronisation. A batch that exhausts the card's memory is
printed as ``FAILED`` and ends the sweep; any other error is raised.

FFDNet-color takes ``--ffdnet PATH`` (``.pth``, ``/``-keyed ``.npz`` or
trainer ``.pt``), by default ``weights/ffdnet_color_init0.npz`` (the JAX
``bench.py``'s fallback variables).

Usage: python -m adaptivepnp_sci_torch.bench_batched [--size 512] [--device cuda|cpu]
       [--ffdnet PATH] [--batches 1,2,4,8,16]
"""

from __future__ import annotations

from typing import Any

import torch

from adaptivepnp_sci_torch import studies

BATCHES = (1, 2, 4, 8, 16)


def batch_run(scene: Any, prior, params: dict, config, device: torch.device | str):
    """``() -> result`` of one batch: the warm starts, then the batched
    solve (no metrics)."""
    from adaptivepnp_sci_torch.solvers.gap_tv import gap_tv
    from adaptivepnp_sci_torch.solvers.two_stage_admm import two_stage_admm_batched

    y, phi, _ = studies.on_device(scene, device)
    y = (y[..., None] if y.dim() == 2 else y).permute(2, 0, 1)

    def run():
        x0 = torch.stack([gap_tv(yy, phi, studies.WARM, device=device).x_bayer for yy in y])
        return two_stage_admm_batched(y, phi, config, prior, params, x0_batch=x0,
                                      device=device)

    return run


def main(ffdnet: str | dict | None = None, batches: tuple[int, ...] = BATCHES, size: int = 512,
         device: torch.device | str = "cuda", config=None, n: int = 4, model=None
         ) -> list[tuple[int, Any, float | None, float | None, int | None, Any]]:
    """Print one line per batch; returns ``(t, s/run or the error, frames/s,
    PSNR, peak bytes on the card, x_bayer)`` per batch (None where it ran
    out of memory)."""
    from adaptivepnp_sci_torch.bench import bench_ffdnet_weights
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color
    from adaptivepnp_sci_torch.ops import metrics
    from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32

    b = 8
    params = ffdnet if isinstance(ffdnet, dict) else bench_ffdnet_weights(ffdnet)
    prior = ffdnet_prior(ffdnet_color() if model is None else model)
    config = studies.flagship_config(adapt=None) if config is None else config
    cuda = torch.device(device).type == "cuda"
    rows = []
    for t in batches:
        scene = make_scene(b=b, h=size, w=size, seed=43, n_meas=t)
        orig = torch.as_tensor(scene.orig_bayer).reshape(t, b, size, size)
        run = batch_run(scene, prior, params, config, device)
        out = {}

        def call():
            out["x"] = run().x_bayer

        try:
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            with full_f32():
                dt = studies.timed(call, n, device)
        except torch.cuda.OutOfMemoryError as e:  # the card's answer is the result
            msg = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
            print(f"batch {t:2d}: FAILED ({msg})", flush=True)
            rows.append((t, msg, None, None, None, None))
            out.clear()
            torch.cuda.empty_cache()
            break
        x = out["x"]
        psnr = float(torch.stack([metrics.psnr_per_frame(x[i], orig[i].to(x.device))
                                  for i in range(t)]).mean())
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        mem = f", peak {peak / 1e9:.2f} GB" if cuda else ""
        print(f"batch {t:2d}: {dt:6.3f} s -> {t * b / dt:6.1f} frames/s, "
              f"PSNR {psnr:.2f} dB{mem}", flush=True)
        rows.append((t, dt, t * b / dt, psnr, peak, x))
    return rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--ffdnet", default=None,
                    help="FFDNet-color weights: .pth, /-keyed .npz or trainer .pt "
                         "(default: weights/ffdnet_color_init0.npz of the package)")
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    args = ap.parse_args()
    main(args.ffdnet, tuple(int(t) for t in args.batches.split(",")), args.size,
         _check_device(args.device))
