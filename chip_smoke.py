#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``adaptivepnp_sci_torch``) on one
NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases build,k1,k2

It builds the CUDA kernels from ``adaptivepnp_sci_torch/csrc/``, holds each
against its plain PyTorch version on the card (both designs of the TV and
conv-pair kernels, timed side by side), holds the kernel paths
against the plain paths on the CPU end to end, and drives three 512x512x8
reconstructions: the flagship (GAP-TV warm start, two-stage ADMM with
FFDNet-color nc = 96, nb = 12 and online adaptation, random weights made
from a seed), the FastDVDnet prior path (trained weights from
``weights/fastdvd.npz``, in float32 and in bf16 with the fused conv-pair
kernel) and the deep-demosaicking row of the scene table (DDnet from
``weights/ddnet.npz`` and FastDVDnet, both in bf16, with the held-out
``select_best`` guard; also once with the demosaicker adapted in the loop).
Then the multi-measurement drivers: each held against its CPU plain path at
small size (``drivers_parity``: tiled, sequence, batched, and ``gap_deep``,
Menon 2007 and the gray solver), a 2048x2048x8 scene cut into 512 tiles
under the bf16 FastDVDnet row with its adaptation shared over the tiles
(``tiled``), and the FFDNet flagship over two measurements with a carried
Adam state (``sequence``).
Each phase prints one JSON line; any failure exits nonzero. The last line is
``{"ok": true, "device": {...}}``. It exits 1 without printing a result when
no CUDA device is present, and fails when the package is not beside it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PHASES = ("device", "build", "k1", "k2", "k3", "slice_parity", "flagship",
          "fastdvd_parity", "fastdvd", "ddnet_parity", "ddnet", "drivers_parity", "tiled",
          "sequence", "kernels")

#: NVIDIA H100 SXM data-sheet peaks: HBM3 bandwidth, non-tensor fp32 rate and
#: dense bf16 rate of the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
#: flops per pixel per iteration of the TV kernel: divergence 4, out 1,
#: d^2 2, gradient 2, norm 4 (with sqrt), coef 2, dual update 6, norm sum 1
TV_FLOPS_PER_PIXEL_ITER = 22
#: the flagship's launches per reconstruction: 40 GAP + 25 ADMM x-updates,
#: 40 TV proxes (one per warm-start iteration)
FLAGSHIP_LAUNCHES = {"x_update": 65, "tv_chambolle": 40, "convpair": 0}

SIGMA = (25 / 255, 12 / 255, 6 / 255)
ITERS = (15, 6, 4)

#: the FastDVDnet path: the Bosphorus row of the scene table (sigma (12, 6)/255,
#: 24 + 12 iterations, adaptation at k = 12 and 24: 2 Adam steps at lr 2e-7)
FASTDVD_SIGMA = (12 / 255, 6 / 255)
FASTDVD_ITERS = (24, 12)
FASTDVD_ADAPT = dict(lr=2e-7, update_per_iter=2, interval_iter=12, initial_iter=1)
#: its launches per reconstruction: 40 GAP + 36 ADMM x-updates, 40 TV proxes,
#: and in bf16 the 8 CvBlocks of each of the 36 no-grad denoiser calls
FASTDVD_LAUNCHES = {
    "fp32": {"x_update": 76, "tv_chambolle": 40, "convpair": 0},
    "bf16": {"x_update": 76, "tv_chambolle": 40, "convpair": 288},
}
#: the conv pair's two shapes on that path, (C, H, W) of the activation with
#: N = 8: half and quarter resolution, 4 CvBlocks per denoiser call each
CONVPAIR_MAIN_SHAPES = {"c64_256": (64, 256, 256), "c128_128": (128, 128, 128)}
#: Parity of the kernel path on the card with the plain path on the CPU at
#: 64x64x8: (iterations, launches, bar on per-frame PSNR in dB, bar on x_bayer,
#: what of x_bayer the bar holds). Float32 differs by summation order only.
#: In bf16 two routes round sums at different places (2e-3 on one denoiser
#: call), and this prior's loop amplifies any such difference once sigma drops
#: to 6/255 at k = 12: every pair of bf16 routes (kernel, library on the card,
#: CPU), and bf16 against float32 on the CPU alone, is 6e-3 apart in the worst
#: pixel (1.2e-3 rms) after 12 iterations, 0.1 after 14 and 0.15-0.25 (0.010-
#: 0.017 rms) after all 36. So bf16 is held tightly over the 12 iterations of
#: the first stage, and by rms over the whole schedule with its two triggers.
FASTDVD_PARITY = {
    "fp32": [(FASTDVD_ITERS, FASTDVD_LAUNCHES["fp32"], 0.05, 1e-3, "max")],
    "bf16": [((12, 0), {"x_update": 52, "tv_chambolle": 40, "convpair": 96}, 0.15, 2e-2, "max"),
             (FASTDVD_ITERS, FASTDVD_LAUNCHES["bf16"], 1.0, 3e-2, "rms")],
}


#: the deep-demosaicking path: ``admm_config_for("Bosphorus", "fastdvd",
#: deep_demosaicking=True)``, sigma (8, 6)/255 x (24, 12) iterations, one
#: trigger at k = 25 (2 Adam steps, lr 2e-7), rho 0.55, the held-out guard at
#: 0.05. Its launches per reconstruction: 40 warm-start + 36 ADMM + 40 masked
#: GAP-TV (the guard's candidate 0) x-updates, 40 + 40 TV proxes, and the 8
#: CvBlocks of each of the 36 no-grad bf16 FastDVDnet calls; DDnet (C = 40,
#: 80) and the trigger's forward launch no conv pair
DDNET_LAUNCHES = {"x_update": 116, "tv_chambolle": 80, "convpair": 288}
#: the parity run of that row at 64x64x8 in float32: schedule (6, 4), the
#: trigger at k = 5; 40 + 10 + 40 x-updates, 40 + 40 TV proxes
DDNET_PARITY_ITERS = (6, 4)
DDNET_PARITY_LAUNCHES = {"x_update": 90, "tv_chambolle": 80, "convpair": 0}
#: the pipeline's defaults for the in-scan demosaicker adaptation
DM_UPDATE = dict(lr=1e-6, update_per_iter=1)

#: the large-scene path: a 2048x2048x8 scene, its 40-iteration GAP-TV warm
#: start at full size (32 packed planes of 1024^2), then 16 tiles of 512 in 8
#: sequential groups of 2 under the bf16 FastDVDnet path's schedule, the
#: adaptation (k = 12 and 24) shared over each group's tiles and carried from
#: group to group. Launches: 40 + 8 x 36 x-updates (one launch per iteration
#: covers a group), 40 TV proxes, and 8 conv pairs per denoiser call of each
#: tile, 16 x 36 x 8
TILED = dict(size=2048, tile=512, tile_chunk=2)
TILED_LAUNCHES = {2: {"x_update": 40 + 8 * 36, "tv_chambolle": 40, "convpair": 16 * 36 * 8},
                  4: {"x_update": 40 + 4 * 36, "tv_chambolle": 40, "convpair": 16 * 36 * 8}}
#: the sequence path: the FFDNet flagship over T = 2 measurements of one
#: scene, the weights and one Adam carried; both GAP-TV warm starts counted
SEQUENCE_LAUNCHES = {"x_update": 2 * 40 + 2 * 25, "tv_chambolle": 2 * 40, "convpair": 0}
#: card-vs-CPU parity of the drivers: float32, bar on per-frame PSNR (dB) and
#: on max |dx|, the same select_best pick on both sides
DRIVERS_PARITY_BAR = (0.05, 1e-3)


class SmokeFailure(RuntimeError):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def flax_style_ffdnet_params(nc: int, nb: int, seed: int) -> dict:
    """FFDNet-color weights in Flax's default scheme, as numpy: LeCun fan-in
    truncated-normal kernels (kh, kw, I, O) and zero biases, in Flax's
    ``params/conv_{i}/{kernel,bias}`` layout."""
    rng = np.random.default_rng(seed)
    chans = [13] + [nc] * (nb - 1) + [12]
    params = {}
    for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        shape = (3, 3, cin, cout)
        z = rng.standard_normal(shape)
        while np.any(bad := np.abs(z) > 2.0):
            z[bad] = rng.standard_normal(int(bad.sum()))
        std = np.sqrt(1.0 / (9 * cin)) / 0.87962566103423978  # truncation correction
        params[f"conv_{i}"] = {"kernel": (z * std).astype(np.float32),
                               "bias": np.zeros(cout, np.float32)}
    return {"params": params}


def flagship_breakdown(torch, sc, prior, params) -> dict:
    """Device time of the flagship's parts, each alone at the flagship's
    shapes (CUDA events, median): the whole warm start, one FFDNet forward,
    one Malvar demosaic, one adaptation trigger; and what TF32 would change
    in one FFDNet forward."""
    from adaptivepnp_sci_torch.ab_convpair import time_ms
    from adaptivepnp_sci_torch.adapt.online import AdaptConfig, make_adapt_fn
    from adaptivepnp_sci_torch.ops import bayer, demosaic
    from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, gap_tv
    from adaptivepnp_sci_torch.solvers.priors import working_copy
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32

    dev = torch.device("cuda")
    y = torch.from_numpy(sc.meas).to(dev)
    phi = torch.from_numpy(sc.mask).to(dev)
    orig = torch.from_numpy(sc.orig_bayer).to(dev)
    rgb = torch.from_numpy(sc.orig_rgb).to(dev)
    sigma = torch.tensor(25 / 255, device=dev)
    net = working_copy(prior, params, dev)
    adapt = make_adapt_fn(prior, AdaptConfig(lr=2e-6, update_per_iter=2))
    y_p, phi_p = bayer.pack(y), bayer.pack(phi)
    with full_f32(), torch.no_grad():
        out = {
            "warm_start_40_ms": time_ms(
                lambda: gap_tv(y, phi, GapTVConfig(iters=40), device=dev), n=3),
            "ffdnet_forward_ms": time_ms(lambda: net(rgb, sigma), n=5),
            "malvar_ms": time_ms(lambda: demosaic.malvar2004(orig), n=5),
            "adapt_trigger_ms": time_ms(
                lambda: adapt(net, rgb, sigma, y_p, phi_p, y, phi), n=3),
        }
        ref = net(rgb, sigma)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            out["ffdnet_forward_tf32_ms"] = time_ms(lambda: net(rgb, sigma), n=5)
            out["ffdnet_tf32_max_abs_delta"] = float((net(rgb, sigma) - ref).abs().max())
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return out


def fastdvd_breakdown(torch, sc, params, dtype, remat: bool) -> dict:
    """Device time of the FastDVDnet path's parts in one mode, each alone at
    512x512x8 (CUDA events, median): one no-grad denoiser call, one
    adaptation trigger (2 Adam steps), and the trigger's peak memory."""
    from adaptivepnp_sci_torch import AdaptConfig, FastDVDnet, fastdvd_prior
    from adaptivepnp_sci_torch.ab_convpair import time_ms
    from adaptivepnp_sci_torch.adapt.online import make_adapt_fn
    from adaptivepnp_sci_torch.ops import bayer
    from adaptivepnp_sci_torch.solvers.priors import working_copy
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32

    dev = torch.device("cuda")
    y = torch.from_numpy(sc.meas).to(dev)
    phi = torch.from_numpy(sc.mask).to(dev)
    rgb = torch.from_numpy(sc.orig_rgb).to(dev)
    sigma = torch.tensor(12 / 255, device=dev)
    prior = fastdvd_prior(FastDVDnet(dtype=dtype, remat=remat))
    net = working_copy(prior, params, dev)
    adapt = make_adapt_fn(prior, AdaptConfig(**FASTDVD_ADAPT))
    gen = torch.Generator(device=dev).manual_seed(0)
    y_p, phi_p = bayer.pack(y), bayer.pack(phi)
    with full_f32(), torch.no_grad():
        out = {"denoiser_forward_ms": time_ms(lambda: prior.apply(net, rgb, sigma), n=5)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out["adapt_trigger_ms"] = time_ms(
            lambda: adapt(net, rgb, sigma, y_p, phi_p, y, phi, gen), n=3)
        out["adapt_trigger_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return out


def ddnet_breakdown(torch, sc, ddnet_params, row) -> dict:
    """Device time of the deep-demosaicking row's own parts at 512x512x8
    (CUDA events, median): one bf16 DDnet demosaic call (and one in float32),
    and the guard's masked 40-iteration GAP-TV."""
    from adaptivepnp_sci_torch import DDnet, ddnet_demosaic
    from adaptivepnp_sci_torch.ab_convpair import time_ms
    from adaptivepnp_sci_torch.ops import bayer, physics
    from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, _gap_tv_packed
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32, holdout_mask

    dev = torch.device("cuda")
    mosaic = torch.from_numpy(sc.orig_bayer).to(dev)
    y = torch.from_numpy(sc.meas).to(dev)
    phi = torch.from_numpy(sc.mask).to(dev)
    keep = 1.0 - holdout_mask(row.select_best_seed, row.select_best_holdout, tuple(y.shape), dev)
    y_p, phi_p = bayer.pack(y * keep), bayer.pack(phi * keep[None])
    dm16 = ddnet_demosaic(DDnet(dtype=torch.bfloat16), ddnet_params)
    dm32 = ddnet_demosaic(DDnet(), ddnet_params)
    with full_f32(), torch.no_grad():
        return {
            "ddnet_bf16_ms": time_ms(lambda: dm16(mosaic), n=5),
            "ddnet_fp32_ms": time_ms(lambda: dm32(mosaic), n=5),
            "masked_gap_tv_40_ms": time_ms(lambda: _gap_tv_packed(
                y_p, phi_p, physics.adjoint(y_p, phi_p), None,
                GapTVConfig(iters=row.select_best_warm_iters)), n=3),
        }


def guard_pick(res) -> dict:
    """The guard's chosen candidate (0 = the warm start, k + 1 = iterate k)
    and the gap from its ranking statistic to the next best."""
    r = res.resid_trace.cpu()
    order = r.sort(stable=True).indices
    return {"pick": int(order[0]), "resid_best": float(r[order[0]]),
            "resid_gap_to_second": float(r[order[1]] - r[order[0]])}


def flagship_profile(torch, run, trace: str | None) -> dict:
    """One reconstruction under ``torch.profiler``: device busy time (the sum
    of device self time; one stream, so nothing overlaps), the wall time,
    the idle share, and the kernels that take the most device time. With
    ``trace``, the Chrome trace is written there."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace:
        Path(trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(trace)

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies); the host ops that launched
    # them carry the same time again
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:10]
    # every design of a kernel: x_update_kernel, tv_chambolle[_cluster]_kernel,
    # convpair[_wgmma]_kernel
    ours = {name: sum(dev_us(e) for e in events
                      if name in e.key and "_kernel" in e.key) / 1e3
            for name in ("x_update", "tv_chambolle", "convpair")}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms if events else "not measured",
            "idle_share": 1 - busy_ms / wall_ms if events else "not measured",
            "port_kernels_ms": ours,
            "top_device": [{"name": e.key[:80], "count": e.count, "ms": dev_us(e) / 1e3}
                           for e in top]}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--trace", help="write the flagship's profiler trace (Chrome JSON) here")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    unknown = phases - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    needed = {"k1", "k2", "k3", "flagship", "fastdvd", "ddnet", "tiled", "sequence"}
    if "kernels" in phases and not needed <= phases:
        ap.error(f"the kernels phase needs the {', '.join(sorted(needed))} phases")
    from adaptivepnp_sci_torch import (
        ADMMConfig,
        AdaptConfig,
        DDnet,
        FastDVDnet,
        GapDeepConfig,
        GapTVConfig,
        GrayConfig,
        admm_config_for,
        ddnet_demosaic,
        fastdvd_prior,
        ffdnet_prior,
        gap_deep,
        gap_denoise_gray,
        gap_tv,
        make_dm_spec,
        reconstruct_single_dispatch,
        two_stage_admm,
        two_stage_admm_batched,
        two_stage_admm_sequence,
        two_stage_admm_tiled,
    )
    from adaptivepnp_sci_torch.ab_convpair import library_pair, make_inputs, time_ms
    from adaptivepnp_sci_torch.adapt.online import make_schedule
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.convert import (
        ddnet_from_flax,
        fastdvdnet_from_flax,
        ffdnet_from_flax,
        load_variables_npz,
    )
    from adaptivepnp_sci_torch.models.ffdnet import FFDNet
    from adaptivepnp_sci_torch.ops import bayer, cuda_kernels, physics, tv
    from adaptivepnp_sci_torch.ops import convpair as convpair_ops

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    card = {"nvidia_smi": smi}
    emit("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    build_s = cuda_kernels.build()
    ptxas = {name: [ln.strip()[:200] for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for name, log in cuda_kernels.build_log.items()}
    emit("build", seconds=build_s, ptxas=ptxas)

    flush = torch.zeros(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    report: dict[str, dict] = {}

    # ------------------------------------------------------------------ k1
    if "k1" in phases:
        g = torch.Generator().manual_seed(0)
        nb, h2, w2 = 8, 256, 256
        theta = torch.rand(nb, 4, h2, w2, generator=g).to(dev)
        bd = ((torch.rand(nb, 4, h2, w2, generator=g) - 0.5) * 0.2).to(dev)
        phi = (torch.rand(nb, 4, h2, w2, generator=g) > 0.5).float().to(dev)
        y = (torch.rand(nb, 4, h2, w2, generator=g).to(dev) * phi).sum(0)
        phis = physics.phi_sum(phi)
        cases = {
            "admm": (lambda: cuda_kernels.admm_x_update(theta, bd, y, phi, phis, 1.0, 1.0),
                     lambda: physics.admm_x_update(theta, bd, y, phi, phis, 1.0, 1.0)),
            "gap": (lambda: cuda_kernels.gap_x_update(theta, bd, y, phi, phis, 1.0, 0.01),
                    lambda: physics.gap_x_update(theta, bd, y, phi, phis, 1.0, 0.01)),
            "gap_lam0.5": (lambda: cuda_kernels.gap_x_update(theta, bd, y, phi, phis, 0.5, 0.01),
                           lambda: physics.gap_x_update(theta, bd, y, phi, phis, 0.5, 0.01)),
        }
        # the item axis at the tiled path's group shape: 2 tiles of 512^2,
        # each with its own masks, in one launch; and 2 items under one mask
        thetas = torch.rand(2, nb, 4, h2, w2, generator=g).to(dev)
        bds = ((torch.rand(2, nb, 4, h2, w2, generator=g) - 0.5) * 0.2).to(dev)
        phis_i = (torch.rand(2, nb, 4, h2, w2, generator=g) > 0.5).float().to(dev)
        ys = (torch.rand(2, nb, 4, h2, w2, generator=g).to(dev) * phis_i).sum(1)
        psum_i = physics.phi_sum(phis_i, physics.PACKED_FRAME_AXIS)
        ys_shared = (thetas * phi).sum(1)
        item_cases = {
            "admm_items2": (
                lambda: cuda_kernels.admm_x_update(thetas, bds, ys, phis_i, psum_i, 0.55, 1.0),
                lambda: physics.admm_x_update(thetas, bds, ys, phis_i, psum_i, 0.55, 1.0)),
            "gap_items2_shared_phi": (
                lambda: cuda_kernels.gap_x_update(thetas, bds, ys_shared, phi, phis, 0.5, 0.01),
                lambda: physics.gap_x_update(thetas, bds, ys_shared, phi, phis, 0.5, 0.01)),
        }
        cases.update(item_cases)
        byts = (4 * theta.numel() + 2 * y.numel()) * 4
        bound_ms = byts / HBM_BYTES_PER_S * 1e3
        byts_items = (4 * thetas.numel() + 2 * ys.numel()) * 4
        per = {}
        for name, (kern, plain) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            rel = float((diff / want.abs().clamp_min(1e-30)).max())
            ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6))
            require(bool(torch.isfinite(got).all()), f"k1 {name}: non-finite output")
            require(ok, f"k1 {name}: kernel disagrees with plain (max abs {float(diff.max())})")
            per[name] = {"max_abs": float(diff.max()), "max_rel": rel,
                         "ms": time_ms(kern, flush=flush),
                         "warm_l2_ms": time_ms(kern),
                         "plain_ms": time_ms(plain, flush=flush)}
        # one item-axis launch against one launch per item
        one_by_one = [cuda_kernels.admm_x_update(thetas[i], bds[i], ys[i], phis_i[i], psum_i[i],
                                                 0.55, 1.0) for i in range(2)]
        require(bool(torch.equal(torch.stack(one_by_one), item_cases["admm_items2"][0]())),
                "k1: the item-axis launch differs from one launch per item")
        emit("k1", shape=[nb, 4, h2, w2], items_shape=[2, nb, 4, h2, w2],
             tolerance="rtol 1e-5, atol 1e-6", cases=per, bytes=byts, bound_us=bound_ms * 1e3,
             items_bytes=byts_items, items_bound_us=byts_items / HBM_BYTES_PER_S * 1e6,
             bound_basis="bytes / 3.35 TB/s (H100 SXM HBM3 data sheet)", **card)
        report["x_update"] = {
            "max_abs_err": max(c["max_abs"] for c in per.values()),
            "ms": per["gap"]["ms"], "plain_ms": per["gap"]["plain_ms"],
            "bound_ms": bound_ms, "bound_by": "bytes",
            "items2_ms": per["admm_items2"]["ms"], "items2_plain_ms": per["admm_items2"]["plain_ms"],
            "items2_bound_ms": byts_items / HBM_BYTES_PER_S * 1e3}

    # ------------------------------------------------------------------ k2
    if "k2" in phases:
        golden = np.load(ROOT / "tests" / "goldens" / "tv_chambolle_golden.npz")
        got = cuda_kernels.tv_chambolle_fused(torch.from_numpy(golden["cube"]).to(dev), 0.1)
        golden_err = float(np.abs(got.cpu().numpy() - golden["out"]).max())
        require(golden_err <= 1e-5, f"k2: golden max abs err {golden_err} > 1e-5")

        g = torch.Generator().manual_seed(1)
        rand = torch.rand(32, 256, 256, generator=g).to(dev)
        # realistic inputs: the 40 TV-prox inputs of a plain-path GAP-TV warm
        # start on the flagship's smooth scene
        sc = make_scene(b=8, h=512, w=512, seed=42)
        y_p = bayer.pack(torch.from_numpy(sc.meas).to(dev))
        phi_p = bayer.pack(torch.from_numpy(sc.mask).to(dev))
        phi_s = physics.phi_sum(phi_p)
        x0 = physics.adjoint(y_p, phi_p)
        theta_w, b_w = x0, torch.zeros_like(x0)
        inputs = [rand]
        for _ in range(40):
            x = physics.gap_x_update(theta_w, b_w, y_p, phi_p, phi_s, 1.0, 0.01)
            xb = x - b_w
            inputs.append(xb.reshape(32, 256, 256).contiguous())
            theta_w = torch.clamp(tv.tv_chambolle_multichannel(xb, 0.1, max_iter=5), 0, 1)
            b_w = b_w - (x - theta_w)
        design, cluster, strip_h = cuda_kernels.tv_plan(256, 256)
        require(design == "cluster", f"k2: 256 x 256 planes planned as {design}")
        err, flips, planes, iters_hist = 0.0, 0, 0, {}
        for inp in inputs:
            k_out, k_it = cuda_kernels.tv_chambolle_planes_cuda(inp, 0.1, 2e-4, 5)
            p_out, p_it = tv.tv_chambolle_planes(inp, 0.1, 2e-4, 5)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(k_out).all()), "k2: non-finite output")
            flips += int((k_it != p_it).sum())
            planes += inp.shape[0]
            for v in k_it.tolist():
                iters_hist[v] = iters_hist.get(v, 0) + 1
            err = max(err, float((k_out - p_out).abs().max()))
            require(bool(torch.allclose(k_out, p_out, rtol=1e-5, atol=1e-6)),
                    f"k2: kernel disagrees with plain (max abs {err})")
        require(flips == 0, f"k2: {flips} of {planes} stop decisions differ from the plain version")
        real = inputs[1]
        # the one-block-per-plane design on the same planes, and on planes that
        # only it takes; the cluster design twice on one input (no atomics)
        large = torch.rand(2, 512, 512, generator=g).to(dev)
        require(cuda_kernels.tv_plan(512, 512)[0] == "block", "k2: 512 x 512 not planned as block")
        others = {}
        for name, inp, kw in (("block_rand", rand, dict(design="block")),
                              ("block_real", real, dict(design="block")),
                              ("large_plane_512", large, {})):
            k_out, k_it = cuda_kernels.tv_chambolle_planes_cuda(inp, 0.1, 2e-4, 5, **kw)
            p_out, p_it = tv.tv_chambolle_planes(inp, 0.1, 2e-4, 5)
            others[name] = float((k_out - p_out).abs().max())
            require(bool(torch.allclose(k_out, p_out, rtol=1e-5, atol=1e-6))
                    and bool(torch.equal(k_it, p_it)), f"k2 {name}: disagrees with plain")
        # the drivers' plane shapes: the 32 packed planes of a 2048^2 warm
        # start (1024^2, the block design), and the 64 planes of a group of two
        # 512 tiles with 32 px of overlap (288^2, a cluster of 8 strips of 36)
        driver_shapes = {}
        for name, shape, want_plan in (("warm_start_1024", (32, 1024, 1024), ("block", 1, 1024)),
                                       ("window_288", (64, 288, 288), ("cluster", 8, 36))):
            require(cuda_kernels.tv_plan(*shape[1:]) == want_plan,
                    f"k2 {name}: planned {cuda_kernels.tv_plan(*shape[1:])}")
            noise = torch.rand(*shape, generator=g)
            inp = torch.nn.functional.avg_pool2d(noise[None], 5, 1, 2)[0].contiguous().to(dev)
            k_out, k_it = cuda_kernels.tv_chambolle_planes_cuda(inp, 0.1, 2e-4, 5)
            p_out, p_it = tv.tv_chambolle_planes(inp, 0.1, 2e-4, 5)
            torch.cuda.synchronize()
            d_err = float((k_out - p_out).abs().max())
            require(bool(torch.allclose(k_out, p_out, rtol=1e-5, atol=1e-6))
                    and bool(torch.equal(k_it, p_it)), f"k2 {name}: disagrees with plain ({d_err})")
            n_it = int(k_it.sum())
            d_byts = 2 * inp.numel() * 4
            d_flops = n_it * shape[1] * shape[2] * TV_FLOPS_PER_PIXEL_ITER
            driver_shapes[name] = {
                "shape": list(shape), "plan": list(want_plan), "max_abs": d_err,
                "plane_iterations": n_it,
                "ms": time_ms(lambda: cuda_kernels.tv_chambolle_fused(inp, 0.1), flush=flush),
                "plain_ms": time_ms(lambda: tv.tv_chambolle_multichannel(inp, 0.1), n=5,
                                    flush=flush),
                "bound_us": max(d_byts / HBM_BYTES_PER_S, d_flops / FP32_FLOPS) * 1e6}
            others[name] = d_err
        again = [cuda_kernels.tv_chambolle_planes_cuda(real, 0.1, 2e-4, 5)[0] for _ in range(2)]
        require(bool(torch.equal(*again)), "k2: two calls on one input differ")
        sms_used = cuda_kernels.tv_sms_used(*real.shape)
        require(sms_used > 32, f"k2: the cluster design ran on {sms_used} SMs")
        _, it_real = cuda_kernels.tv_chambolle_planes_cuda(real, 0.1, 2e-4, 5)
        n_iter = int(it_real.sum())
        byts = 2 * real.numel() * 4
        flops = n_iter * 256 * 256 * TV_FLOPS_PER_PIXEL_ITER
        bound_ms = max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3

        def run_new():
            return cuda_kernels.tv_chambolle_fused(real, 0.1)

        def run_old():
            return cuda_kernels.tv_chambolle_planes_cuda(real, 0.1, design="block")

        # new, old, old, new within one run on one card
        cold = [time_ms(f, flush=flush) for f in (run_new, run_old, run_old, run_new)]
        ms, previous_ms = min(cold[0], cold[3]), min(cold[1], cold[2])
        warm_ms, previous_warm_ms = time_ms(run_new), time_ms(run_old)
        require(ms < previous_ms, f"k2: cluster design {ms} ms, block design {previous_ms} ms")
        plain_ms = time_ms(lambda: tv.tv_chambolle_multichannel(real, 0.1), n=10,
                           flush=flush)
        emit("k2", shape=[32, 256, 256], tolerance="rtol 1e-5, atol 1e-6",
             design=design, cluster_size=cluster, strip_rows=strip_h,
             golden_max_abs=golden_err, max_abs=err, planes_compared=planes,
             stop_iteration_flips=flips, kernel_iterations_histogram=iters_hist,
             other_checks_max_abs=others, repeated_call_identical=True,
             timed_input="first warm-start TV input", timed_plane_iterations=n_iter,
             ms=ms, warm_l2_ms=warm_ms, previous_design="block", previous_ms=previous_ms,
             previous_warm_l2_ms=previous_warm_ms, cold_runs_new_old_old_new=cold,
             plain_ms=plain_ms, bytes=byts, flops=flops, bound_us=bound_ms * 1e3,
             bound_basis="max(bytes / 3.35 TB/s, flops / 67 TFLOP/s fp32)",
             sms_used=sms_used, driver_shapes=driver_shapes, **card)
        report["tv_chambolle"] = {"max_abs_err": max(err, *others.values()), "ms": ms,
                                  "previous_ms": previous_ms,
                                  "ms_1024": driver_shapes["warm_start_1024"]["ms"],
                                  "ms_288": driver_shapes["window_288"]["ms"],
                                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "bound_by": "bytes" if byts / HBM_BYTES_PER_S
                                  >= flops / FP32_FLOPS else "operations"}

    # ------------------------------------------------------------------ k3
    fastdvd_params = fastdvdnet_from_flax(
        load_variables_npz(str(ROOT / "weights" / "fastdvd.npz")))
    if "k3" in phases:
        trained = FastDVDnet()
        trained.load_state_dict(fastdvd_params)
        trained.to(dev)

        def trained_case(block, hw):
            """A CvBlock of the trained model, folded, on a random input."""
            conv0, bn0, _, conv1, bn1, _ = block.convblock
            with torch.no_grad():
                folded = [t.contiguous() for t in (
                    conv0.weight.bfloat16().permute(2, 3, 1, 0), *convpair_ops.fold_bn(bn0),
                    conv1.weight.bfloat16().permute(2, 3, 1, 0), *convpair_ops.fold_bn(bn1))]
            return (make_inputs(8, hw, hw, conv0.in_channels, dev, seed=1)[0], *folded)

        cases = {
            "c64_256": make_inputs(8, 256, 256, 64, dev),
            "c32_512": make_inputs(8, 512, 512, 32, dev),
            "c128_128": make_inputs(8, 128, 128, 128, dev),
            "c32_odd_2x70x94": make_inputs(2, 70, 94, 32, dev),
            "c64_256_trained_downc0": trained_case(trained.temp1.downc0.convblock[3], 256),
            "c128_128_trained_upc2": trained_case(trained.temp2.upc2.convblock[0], 128),
        }
        per = {}
        for name, pair in cases.items():
            n, h, w, c = pair[0].shape
            want = convpair_ops.convpair(*pair)
            scale = float(want.float().abs().max()) or 1.0
            designs = [cuda_kernels.CONVPAIR_DESIGN[c]]
            designs += [d for d, (_, _, chans) in cuda_kernels.CONVPAIR_DESIGNS.items()
                        if c in chans and d not in designs]
            errs = {}
            for d in designs:  # the default design first, then the kept earlier one
                got = cuda_kernels.convpair(*pair, design=d)
                torch.cuda.synchronize()
                require(bool(torch.isfinite(got.float()).all()),
                        f"k3 {name} {d}: non-finite output")
                errs[d] = float((got.float() - want.float()).abs().max())
                require(errs[d] / scale < 2e-2,
                        f"k3 {name} {d}: rel err {errs[d] / scale} >= 2e-2")
            err = errs[designs[0]]
            flops = 2 * 2 * 9 * c * c * n * h * w
            byts = 2 * pair[0].numel() * 2 + 2 * 9 * c * c * 2 + 4 * c * 4
            per[name] = {"shape": [n, h, w, c], "design": designs[0], "max_abs": err,
                         "max_abs_ref": scale, "rel_err": err / scale,
                         "rel_err_by_design": {d: e / scale for d, e in errs.items()},
                         "flops": flops, "bytes": byts,
                         "bound_us": max(flops / BF16_FLOPS, byts / HBM_BYTES_PER_S) * 1e6,
                         "bound_by": "operations" if flops / BF16_FLOPS
                         >= byts / HBM_BYTES_PER_S else "bytes"}
            if "trained" in name or "odd" in name:
                continue
            lib = library_pair(*pair)

            def run_new():
                return cuda_kernels.convpair(*pair)

            def run_old():
                return cuda_kernels.convpair(*pair, design="mma")

            # new, old, old, new within one run on one card
            cold = [time_ms(f, flush=flush) for f in (run_new, run_old, run_old, run_new)]
            per[name].update(
                ms=min(cold[0], cold[3]), previous_design="mma",
                previous_ms=min(cold[1], cold[2]), cold_runs_new_old_old_new=cold,
                warm_l2_ms=time_ms(run_new), previous_warm_l2_ms=time_ms(run_old),
                plain_ms=time_ms(lambda: convpair_ops.convpair(*pair), n=10, flush=flush),
                library_ms=time_ms(lib, n=10, flush=flush))
            per[name]["tflops"] = flops / (per[name]["ms"] * 1e-3) / 1e12
            if name in CONVPAIR_MAIN_SHAPES:
                require(per[name]["ms"] <= per[name]["previous_ms"],
                        f"k3 {name}: {per[name]['ms']} ms, earlier design "
                        f"{per[name]['previous_ms']} ms")
        emit("k3", tolerance="max abs err / max abs reference < 2e-2", cases=per,
             bound_basis="max(flops / 989 TFLOP/s bf16 dense, bytes / 3.35 TB/s)",
             library="two channels-last bf16 F.conv2d with folded scale and bias, ReLU in place",
             **card)
        for name in CONVPAIR_MAIN_SHAPES:
            case = per[name]
            report[f"convpair_{name}"] = {
                "max_abs_err": max(c["max_abs"] for c in per.values()
                                   if c["shape"][3] == case["shape"][3]),
                "ms": case["ms"], "previous_ms": case["previous_ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_us"] / 1e3,
                "bound_by": case["bound_by"], "library_ms": case["library_ms"]}
        del cases, trained

    def run_flagship(scene, prior, params, device, warm_iters=40):
        return reconstruct_single_dispatch(
            scene.meas, scene.mask, GapTVConfig(iters=warm_iters),
            ADMMConfig(sigma=SIGMA, iters=ITERS,
                       adapt=AdaptConfig(lr=2e-6, update_per_iter=2, interval_iter=15,
                                         initial_iter=1)),
            prior, params, orig=scene.orig_bayer, device=device)

    # -------------------------------------------------------- slice parity
    if "slice_parity" in phases:
        sc = make_scene(b=8, h=64, w=64, seed=42)
        params = ffdnet_from_flax(flax_style_ffdnet_params(16, 4, seed=0))
        prior = ffdnet_prior(FFDNet(nc=16, nb=4))
        cpu = run_flagship(sc, prior, params, "cpu")
        cuda_kernels.reset_launches()
        gpu = run_flagship(sc, prior, params, "cuda")
        torch.cuda.synchronize()
        counts = dict(cuda_kernels.launches)
        require(counts == FLAGSHIP_LAUNCHES, f"slice_parity: launches {counts}")
        dpsnr = float((gpu.psnr_per_frame.cpu() - cpu.psnr_per_frame).abs().max())
        dx = float((gpu.x_bayer.cpu() - cpu.x_bayer).abs().max())
        require(bool(torch.isfinite(gpu.x_bayer).all()), "slice_parity: non-finite")
        require(dpsnr <= 0.05 and dx <= 1e-3,
                f"slice_parity: dPSNR {dpsnr} dB, max |dx| {dx}")
        emit("slice_parity", shape=[8, 64, 64], ffdnet={"nc": 16, "nb": 4},
             max_dpsnr_db=dpsnr, max_abs_dx_bayer=dx, bar="0.05 dB, 1e-3",
             psnr_cuda=gpu.psnr_per_frame.mean().item(),
             psnr_cpu=cpu.psnr_per_frame.mean().item(), launches=counts)

    # ------------------------------------------------------------ flagship
    if "flagship" in phases:
        params = ffdnet_from_flax(flax_style_ffdnet_params(96, 12, seed=0))
        prior = ffdnet_prior(FFDNet(nc=96, nb=12))
        for style in ("smooth", "leaves"):
            sc = make_scene(b=8, h=512, w=512, seed=42, style=style)
            secs = []
            for rep in range(4):  # one warm-up, then three timed
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                cuda_kernels.reset_launches()
                t0 = time.perf_counter()
                res = run_flagship(sc, prior, params, "cuda")
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                counts = dict(cuda_kernels.launches)
                require(counts == FLAGSHIP_LAUNCHES, f"flagship {style}: launches {counts}")
                report.setdefault("launches", counts)  # the first main-path run
                if rep:
                    secs.append(dt)
            peak = torch.cuda.max_memory_allocated()
            require(tuple(res.x_bayer.shape) == (8, 512, 512)
                    and tuple(res.x_rgb.shape) == (8, 512, 512, 3), "flagship: shapes")
            require(bool(torch.isfinite(res.x_bayer).all() & torch.isfinite(res.x_rgb).all()),
                    "flagship: non-finite output")
            med = statistics.median(secs)
            emit("flagship", scene=style, shape=[8, 512, 512], ffdnet={"nc": 96, "nb": 12},
                 weights="random, Flax default init from numpy seed 0",
                 seconds_per_snapshot=med, seconds_runs=secs, frames_per_s=8 / med,
                 psnr_db=res.psnr_per_frame.mean().item(),
                 ssim=res.ssim_per_frame.mean().item(),
                 peak_mem_bytes=peak, launches_per_reconstruction=counts, **card)
            if style == "smooth":
                emit("flagship_breakdown", **flagship_breakdown(torch, sc, prior, params),
                     **card)
                cuda_kernels.reset_launches()
                emit("flagship_profile",
                     **flagship_profile(torch, lambda: run_flagship(sc, prior, params, "cuda"),
                                        args.trace),
                     **card)
                counts = dict(cuda_kernels.launches)
                require(counts == FLAGSHIP_LAUNCHES, f"flagship profile: launches {counts}")

    def run_fastdvd(scene, prior, device, generator=None, params=fastdvd_params,
                    iters=FASTDVD_ITERS):
        return reconstruct_single_dispatch(
            scene.meas, scene.mask, GapTVConfig(iters=40),
            ADMMConfig(sigma=FASTDVD_SIGMA, iters=iters, denoiser="fastdvd",
                       adapt=AdaptConfig(**FASTDVD_ADAPT)),
            prior, params, orig=scene.orig_bayer, device=device, generator=generator)

    modes = {"fp32": dict(dtype=None, remat=True), "bf16": dict(dtype=torch.bfloat16, remat=False)}

    # ------------------------------------------------------ fastdvd parity
    if "fastdvd_parity" in phases:
        sc = make_scene(b=8, h=64, w=64, seed=42)
        for mode, kw in modes.items():
            prior = fastdvd_prior(FastDVDnet(**kw))
            for iters, want_counts, db_bar, dx_bar, dx_kind in FASTDVD_PARITY[mode]:
                # one CPU generator per run: the same adaptation noise on both devices
                cpu = run_fastdvd(sc, prior, "cpu", torch.Generator().manual_seed(0), iters=iters)
                cuda_kernels.reset_launches()
                gpu = run_fastdvd(sc, prior, "cuda", torch.Generator().manual_seed(0),
                                  iters=iters)
                torch.cuda.synchronize()
                counts = dict(cuda_kernels.launches)
                require(counts == want_counts, f"fastdvd_parity {mode} {iters}: launches {counts}")
                require(bool(torch.isfinite(gpu.x_bayer).all()),
                        f"fastdvd_parity {mode} {iters}: non-finite")
                dpsnr = float((gpu.psnr_per_frame.cpu() - cpu.psnr_per_frame).abs().max())
                delta = gpu.x_bayer.cpu() - cpu.x_bayer
                dx = {"max": float(delta.abs().max()), "rms": float(delta.square().mean().sqrt())}
                require(dpsnr <= db_bar and dx[dx_kind] <= dx_bar,
                        f"fastdvd_parity {mode} {iters}: dPSNR {dpsnr} dB, |dx| {dx}")
                emit("fastdvd_parity", mode=mode, shape=[8, 64, 64], iters=list(iters),
                     weights="weights/fastdvd.npz", max_dpsnr_db=dpsnr,
                     max_abs_dx_bayer=dx["max"], rms_dx_bayer=dx["rms"],
                     bar=f"{db_bar} dB, {dx_kind} |dx| {dx_bar}",
                     psnr_cuda=gpu.psnr_per_frame.mean().item(),
                     psnr_cpu=cpu.psnr_per_frame.mean().item(), launches=counts)

    # ------------------------------------------------------------- fastdvd
    if "fastdvd" in phases:
        for style in ("smooth", "leaves"):
            sc = make_scene(b=8, h=512, w=512, seed=42, style=style)
            warm = gap_tv(sc.meas, sc.mask, GapTVConfig(iters=40), orig_bayer=sc.orig_bayer,
                          device="cuda")
            warm_psnr = warm.psnr_per_frame.mean().item()
            results = {}
            for mode, kw in modes.items():
                prior = fastdvd_prior(FastDVDnet(**kw))
                secs = []
                for rep in range(4):  # one warm-up, then three timed
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    cuda_kernels.reset_launches()
                    t0 = time.perf_counter()
                    res = run_fastdvd(sc, prior, "cuda")
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    counts = dict(cuda_kernels.launches)
                    require(counts == FASTDVD_LAUNCHES[mode],
                            f"fastdvd {mode} {style}: launches {counts}")
                    report.setdefault(f"launches_fastdvd_{mode}", counts)
                    if mode == "bf16":
                        by_shape = dict(cuda_kernels.convpair_launches)
                        require(by_shape == {shp: 144 for shp in CONVPAIR_MAIN_SHAPES.values()},
                                f"fastdvd bf16 {style}: conv pair launches {by_shape}")
                        report.setdefault("launches_convpair", by_shape)
                    if rep:
                        secs.append(dt)
                peak = torch.cuda.max_memory_allocated()
                require(tuple(res.x_bayer.shape) == (8, 512, 512)
                        and tuple(res.x_rgb.shape) == (8, 512, 512, 3), "fastdvd: shapes")
                require(bool(torch.isfinite(res.x_bayer).all() & torch.isfinite(res.x_rgb).all()),
                        f"fastdvd {mode} {style}: non-finite output")
                med = statistics.median(secs)
                results[mode] = res
                emit("fastdvd", scene=style, mode=mode, shape=[8, 512, 512],
                     weights="weights/fastdvd.npz", seconds_per_snapshot=med, seconds_runs=secs,
                     frames_per_s=8 / med, warm_start_psnr_db=warm_psnr,
                     warm_start_ssim=warm.ssim_per_frame.mean().item(),
                     psnr_db=res.psnr_per_frame.mean().item(),
                     ssim=res.ssim_per_frame.mean().item(),
                     gain_over_warm_start_db=res.psnr_per_frame.mean().item() - warm_psnr,
                     peak_mem_bytes=peak, launches_per_reconstruction=counts, **card)
            emit("fastdvd_modes", scene=style,
                 bf16_minus_fp32_psnr_db=(results["bf16"].psnr_per_frame.mean()
                                          - results["fp32"].psnr_per_frame.mean()).item(),
                 max_abs_dx_bayer=float((results["bf16"].x_bayer
                                         - results["fp32"].x_bayer).abs().max()))
            if style == "smooth":
                # the repository's second checkpoint, trained on this scene family
                smooth = run_fastdvd(
                    sc, fastdvd_prior(FastDVDnet()), "cuda",
                    params=fastdvdnet_from_flax(
                        load_variables_npz(str(ROOT / "weights" / "fastdvd_smooth.npz"))))
                emit("fastdvd_smooth_weights", scene=style, mode="fp32",
                     weights="weights/fastdvd_smooth.npz", warm_start_psnr_db=warm_psnr,
                     psnr_db=smooth.psnr_per_frame.mean().item(),
                     ssim=smooth.ssim_per_frame.mean().item())
                with torch.no_grad():
                    warm_ms = time_ms(lambda: gap_tv(
                        sc.meas, sc.mask, GapTVConfig(iters=40), device="cuda"), n=3)
                emit("fastdvd_breakdown", warm_start_40_ms=warm_ms,
                     fp32_remat=fastdvd_breakdown(torch, sc, fastdvd_params, None, True),
                     fp32_no_remat=fastdvd_breakdown(torch, sc, fastdvd_params, None, False),
                     bf16_no_remat=fastdvd_breakdown(torch, sc, fastdvd_params,
                                                     torch.bfloat16, False),
                     **card)
                prior = fastdvd_prior(FastDVDnet(**modes["bf16"]))
                cuda_kernels.reset_launches()
                emit("fastdvd_profile", mode="bf16",
                     **flagship_profile(torch, lambda: run_fastdvd(sc, prior, "cuda"), None),
                     **card)
                require(dict(cuda_kernels.launches) == FASTDVD_LAUNCHES["bf16"],
                        f"fastdvd profile: launches {cuda_kernels.launches}")

    # ---------------------------------------------- deep demosaicking row
    ddnet_params = ddnet_from_flax(load_variables_npz(str(ROOT / "weights" / "ddnet.npz")))
    row = admm_config_for("Bosphorus", "fastdvd", deep_demosaicking=True)
    require((row.sigma, row.iters, row.rho, row.select_best_holdout, row.demosaic_method)
            == ((8 / 255, 6 / 255), (24, 12), 0.55, 0.05, "ddnet")
            and np.nonzero(make_schedule(row.sigma, row.iters, row.adapt)[1])[0].tolist() == [25],
            f"ddnet: the scene table's row changed: {row}")

    def run_row(scene, prior, dm, device, cfg=row, generator=None):
        """The row end to end through ``reconstruct_single_dispatch``."""
        return reconstruct_single_dispatch(
            scene.meas, scene.mask, GapTVConfig(iters=40), cfg, prior, fastdvd_params,
            orig=scene.orig_bayer, device=device, generator=generator, demosaic_fn=dm)

    def run_row_dm_update(scene, prior, spec, device, cfg=row, generator=None):
        """The row with the demosaicker adapted in the loop: GAP-TV, then
        ``two_stage_admm`` with ``dm_spec``."""
        warm = gap_tv(scene.meas, scene.mask, GapTVConfig(iters=40), device=device)
        return two_stage_admm(scene.meas, scene.mask, cfg, prior, fastdvd_params,
                              warm.x_bayer, scene.orig_bayer, device, generator,
                              dm_spec=spec, dm_variables=ddnet_params)

    # ------------------------------------------------------- ddnet parity
    if "ddnet_parity" in phases:
        import dataclasses

        sc = make_scene(b=8, h=64, w=64, seed=42)
        cfg = dataclasses.replace(row, iters=DDNET_PARITY_ITERS, adapt=dataclasses.replace(
            row.adapt, interval_iter=5))
        require(np.nonzero(make_schedule(cfg.sigma, cfg.iters, cfg.adapt)[1])[0].tolist() == [5],
                "ddnet_parity: trigger")
        prior = fastdvd_prior(FastDVDnet())
        runs = {
            "ddnet_fixed": lambda dev: run_row(sc, prior, ddnet_demosaic(DDnet(), ddnet_params),
                                               dev, cfg, torch.Generator().manual_seed(0)),
            "dm_update_carried": lambda dev: run_row_dm_update(
                sc, prior, make_dm_spec(DDnet(), **DM_UPDATE), dev, cfg,
                torch.Generator().manual_seed(0)),
            "dm_update_fresh": lambda dev: run_row_dm_update(
                sc, prior, make_dm_spec(DDnet(), **DM_UPDATE, fresh_opt=True), dev, cfg,
                torch.Generator().manual_seed(0)),
        }
        for name, run in runs.items():
            t0 = time.perf_counter()
            cpu = run("cpu")
            cpu_s = time.perf_counter() - t0
            cuda_kernels.reset_launches()
            gpu = run("cuda")
            torch.cuda.synchronize()
            counts = dict(cuda_kernels.launches)
            require(counts == DDNET_PARITY_LAUNCHES, f"ddnet_parity {name}: launches {counts}")
            require(bool(torch.isfinite(gpu.x_bayer).all()), f"ddnet_parity {name}: non-finite")
            dpsnr = (gpu.psnr_per_frame.cpu() - cpu.psnr_per_frame).abs()
            dx = float((gpu.x_bayer.cpu() - cpu.x_bayer).abs().max())
            picks = {"cuda": guard_pick(gpu), "cpu": guard_pick(cpu)}
            fields = {}
            if name != "ddnet_fixed":
                fields["max_abs_d_dm_variables"] = max(
                    float((gpu.dm_variables[k].cpu() - cpu.dm_variables[k]).abs().max())
                    for k in cpu.dm_variables)
            emit("ddnet_parity", run=name, shape=[8, 64, 64], iters=list(cfg.iters),
                 trigger_k=5, dtype="float32", weights="weights/ddnet.npz, weights/fastdvd.npz",
                 max_dpsnr_db=float(dpsnr.max()), dpsnr_per_frame_db=dpsnr.tolist(),
                 max_abs_dx_bayer=dx, bar="0.05 dB, 1e-3, the same pick", picks=picks,
                 psnr_cuda=gpu.psnr_per_frame.mean().item(),
                 psnr_cpu=cpu.psnr_per_frame.mean().item(), cpu_seconds=cpu_s,
                 launches=counts, **fields)
            require(picks["cuda"]["pick"] == picks["cpu"]["pick"],
                    f"ddnet_parity {name}: picks differ {picks}")
            require(float(dpsnr.max()) <= 0.05 and dx <= 1e-3,
                    f"ddnet_parity {name}: dPSNR {float(dpsnr.max())} dB, max |dx| {dx}")

    # -------------------------------------------------------------- ddnet
    if "ddnet" in phases:
        prior = fastdvd_prior(FastDVDnet(**modes["bf16"]))
        dm = ddnet_demosaic(DDnet(dtype=torch.bfloat16), ddnet_params)
        for style in ("smooth", "leaves"):
            sc = make_scene(b=8, h=512, w=512, seed=42, style=style)
            warm = gap_tv(sc.meas, sc.mask, GapTVConfig(iters=40), orig_bayer=sc.orig_bayer,
                          device="cuda")
            warm_psnr = warm.psnr_per_frame.mean().item()
            secs = []
            for rep in range(4):  # one warm-up, then three timed
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                cuda_kernels.reset_launches()
                t0 = time.perf_counter()
                res = run_row(sc, prior, dm, "cuda")
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                counts = dict(cuda_kernels.launches)
                require(counts == DDNET_LAUNCHES, f"ddnet {style}: launches {counts}")
                by_shape = dict(cuda_kernels.convpair_launches)
                require(by_shape == {shp: 144 for shp in CONVPAIR_MAIN_SHAPES.values()},
                        f"ddnet {style}: conv pair launches {by_shape}")
                report.setdefault("launches_ddnet", counts)
                report.setdefault("launches_convpair_ddnet", by_shape)
                if rep:
                    secs.append(dt)
            peak = torch.cuda.max_memory_allocated()
            require(tuple(res.x_bayer.shape) == (8, 512, 512)
                    and tuple(res.x_rgb.shape) == (8, 512, 512, 3), "ddnet: shapes")
            require(bool(torch.isfinite(res.x_bayer).all() & torch.isfinite(res.x_rgb).all()),
                    f"ddnet {style}: non-finite output")
            require(tuple(res.resid_trace.shape) == (37,), "ddnet: guard candidates")
            med = statistics.median(secs)
            emit("ddnet", scene=style, mode="bf16 DDnet + bf16 FastDVDnet (remat off)",
                 shape=[8, 512, 512], config='admm_config_for("Bosphorus", "fastdvd", True)',
                 weights="weights/ddnet.npz, weights/fastdvd.npz", seconds_per_snapshot=med,
                 seconds_runs=secs, frames_per_s=8 / med, warm_start_psnr_db=warm_psnr,
                 warm_start_ssim=warm.ssim_per_frame.mean().item(),
                 psnr_db=res.psnr_per_frame.mean().item(), ssim=res.ssim_per_frame.mean().item(),
                 gain_over_warm_start_db=res.psnr_per_frame.mean().item() - warm_psnr,
                 guard=guard_pick(res), peak_mem_bytes=peak,
                 launches_per_reconstruction=counts, **card)
            if style != "smooth":
                continue
            ddnet_calls = 37  # 36 iterations and the guard's candidate 0
            parts = {**ddnet_breakdown(torch, sc, ddnet_params, row),
                     **fastdvd_breakdown(torch, sc, fastdvd_params, torch.bfloat16, False)}
            emit("ddnet_breakdown", **parts, ddnet_calls=ddnet_calls,
                 ddnet_share_of_wall=ddnet_calls * parts["ddnet_bf16_ms"] / (med * 1e3),
                 **card)
            cuda_kernels.reset_launches()
            emit("ddnet_profile", **flagship_profile(torch, lambda: run_row(sc, prior, dm, "cuda"),
                                                     None), **card)
            require(dict(cuda_kernels.launches) == DDNET_LAUNCHES,
                    f"ddnet profile: launches {cuda_kernels.launches}")
            # the same row with the demosaicker adapted in the loop, at the
            # pipeline's defaults (one Adam step an iteration, carried Adam)
            spec = make_dm_spec(DDnet(dtype=torch.bfloat16), **DM_UPDATE)
            secs = []
            for _ in range(2):  # a warm-up (first backward calls), then one timed
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                cuda_kernels.reset_launches()
                t0 = time.perf_counter()
                upd = run_row_dm_update(sc, prior, spec, "cuda")
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                counts = dict(cuda_kernels.launches)
                require(counts == DDNET_LAUNCHES, f"ddnet dm_update: launches {counts}")
            require(bool(torch.isfinite(upd.x_bayer).all()), "ddnet dm_update: non-finite")
            emit("ddnet_dm_update", scene=style, lr=DM_UPDATE["lr"],
                 steps_per_iteration=DM_UPDATE["update_per_iter"], optimizer="carried Adam",
                 seconds_per_snapshot=secs[1], seconds_warm_up=secs[0],
                 psnr_db=upd.psnr_per_frame.mean().item(), ssim=upd.ssim_per_frame.mean().item(),
                 guard=guard_pick(upd), peak_mem_bytes=torch.cuda.max_memory_allocated(),
                 launches_per_reconstruction=counts, **card)

    # ------------------------------------------------------ drivers parity
    def second_measurement(sc, style="leaves"):
        """A second snapshot of another scene under the first scene's masks."""
        other = make_scene(b=sc.mask.shape[0], h=sc.mask.shape[1], w=sc.mask.shape[2],
                           seed=43, style=style)
        return (sc.mask * other.orig_bayer).sum(0).astype(np.float32), other.orig_bayer

    def warm_starts(y_seq, mask, device):
        return torch.stack([gap_tv(y, mask, GapTVConfig(iters=40), device=device).x_bayer
                            for y in y_seq])

    if "drivers_parity" in phases:
        sc = make_scene(b=8, h=64, w=64, seed=42)
        y2, o2 = second_measurement(sc)
        y_seq, o_seq = np.stack([sc.meas, y2]), np.stack([sc.orig_bayer, o2])
        ffd_params = ffdnet_from_flax(flax_style_ffdnet_params(16, 4, seed=0))
        ffd = ffdnet_prior(FFDNet(nc=16, nb=4))
        flagship_adapt = dict(lr=2e-6, update_per_iter=2, interval_iter=15, initial_iter=1)
        carried = ADMMConfig(sigma=SIGMA, iters=ITERS, adapt=AdaptConfig(
            **flagship_adapt, fresh_opt_per_trigger=False))
        big = make_scene(b=8, h=128, w=128, seed=42)
        tiled_cfg = ADMMConfig(sigma=FASTDVD_SIGMA, iters=(6, 4), denoiser="fastdvd",
                               adapt=AdaptConfig(lr=2e-7, update_per_iter=2, interval_iter=5),
                               select_best=True, select_best_holdout=0.05)
        fdvd32 = fastdvd_prior(FastDVDnet())

        def tiled_run(dev):
            warm = gap_tv(big.meas, big.mask, GapTVConfig(iters=40), device=dev)
            return two_stage_admm_tiled(
                big.meas, big.mask, tiled_cfg, tile=64, prior=fdvd32, params=fastdvd_params,
                orig_bayer=big.orig_bayer, x0_bayer=warm.x_bayer, overlap=8, tile_chunk=2,
                generator=torch.Generator().manual_seed(0), device=dev)

        def sequence_run(dev):
            x0 = warm_starts(y_seq, sc.mask, dev)
            return two_stage_admm_sequence(y_seq, sc.mask, carried, ffd, ffd_params, x0, o_seq,
                                           device=dev)

        def batched_run(dev):
            x0 = warm_starts(y_seq, sc.mask, dev)
            return two_stage_admm_batched(y_seq, sc.mask, ADMMConfig(sigma=SIGMA, iters=ITERS),
                                          ffd, ffd_params, x0, o_seq, device=dev)

        def gap_deep_run(dev):
            return gap_deep(sc.meas, sc.mask, GapDeepConfig(
                sigma=(25 / 255, 12 / 255), iters=(6, 4), lam=0.8,
                adapt=AdaptConfig(lr=2e-6, interval_iter=5, fresh_opt_per_trigger=False)),
                ffd, ffd_params, orig_bayer=sc.orig_bayer, device=dev)

        def menon_run(dev):
            warm = gap_tv(sc.meas, sc.mask, GapTVConfig(iters=40), device=dev)
            return two_stage_admm(sc.meas, sc.mask, ADMMConfig(
                sigma=SIGMA, iters=ITERS, demosaic_method="menon2007",
                adapt=AdaptConfig(**flagship_adapt)), ffd, ffd_params, warm.x_bayer,
                sc.orig_bayer, device=dev)

        def gray_run(dev):
            return gap_denoise_gray(sc.meas, sc.mask, GrayConfig(iters=(40,)),
                                    orig=sc.orig_bayer, device=dev)

        cases = {
            # 40 warm-start x-updates and TV proxes at 128^2; 2 groups of 2
            # windows of 80 (tile 64, overlap 8): 10 ADMM and 40 masked GAP-TV
            # x-updates and 40 TV proxes each (the guard's candidate 0)
            "tiled": (tiled_run, {"x_update": 40 + 2 * (10 + 40), "tv_chambolle": 40 + 2 * 40,
                                  "convpair": 0}),
            "sequence": (sequence_run, SEQUENCE_LAUNCHES),
            # the two measurements' ADMM iterations in lockstep: 25 launches
            "batched": (batched_run, {"x_update": 2 * 40 + 25, "tv_chambolle": 2 * 40,
                                      "convpair": 0}),
            "gap_deep": (gap_deep_run, {"x_update": 10, "tv_chambolle": 0, "convpair": 0}),
            "menon2007": (menon_run, {"x_update": 65, "tv_chambolle": 40, "convpair": 0}),
            "gray": (gray_run, {"x_update": 0, "tv_chambolle": 40, "convpair": 0}),
        }
        db_bar, dx_bar = DRIVERS_PARITY_BAR
        for name, (run, want_counts) in cases.items():
            t0 = time.perf_counter()
            cpu = run("cpu")
            cpu_s = time.perf_counter() - t0
            cuda_kernels.reset_launches()
            gpu = run("cuda")
            torch.cuda.synchronize()
            counts = dict(cuda_kernels.launches)
            require(counts == want_counts, f"drivers_parity {name}: launches {counts}")
            xg, xc = (gpu.x, cpu.x) if name == "gray" else (gpu.x_bayer, cpu.x_bayer)
            require(bool(torch.isfinite(xg).all()), f"drivers_parity {name}: non-finite")
            dpsnr = float((gpu.psnr_per_frame.cpu() - cpu.psnr_per_frame).abs().max())
            dx = float((xg.cpu() - xc).abs().max())
            fields = {}
            if getattr(gpu, "resid_trace", None) is not None:
                picks = {d: [int(i) for i in r.resid_trace.cpu().reshape(
                    -1, r.resid_trace.shape[-1]).argmin(-1)] for d, r in (("cuda", gpu), ("cpu", cpu))}
                fields["picks"] = picks
                require(picks["cuda"] == picks["cpu"], f"drivers_parity {name}: picks {picks}")
            if getattr(gpu, "variables", None) is not None and name != "batched":
                fields["max_abs_d_variables"] = max(
                    float((gpu.variables[k].cpu() - cpu.variables[k]).abs().max())
                    for k in cpu.variables)
            emit("drivers_parity", case=name, dtype="float32", max_dpsnr_db=dpsnr,
                 max_abs_dx=dx, bar=f"{db_bar} dB, {dx_bar}, the same pick",
                 psnr_cuda=gpu.psnr_per_frame.mean().item(),
                 psnr_cpu=cpu.psnr_per_frame.mean().item(), cpu_seconds=cpu_s,
                 launches=counts, **fields)
            require(dpsnr <= db_bar and dx <= dx_bar,
                    f"drivers_parity {name}: dPSNR {dpsnr} dB, max |dx| {dx}")

    # --------------------------------------------------------------- tiled
    if "tiled" in phases:
        import adaptivepnp_sci_torch.solvers.two_stage_admm as admm_mod

        size, tile = TILED["size"], TILED["tile"]
        sc = make_scene(b=8, h=size, w=size, seed=42)
        prior = fastdvd_prior(FastDVDnet(**modes["bf16"]))
        cfg = ADMMConfig(sigma=FASTDVD_SIGMA, iters=FASTDVD_ITERS, denoiser="fastdvd",
                         adapt=AdaptConfig(**FASTDVD_ADAPT))
        group_ms: list[float] = []
        run_admm = admm_mod.run_admm

        def timed_run_admm(*a, **kw):
            # the time of each group of tiles (one run_admm call), host clock
            # between two synchronisations
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_admm(*a, **kw)
            torch.cuda.synchronize()
            group_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def snapshot(chunk):
            warm = gap_tv(sc.meas, sc.mask, GapTVConfig(iters=40), orig_bayer=sc.orig_bayer,
                          device="cuda")
            res = two_stage_admm_tiled(
                sc.meas, sc.mask, cfg, tile=tile, prior=prior, params=fastdvd_params,
                orig_bayer=sc.orig_bayer, x0_bayer=warm.x_bayer, tile_chunk=chunk,
                generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
            return warm, res

        admm_mod.run_admm = timed_run_admm
        try:
            for chunk in (TILED["tile_chunk"], 4):
                secs, groups = [], []
                reps = 3 if chunk == TILED["tile_chunk"] else 2  # one warm-up first
                for rep in range(reps):
                    group_ms.clear()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    cuda_kernels.reset_launches()
                    t0 = time.perf_counter()
                    warm, res = snapshot(chunk)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    counts = dict(cuda_kernels.launches)
                    require(counts == TILED_LAUNCHES[chunk],
                            f"tiled chunk {chunk}: launches {counts}")
                    by_shape = dict(cuda_kernels.convpair_launches)
                    require(by_shape == {shp: 16 * 36 * 4 for shp in CONVPAIR_MAIN_SHAPES.values()},
                            f"tiled chunk {chunk}: conv pair launches {by_shape}")
                    if chunk == TILED["tile_chunk"]:
                        report.setdefault("launches_tiled", counts)
                        report.setdefault("launches_convpair_tiled", by_shape)
                    if rep:
                        secs.append(dt)
                        groups.append(list(group_ms))
                peak = torch.cuda.max_memory_allocated()
                require(tuple(res.x_bayer.shape) == (8, size, size)
                        and tuple(res.x_rgb.shape) == (8, size, size, 3), "tiled: shapes")
                require(bool(torch.isfinite(res.x_bayer).all() & torch.isfinite(res.x_rgb).all()),
                        f"tiled chunk {chunk}: non-finite output")
                require(set(res.variables) == set(fastdvd_params)
                        and res.variables["temp1.inc.convblock.0.weight"].shape
                        == fastdvd_params["temp1.inc.convblock.0.weight"].shape,
                        "tiled: the shared weights are not one copy")
                moved = max(float((res.variables[k].cpu() - fastdvd_params[k]).abs().max())
                            for k in fastdvd_params if k.endswith("weight"))
                require(moved > 0, "tiled: the adaptation did not move the weights")
                med = statistics.median(secs)
                warm_psnr = warm.psnr_per_frame.mean().item()
                emit("tiled", shape=[8, size, size], tile=tile, overlap=0, tile_chunk=chunk,
                     groups=16 // chunk, mode="bf16 FastDVDnet (remat off), adaptation shared "
                     "over tiles", weights="weights/fastdvd.npz",
                     seconds_per_snapshot=med, seconds_runs=secs, frames_per_s=8 / med,
                     group_ms=groups[-1], group_ms_median=statistics.median(groups[-1]),
                     warm_start_psnr_db=warm_psnr, psnr_db=res.psnr_per_frame.mean().item(),
                     ssim=res.ssim_per_frame.mean().item(),
                     gain_over_warm_start_db=res.psnr_per_frame.mean().item() - warm_psnr,
                     max_abs_weight_change=moved, peak_mem_bytes=peak,
                     launches_per_snapshot=counts, **card)
        finally:
            admm_mod.run_admm = run_admm
        with torch.no_grad():
            warm_ms = time_ms(lambda: gap_tv(sc.meas, sc.mask, GapTVConfig(iters=40),
                                             device="cuda"), n=3)
        emit("tiled_breakdown", warm_start_2048_40_ms=warm_ms, **card)
        del sc, warm, res

    # ------------------------------------------------------------ sequence
    if "sequence" in phases:
        params = ffdnet_from_flax(flax_style_ffdnet_params(96, 12, seed=0))
        prior = ffdnet_prior(FFDNet(nc=96, nb=12))
        sc = make_scene(b=8, h=512, w=512, seed=42)
        y2, o2 = second_measurement(sc)
        y_seq, o_seq = np.stack([sc.meas, y2]), np.stack([sc.orig_bayer, o2])
        cfg = ADMMConfig(sigma=SIGMA, iters=ITERS, adapt=AdaptConfig(
            lr=2e-6, update_per_iter=2, interval_iter=15, initial_iter=1,
            fresh_opt_per_trigger=False))

        def run_sequence(y, o):
            x0 = warm_starts(y, sc.mask, "cuda")
            return two_stage_admm_sequence(y, sc.mask, cfg, prior, params, x0, o, device="cuda")

        secs = []
        for rep in range(2):  # one warm-up, then one timed
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            res = run_sequence(y_seq, o_seq)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts = dict(cuda_kernels.launches)
            require(counts == SEQUENCE_LAUNCHES, f"sequence: launches {counts}")
            report.setdefault("launches_sequence", counts)
        peak = torch.cuda.max_memory_allocated()
        first = run_sequence(y_seq[:1], o_seq[:1])
        require(tuple(res.x_bayer.shape) == (2, 8, 512, 512), "sequence: shapes")
        require(bool(torch.isfinite(res.x_bayer).all()), "sequence: non-finite output")
        # the first measurement of the pair is the sequence of one (up to the
        # library's nondeterministic backward sums)
        first_dx = float((first.x_bayer[0] - res.x_bayer[0]).abs().max())
        require(first_dx <= 1e-3, f"sequence: the first measurement moved by {first_dx}")
        require(int(res.opt_state["state"][0]["step"]) == 4, "sequence: the Adam was not carried")
        delta = max(float((res.variables[k] - first.variables[k]).abs().max()) for k in params)
        delta0 = max(float((first.variables[k].cpu() - params[k]).abs().max()) for k in params)
        require(delta > 0, "sequence: the second measurement did not adapt")
        emit("sequence", shape=[2, 8, 512, 512], ffdnet={"nc": 96, "nb": 12},
             weights="random, Flax default init from numpy seed 0", optimizer="carried Adam",
             seconds_per_measurement=secs[1] / 2, seconds_runs=secs,
             psnr_db=[float(p) for p in res.psnr_per_frame.mean(-1)],
             max_abs_weight_delta_second_from_first=delta,
             max_abs_weight_delta_first_from_start=delta0, first_measurement_max_abs_dx=first_dx,
             adam_steps=int(res.opt_state["state"][0]["step"]), peak_mem_bytes=peak,
             launches=counts, **card)

    # ------------------------------------------------------------- kernels
    if "kernels" in phases:
        # launches on the main paths: the flagship's for its two kernels, the
        # bf16 FastDVDnet reconstruction's for the conv pair; and on the
        # deep-demosaicking row
        launches = dict(report["launches"])
        launches_ddnet = dict(report["launches_ddnet"])
        launches_tiled = dict(report["launches_tiled"])
        launches_sequence = dict(report["launches_sequence"])
        for name, shape in CONVPAIR_MAIN_SHAPES.items():
            launches[f"convpair_{name}"] = report["launches_convpair"][shape]
            launches_ddnet[f"convpair_{name}"] = report["launches_convpair_ddnet"][shape]
            launches_tiled[f"convpair_{name}"] = report["launches_convpair_tiled"][shape]
            launches_sequence[f"convpair_{name}"] = 0
        pallas = {"x_update": "adaptivepnp_sci_tpu/ops/pallas_kernels.py:58",
                  "tv_chambolle": "adaptivepnp_sci_tpu/ops/pallas_kernels.py:93",
                  "convpair": "scripts/ab_pallas_convpair.py:47"}
        sources = {"x_update": "x_update.cu", "tv_chambolle": "tv_chambolle.cu",
                   "convpair": "convpair_wgmma.cu"}
        extra = {"x_update": ("items2_ms", "items2_plain_ms", "items2_bound_ms"),
                 "tv_chambolle": ("ms_1024", "ms_288")}
        rows = []
        for name, kernel in (("x_update", "x_update"), ("tv_chambolle", "tv_chambolle"),
                             *((f"convpair_{n}", "convpair") for n in CONVPAIR_MAIN_SHAPES)):
            r = report[name]
            rows.append({"name": name, "route": "cuda",
                         "source": f"adaptivepnp_sci_torch/csrc/{sources[kernel]}",
                         "replaces": pallas[kernel], "launches": launches[name],
                         "launches_ddnet_row": launches_ddnet[name],
                         "launches_tiled": launches_tiled[name],
                         "launches_sequence": launches_sequence[name],
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "previous_ms": r.get("previous_ms"), "plain_ms": r["plain_ms"],
                         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                         "library_ms": r.get("library_ms"),
                         **{k: r[k] for k in extra.get(name, ())}})
        require(all(r["launches"] > 0 and r["launches_ddnet_row"] > 0 and r["launches_tiled"] > 0
                    for r in rows), f"a kernel was never launched: {rows}")
        require(all(r["launches_sequence"] > 0 for r in rows[:2]),
                f"the sequence path missed a kernel: {rows}")
        print(json.dumps({"kernels": rows}), flush=True)

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "adaptivepnp_sci_tpu"))
    require(not foreign, f"JAX modules were imported: {foreign}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
