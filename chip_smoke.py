#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``adaptivepnp_sci_torch``) on one
NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases build,k1,k2

It builds the three CUDA kernels from ``adaptivepnp_sci_torch/csrc/``, holds
each against its plain PyTorch version on the card, holds the kernel paths
against the plain paths on the CPU end to end, and drives two 512x512x8
reconstructions: the flagship (GAP-TV warm start, two-stage ADMM with
FFDNet-color nc = 96, nb = 12 and online adaptation, random weights made
from a seed) and the FastDVDnet prior path (trained weights from
``weights/fastdvd.npz``, in float32 and in bf16 with the fused conv-pair
kernel). Each phase prints one JSON line; any failure exits nonzero. The last line is
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
          "fastdvd_parity", "fastdvd", "kernels")

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
    ours = {name: sum(dev_us(e) for e in events if f"{name}_kernel" in e.key) / 1e3
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
    if "kernels" in phases and not {"k1", "k2", "k3", "flagship", "fastdvd"} <= phases:
        ap.error("the kernels phase needs the k1, k2, k3, flagship and fastdvd phases")
    from adaptivepnp_sci_torch import (
        ADMMConfig,
        AdaptConfig,
        FastDVDnet,
        GapTVConfig,
        fastdvd_prior,
        ffdnet_prior,
        gap_tv,
        reconstruct_single_dispatch,
    )
    from adaptivepnp_sci_torch.ab_convpair import library_pair, make_inputs, time_ms
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.convert import (
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
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
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
        byts = (4 * theta.numel() + 2 * y.numel()) * 4
        bound_ms = byts / HBM_BYTES_PER_S * 1e3
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
        emit("k1", shape=[nb, 4, h2, w2], tolerance="rtol 1e-5, atol 1e-6", cases=per,
             bytes=byts, bound_us=bound_ms * 1e3,
             bound_basis="bytes / 3.35 TB/s (H100 SXM HBM3 data sheet)", **card)
        report["x_update"] = {
            "max_abs_err": max(c["max_abs"] for c in per.values()),
            "ms": per["gap"]["ms"], "plain_ms": per["gap"]["plain_ms"],
            "bound_ms": bound_ms, "bound_by": "bytes"}

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
        real = inputs[1]
        _, it_real = cuda_kernels.tv_chambolle_planes_cuda(real, 0.1, 2e-4, 5)
        n_iter = int(it_real.sum())
        byts = 2 * real.numel() * 4
        flops = n_iter * 256 * 256 * TV_FLOPS_PER_PIXEL_ITER
        bound_ms = max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        ms = time_ms(lambda: cuda_kernels.tv_chambolle_fused(real, 0.1), flush=flush)
        warm_ms = time_ms(lambda: cuda_kernels.tv_chambolle_fused(real, 0.1))
        plain_ms = time_ms(lambda: tv.tv_chambolle_multichannel(real, 0.1), n=10,
                           flush=flush)
        emit("k2", shape=[32, 256, 256], tolerance="rtol 1e-5, atol 1e-6",
             golden_max_abs=golden_err, max_abs=err, planes_compared=planes,
             stop_iteration_flips=flips, kernel_iterations_histogram=iters_hist,
             timed_input="first warm-start TV input", timed_plane_iterations=n_iter,
             ms=ms, warm_l2_ms=warm_ms, plain_ms=plain_ms, bytes=byts, flops=flops,
             bound_us=bound_ms * 1e3,
             bound_basis="max(bytes / 3.35 TB/s, flops / 67 TFLOP/s fp32)",
             sms_used=32, **card)
        report["tv_chambolle"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": bound_ms,
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
            got = cuda_kernels.convpair(*pair)
            torch.cuda.synchronize()
            want = convpair_ops.convpair(*pair)
            require(bool(torch.isfinite(got.float()).all()), f"k3 {name}: non-finite output")
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max()) or 1.0
            require(err / scale < 2e-2, f"k3 {name}: rel err {err / scale} >= 2e-2")
            n, h, w, c = pair[0].shape
            flops = 2 * 2 * 9 * c * c * n * h * w
            byts = 2 * pair[0].numel() * 2 + 2 * 9 * c * c * 2 + 4 * c * 4
            per[name] = {"shape": [n, h, w, c], "max_abs": err, "max_abs_ref": scale,
                         "rel_err": err / scale, "flops": flops, "bytes": byts,
                         "bound_us": max(flops / BF16_FLOPS, byts / HBM_BYTES_PER_S) * 1e6,
                         "bound_by": "operations" if flops / BF16_FLOPS
                         >= byts / HBM_BYTES_PER_S else "bytes"}
            if "trained" in name or "odd" in name:
                continue
            lib = library_pair(*pair)
            per[name].update(
                ms=time_ms(lambda: cuda_kernels.convpair(*pair), flush=flush),
                warm_l2_ms=time_ms(lambda: cuda_kernels.convpair(*pair)),
                plain_ms=time_ms(lambda: convpair_ops.convpair(*pair), n=10, flush=flush),
                library_ms=time_ms(lib, n=10, flush=flush))
            per[name]["tflops"] = flops / (per[name]["ms"] * 1e-3) / 1e12
        emit("k3", tolerance="max abs err / max abs reference < 2e-2", cases=per,
             bound_basis="max(flops / 989 TFLOP/s bf16 dense, bytes / 3.35 TB/s)",
             library="two channels-last bf16 F.conv2d with folded scale and bias, ReLU in place",
             **card)
        main_case = per["c64_256"]
        report["convpair"] = {
            "max_abs_err": max(c["max_abs"] for c in per.values()),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_us"] / 1e3, "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"]}
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

    # ------------------------------------------------------------- kernels
    if "kernels" in phases:
        # launches on the main paths: the flagship's for its two kernels, the
        # bf16 FastDVDnet reconstruction's for the conv pair
        launches = {**report["launches"],
                    "convpair": report["launches_fastdvd_bf16"]["convpair"]}
        sources = {"x_update": "adaptivepnp_sci_tpu/ops/pallas_kernels.py:58",
                   "tv_chambolle": "adaptivepnp_sci_tpu/ops/pallas_kernels.py:93",
                   "convpair": "scripts/ab_pallas_convpair.py:47"}
        rows = [{"name": name, "route": "cuda",
                 "source": f"adaptivepnp_sci_torch/csrc/{name}.cu",
                 "replaces": sources[name], "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r.get("library_ms")}
                for name, r in ((n, report[n]) for n in sources)]
        require(all(row["launches"] > 0 for row in rows), f"a kernel was never launched: {rows}")
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
