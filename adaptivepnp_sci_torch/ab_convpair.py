"""A/B on the card: the fused CvBlock conv-pair kernel against the library's
two convolutions, at FastDVDnet's shapes
(port of ``scripts/ab_pallas_convpair.py``).

    python -m adaptivepnp_sci_torch.ab_convpair [C] [HW] [N]

Without arguments it runs the script's two shapes, C = 64 @ 256x256 and
C = 32 @ 512x512 with N = 8, and FastDVDnet's third CvBlock shape,
C = 128 @ 128x128. Inputs come from numpy seed 0 as in the JAX script. The
fused kernel's output is held against the plain pair before any time is
printed (max abs error / max abs reference < 2e-2); the line also gives the
time of each design of the kernel built for that C (``design=`` of
``cuda_kernels.convpair``). Times are medians of
CUDA events, each run queued behind a short device sleep so that the host's
launch cost is hidden, with L2 flushed before each run. It needs an NVIDIA
GPU and raises without one.
"""

from __future__ import annotations

import statistics
import sys
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from adaptivepnp_sci_torch.ops import convpair as convpair_ops
from adaptivepnp_sci_torch.ops import cuda_kernels

#: NVIDIA H100 SXM data-sheet peaks
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def make_inputs(n: int, h: int, w: int, c: int, device: torch.device,
                seed: int = 0) -> tuple[Tensor, ...]:
    """``(x, w1, s1, b1, w2, s2, b2)`` drawn as the JAX script draws them:
    x ~ N(0, 1) in bf16, kernels and the folded scale / shift ~ 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(np.float32))

    def mk(*shape: int) -> Tensor:
        return torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32))

    w1, w2 = mk(3, 3, c, c), mk(3, 3, c, c)
    s1, b1, s2, b2 = mk(c), mk(c), mk(c), mk(c)
    low = [t.to(device).bfloat16() for t in (x, w1, w2)]
    vec = [t.to(device) for t in (s1, b1, s2, b2)]
    return low[0], low[1], vec[0], vec[1], low[2], vec[2], vec[3]


def library_pair(x: Tensor, w1: Tensor, s1: Tensor, b1: Tensor,
                 w2: Tensor, s2: Tensor, b2: Tensor) -> Callable[[], Tensor]:
    """The library's pair: the scale folded into bf16 weights ahead of time,
    two channels-last bf16 ``F.conv2d`` with bias, ReLU in place."""

    def fold(w: Tensor, s: Tensor) -> Tensor:
        return ((w.float() * s).permute(3, 2, 0, 1).bfloat16()
                .contiguous(memory_format=torch.channels_last))

    k1, k2, c1, c2 = fold(w1, s1), fold(w2, s2), b1.bfloat16(), b2.bfloat16()
    v = x.permute(0, 3, 1, 2)

    def run() -> Tensor:
        h = F.relu_(F.conv2d(v, k1, c1, padding=1))
        return F.relu_(F.conv2d(h, k2, c2, padding=1))

    return run


def time_ms(fn: Callable[[], object], n: int = 25, flush: Tensor | None = None) -> float:
    """Median device time of ``fn`` in ms over ``n`` runs (CUDA events),
    after 3 warm-up runs. Each run is queued behind a ~0.5 ms device sleep,
    so the host's launch overhead is hidden and the events time the device
    work (an ``fn`` that waits for the device inside still counts that wait).
    With ``flush`` (a tensor larger than L2), it is read before each run, so
    the inputs come from device memory and L2 holds no dirty lines to write
    back."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.sum()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main(c: int = 64, hw: int = 256, n: int = 8) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("ab_convpair needs an NVIDIA GPU")
    dev = torch.device("cuda")
    args = make_inputs(n, hw, hw, c, dev)
    before = cuda_kernels.launches["convpair"]
    got = cuda_kernels.convpair(*args)
    torch.cuda.synchronize()
    if cuda_kernels.launches["convpair"] != before + 1:
        raise RuntimeError("the fused kernel was not launched")
    ref = convpair_ops.convpair(*args)
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max()) or 1.0
    # correctness gate before any time is printed (bf16 level)
    if not err / scale < 2e-2:
        raise AssertionError(f"fused kernel wrong: rel err {err / scale:.2e}")
    flush = torch.zeros(128 * 2**20 // 4, device=dev)
    t_lib = time_ms(library_pair(*args), flush=flush)
    t_fused = time_ms(lambda: cuda_kernels.convpair(*args), flush=flush)
    # every design built for this C (the default one is t_fused)
    by_design = {d: time_ms(lambda d=d: cuda_kernels.convpair(*args, design=d), flush=flush)
                 for d, (_, _, chans) in cuda_kernels.CONVPAIR_DESIGNS.items() if c in chans}
    flops = 2 * 2 * n * hw * hw * c * c * 9
    byts = 2 * args[0].numel() * 2  # one read + one write, bf16
    bound = max(flops / BF16_FLOPS, byts / HBM_BYTES_PER_S) * 1e3
    print(f"C={c} {hw}^2 N={n}: library pair {t_lib:.3f} ms, fused kernel {t_fused:.3f} ms "
          f"({t_lib / t_fused:.2f}x; by design "
          f"{', '.join(f'{d} {t:.3f} ms' for d, t in by_design.items())}), "
          f"bound {bound:.3f} ms, rel err {err / scale:.2e}; "
          f"fused streams {byts / t_fused / 1e6:.0f} GB/s, {flops / t_fused / 1e9:.1f} TF/s "
          f"on {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    argv = [int(v) for v in sys.argv[1:]]
    if argv:
        main(*argv)
    else:
        main(64, 256, 8)
        main(32, 512, 8)
        main(128, 128, 8)
