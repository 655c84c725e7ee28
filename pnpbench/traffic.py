"""The one traffic generator: it reads a traffic file
(``pnpbench/traffic/<name>.json``) and makes, from ``--seed``, one camera's
coded aperture, a pool of scenes and their snapshot measurements, and the
order and draws of the requests.

A traffic file gives ``frames`` (B), ``height`` and ``width`` of the mosaic,
``style`` of the scenes, ``pool`` (scenes made in set-up), ``entry`` (the
program's call each request makes), ``warmup`` (requests in set-up),
``check_requests`` and ``check_among_first`` (how many requests the
reference recomputes, drawn from the seed among the first of the window),
and ``trace_requests`` (requests under the profiler in a traced run).

Scenes: the dead-leaves video of the repository's synthetic scenes (400
occluding disks, radii by ``p(r) ~ r^-3`` on [max(2, H/170), H/4], each
drifting with its own velocity, painted back to front over grey), drawn on
the device: each pixel takes the colour of the last disk that covers it.
Each frame is mosaicked RGGB and the snapshot is the sum over frames of
mosaic times mask; masks are Bernoulli(1/2).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

#: sub-seed tags
MASKS, SCENES, ORDER, NOISE, SAMPLE, WEIGHTS = 1, 2, 3, 4, 5, 6
STYLES = ("leaves",)


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of ``seed``, by tags."""
    ss = np.random.SeedSequence([seed % 2 ** 64, *tags])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def leaves_video(b: int, h: int, w: int, rng: np.random.Generator,
                 device: torch.device | str) -> Tensor:
    """Dead-leaves video ``(B, H, W, 3)`` in [0, 1] on ``device``; the disks'
    radii, centres, velocities and colours come from ``rng`` in that order."""
    rmin, rmax = max(2.0, h / 170), h / 4
    n = 400
    u = rng.random(n)
    radii = rmin / np.sqrt(1.0 - u * (1.0 - (rmin / rmax) ** 2))
    centers = rng.random((n, 2)) * [h, w]
    vels = rng.uniform(-3.0, 3.0, (n, 2)) * (h / 512.0)
    lum = rng.uniform(0.15, 0.85, n)
    colors = np.clip(lum[:, None] + rng.uniform(-0.25, 0.25, (n, 3)), 0.0, 1.0)
    palette = torch.tensor(np.concatenate([[[0.5, 0.5, 0.5]], colors]), dtype=torch.float32,
                           device=device)
    yy = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    r2 = torch.tensor(radii ** 2, dtype=torch.float32, device=device)
    chunk = max(1, (1 << 25) // (h * w))
    video = torch.empty(b, h, w, 3, dtype=torch.float32, device=device)
    for t in range(b):
        c = torch.tensor(centers + t * vels, dtype=torch.float32, device=device)
        label = torch.zeros(h, w, dtype=torch.long, device=device)
        for i0 in range(0, n, chunk):
            cy = c[i0:i0 + chunk, 0, None, None]
            cx = c[i0:i0 + chunk, 1, None, None]
            inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= r2[i0:i0 + chunk, None, None]
            idx = torch.arange(i0 + 1, i0 + 1 + inside.shape[0], device=device)[:, None, None]
            label = torch.maximum(label, (inside * idx).amax(0))
        video[t] = palette[label]
    return video


def mosaic_rggb(rgb: Tensor) -> Tensor:
    """``(B, H, W, 3)`` -> RGGB mosaic ``(B, H, W)``."""
    out = rgb[..., 1].clone()
    out[:, 0::2, 0::2] = rgb[:, 0::2, 0::2, 0]
    out[:, 1::2, 1::2] = rgb[:, 1::2, 1::2, 2]
    return out


class Traffic(NamedTuple):
    masks: Tensor                 # (B, H, W) float32 on the device
    measurements: list[Tensor]    # the pool's snapshots (H, W), float32 on the host (page-locked)
    order: np.ndarray             # the pool index of request i is order[i % len(order)]
    sample: list[int]             # the window's requests the reference recomputes


def make(spec: dict, seed: int, device: torch.device | str) -> Traffic:
    """The masks, the scene pool's measurements and the request plan of one
    run of ``spec`` (a traffic file) with ``seed``."""
    b, h, w = int(spec["frames"]), int(spec["height"]), int(spec["width"])
    if spec["style"] not in STYLES:
        raise ValueError(f"unknown scene style {spec['style']!r}; have {STYLES}")
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, MASKS))
    masks = (torch.rand((b, h, w), generator=g, device=device) > 0.5).float()
    meas = []
    for k in range(int(spec["pool"])):
        rng = np.random.default_rng(sub_seed(seed, SCENES, k))
        bayer = mosaic_rggb(leaves_video(b, h, w, rng, device))
        y = (bayer * masks).sum(0).cpu()
        meas.append(y.pin_memory() if y.device != bayer.device else y)
    order = np.random.default_rng(sub_seed(seed, ORDER)).permutation(int(spec["pool"]))
    among = max(int(spec["check_among_first"]), int(spec["check_requests"]))
    sample = np.random.default_rng(sub_seed(seed, SAMPLE)).choice(
        among, int(spec["check_requests"]), replace=False)
    return Traffic(masks, meas, order, sorted(int(i) for i in sample))


def noise_seed(seed: int, request: int) -> int:
    """The seed of the adaptation-noise generator of request ``request``
    (negative: a warm-up request)."""
    return sub_seed(seed, NOISE, request % 2 ** 32, int(request < 0))
