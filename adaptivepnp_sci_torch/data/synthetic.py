"""Synthetic CACTI Bayer scenes for tests and benchmarks
(port of ``adaptivepnp_sci_tpu.data.synthetic``; NumPy only, with its own
``cfa_masks``, and the same numbers as the JAX package for the same seed).

An RGB video cube is CFA-mosaicked per frame, modulated by per-frame binary
masks, and collapsed into one snapshot per group of B frames, the
acquisition model of the upstream reconstruction scripts. The photograph
styles read the decoded pixels of ``assets/photos.npz`` (no PIL, no
matplotlib; provenance in ``assets/README.md``) and resample them with SciPy,
as the JAX package does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

#: RGGB plane offsets, plane order [R, G1, G2, B].
BAYER_OFFSETS = ((0, 0), (0, 1), (1, 0), (1, 1))


def cfa_masks(shape: tuple[int, int], pattern: str = "RGGB") -> np.ndarray:
    """Boolean CFA masks ``(H, W, 3)`` (a NumPy-only copy of
    :func:`adaptivepnp_sci_torch.ops.bayer.cfa_masks`)."""
    pattern = pattern.upper()
    masks = {c: np.zeros(shape, dtype=bool) for c in "RGB"}
    for channel, (y, x) in zip(pattern, BAYER_OFFSETS):
        masks[channel][y::2, x::2] = True
    return np.stack([masks[c] for c in "RGB"], axis=-1)


@dataclass
class Scene:
    """One CACTI measurement group.

    Attributes:
      meas:       snapshot measurement(s) ``(H, W)`` or ``(H, W, T)``.
      mask:       binary Bayer-domain masks ``(B, H, W)``.
      orig_bayer: ground-truth mosaicked frames ``(B, H, W)`` (or ``(T, B, H, W)``).
      orig_rgb:   ground-truth RGB frames ``(B, H, W, 3)``.
    """

    meas: np.ndarray
    mask: np.ndarray
    orig_bayer: np.ndarray
    orig_rgb: np.ndarray


def _smooth_video(b: int, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Piecewise-smooth moving scene in [0,1]: drifting gaussian blobs +
    gradients, so TV/denoiser priors have structure to exploit."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    video = np.zeros((b, h, w, 3), np.float32)
    n_blobs = 6
    centers = rng.random((n_blobs, 2)).astype(np.float32)
    vels = (rng.random((n_blobs, 2)).astype(np.float32) - 0.5) * 0.06
    colors = rng.random((n_blobs, 3)).astype(np.float32)
    widths = (0.05 + 0.15 * rng.random(n_blobs)).astype(np.float32)
    base = np.stack([0.25 + 0.5 * xx, 0.25 + 0.5 * yy, 0.5 * (xx + yy)], -1)
    for t in range(b):
        frame = base.copy()
        for i in range(n_blobs):
            cy, cx = centers[i] + t * vels[i]
            g = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * widths[i] ** 2)))
            frame += g[..., None] * (colors[i] - 0.5)
        video[t] = frame
    lo, hi = video.min(), video.max()
    return (video - lo) / max(hi - lo, 1e-6)


def _texture_video(length: int, h: int, rng: np.random.Generator,
                   w: int | None = None) -> np.ndarray:
    """Drifting oriented gratings + hard-edged rectangles, zero-mean-ish."""
    w = h if w is None else w
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    out = np.zeros((length, h, w, 3), np.float32)
    # gratings
    for _ in range(rng.integers(1, 4)):
        theta = rng.uniform(0, np.pi)
        freq = rng.uniform(4, 24)
        phase_v = rng.uniform(-0.5, 0.5)
        amp = rng.uniform(0.05, 0.25)
        color = rng.uniform(0.5, 1.0, 3).astype(np.float32)
        base = freq * (np.cos(theta) * xx + np.sin(theta) * yy)
        for t in range(length):
            g = amp * np.sin(2 * np.pi * (base + phase_v * t))
            out[t] += g[..., None] * color
    # rectangles with hard edges
    for _ in range(rng.integers(1, 4)):
        h0 = rng.integers(0, h // 2)
        w0 = rng.integers(0, w // 2)
        hh = rng.integers(h // 8, h // 2)
        ww = rng.integers(w // 8, w // 2)
        vy, vx = rng.integers(-2, 3, 2)
        amp = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
        for t in range(length):
            y0 = int(np.clip(h0 + vy * t, 0, h - 2))
            x0 = int(np.clip(w0 + vx * t, 0, w - 2))
            out[t, y0 : y0 + hh, x0 : x0 + ww] += amp
    return out


def _dead_leaves_video(b: int, h: int, w: int,
                       rng: np.random.Generator) -> np.ndarray:
    """Dead-leaves model with motion: occluding disks whose radii follow the
    scale-invariant ``p(r) ~ r^-3`` law (Matheron/Lee-Mumford-Huang — the
    standard generative model reproducing natural-image statistics: occlusion
    edges at all scales, heavy-tailed gradients, ~1/f^2 power spectra). Each
    disk drifts with its own velocity, giving the video real motion parallax
    for the temporal priors. Painted back-to-front; later disks occlude."""
    rmin, rmax = max(2.0, h / 170), h / 4
    n_disks = 400
    u = rng.random(n_disks)
    # inverse-CDF of p(r) ~ r^-3 truncated to [rmin, rmax]
    radii = rmin / np.sqrt(1.0 - u * (1.0 - (rmin / rmax) ** 2))
    centers = rng.random((n_disks, 2)) * [h, w]
    vels = rng.uniform(-3.0, 3.0, (n_disks, 2)) * (h / 512.0)
    # natural-ish colors: shared luminance + moderate chroma
    lum = rng.uniform(0.15, 0.85, n_disks)
    colors = np.clip(
        lum[:, None] + rng.uniform(-0.25, 0.25, (n_disks, 3)), 0.0, 1.0
    ).astype(np.float32)

    video = np.full((b, h, w, 3), 0.5, np.float32)
    for t in range(b):
        for i in range(n_disks):  # back-to-front: disk i+1 occludes disk i
            cy, cx = centers[i] + t * vels[i]
            r = radii[i]
            y0, y1 = int(max(cy - r, 0)), int(min(cy + r + 1, h))
            x0, x1 = int(max(cx - r, 0)), int(min(cx + r + 1, w))
            if y0 >= y1 or x0 >= x1:
                continue
            yy = np.arange(y0, y1, dtype=np.float32)[:, None] - cy
            xx = np.arange(x0, x1, dtype=np.float32)[None, :] - cx
            inside = yy * yy + xx * xx <= r * r
            video[t, y0:y1, x0:x1][inside] = colors[i]
    return video


_PHOTO_CACHE: dict[tuple[str, float], np.ndarray] = {}

#: The real photographs of ``assets/photos.npz``: matplotlib's bundled
#: grace_hopper portrait and the IPOL FFDNet demo photograph (a stone village
#: street: natural texture, depth edges, foliage).
PHOTO_SOURCES = ("hopper", "street")

_PHOTOS_NPZ = os.path.join(os.path.dirname(__file__), "assets", "photos.npz")


def _photo_source(scale: float = 1.0, name: str = "hopper") -> np.ndarray:
    """A photograph as float32 ``(H, W, 3)`` in [0, 1] (``uint8 / 255``),
    zoomed bilinearly per channel when ``scale > 1``, cached per
    ``(name, round(scale, 4))``: ``make_scene(style='photo', n_meas=N)`` and
    the training clips resample the same base images again and again."""
    key = (name, round(float(scale), 4))
    if key not in _PHOTO_CACHE:
        from scipy.ndimage import zoom

        if name not in PHOTO_SOURCES:
            raise ValueError(f"unknown photo source {name!r}; have {PHOTO_SOURCES}")
        with np.load(_PHOTOS_NPZ) as photos:
            img = photos[name].astype(np.float32) / 255.0
        if key[1] > 1.0:
            img = np.stack(
                [zoom(img[..., c], key[1], order=1) for c in range(3)], axis=-1
            )
        _PHOTO_CACHE[key] = img
    return _PHOTO_CACHE[key]


def _photo_video(b: int, h: int, w: int, rng: np.random.Generator,
                 source: str = "hopper") -> np.ndarray:
    """Real-photograph video: a global subpixel camera pan over ``source``
    (an entry of :data:`PHOTO_SOURCES`), bilinear resampling per frame."""
    from scipy.ndimage import map_coordinates

    # per-frame pan velocity (px/frame) + margin for the travel
    vy = float(rng.uniform(1.0, 3.0)) * (1 if rng.random() < 0.5 else -1)
    vx = float(rng.uniform(0.2, 1.0)) * (1 if rng.random() < 0.5 else -1)
    img = _photo_source(name=source)
    need_h = h + abs(vy) * (b - 1) + 2
    need_w = w + abs(vx) * (b - 1) + 2
    s = max(need_h / img.shape[0], need_w / img.shape[1], 1.0)
    if s > 1.0:
        img = _photo_source(s, name=source)
    y_slack = img.shape[0] - h - abs(vy) * (b - 1) - 1
    x_slack = img.shape[1] - w - abs(vx) * (b - 1) - 1
    y0 = float(rng.uniform(0, max(y_slack, 0))) + (abs(vy) * (b - 1) if vy < 0 else 0)
    x0 = float(rng.uniform(0, max(x_slack, 0))) + (abs(vx) * (b - 1) if vx < 0 else 0)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    video = np.empty((b, h, w, 3), np.float32)
    for t in range(b):
        cy, cx = y0 + vy * t, x0 + vx * t
        coords = np.stack([yy + cy, xx + cx])
        for c in range(3):
            video[t, ..., c] = map_coordinates(
                img[..., c], coords, order=1, mode="reflect"
            )
    return np.clip(video, 0.0, 1.0)


def _photos_video(b: int, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Multi-source real-photograph video under a similarity camera path:
    the photograph drawn from :data:`PHOTO_SOURCES`, then per frame a pan, a
    slow zoom and a slow roll, so the optical flow is not one global vector
    (the training-pool variant of :func:`_photo_video`)."""
    from scipy.ndimage import map_coordinates

    name = PHOTO_SOURCES[int(rng.integers(len(PHOTO_SOURCES)))]
    img = _photo_source(name=name)
    # camera path: pan velocity (px/frame), zoom rate and roll rate per frame
    vy = float(rng.uniform(-3.0, 3.0))
    vx = float(rng.uniform(-3.0, 3.0))
    zoom_rate = float(rng.uniform(-0.008, 0.008))   # ±0.8 %/frame
    roll_rate = float(rng.uniform(-0.008, 0.008))   # ±0.46°/frame
    # the source must hold the rotated, zoomed-out crop plus the pan travel
    margin = 1.3  # rotation/zoom-out slack on the crop diagonal
    need = max(
        margin * h + abs(vy) * (b - 1) + 2, margin * w + abs(vx) * (b - 1) + 2
    )
    s = max(need / img.shape[0], need / img.shape[1], 1.0)
    if s > 1.0:
        img = _photo_source(s, name=name)
    ih, iw = img.shape[:2]
    # random crop centre with slack for the pan travel
    cy0 = float(rng.uniform(margin * h / 2, ih - margin * h / 2 - abs(vy) * (b - 1)))
    cx0 = float(rng.uniform(margin * w / 2, iw - margin * w / 2 - abs(vx) * (b - 1)))
    cy0 += abs(vy) * (b - 1) if vy < 0 else 0.0
    cx0 += abs(vx) * (b - 1) if vx < 0 else 0.0

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    gy, gx = yy - (h - 1) / 2.0, xx - (w - 1) / 2.0  # crop-centred grid
    video = np.empty((b, h, w, 3), np.float32)
    for t in range(b):
        theta = roll_rate * t
        scale = (1.0 + zoom_rate) ** t
        ct, st = np.cos(theta) / scale, np.sin(theta) / scale
        sy = cy0 + vy * t + ct * gy - st * gx
        sx = cx0 + vx * t + st * gy + ct * gx
        coords = np.stack([sy, sx])
        for c in range(3):
            video[t, ..., c] = map_coordinates(
                img[..., c], coords, order=1, mode="reflect"
            )
    return np.clip(video, 0.0, 1.0)


def make_scene(
    b: int = 8,
    h: int = 512,
    w: int = 512,
    seed: int = 42,
    n_meas: int = 1,
    textured: bool = False,
    style: str | None = None,
    photo_source: str | None = None,
) -> Scene:
    """Synthesize ``n_meas`` CACTI snapshots of a B-frame RGB video.

    ``style`` selects the scene statistics:

    * ``'smooth'`` (default) — drifting gaussian blobs + gradients; an easy
      regime the priors exploit fully (~50 dB).
    * ``'textured'`` (= legacy ``textured=True``) — adds drifting oriented
      gratings and hard-edged rectangles; high-frequency content the priors
      must preserve (realistic ~35 dB regime).
    * ``'leaves'`` — dead-leaves occlusion model with per-disk motion;
      natural-image statistics (scale-invariant edges, heavy-tailed
      gradients), the closest stand-in for real captures available without
      shipping data.
    * ``'photo'`` — a real photograph (``photo_source``: ``'hopper'``, the
      default, or ``'street'``) under a smooth global camera pan.
    * ``'photos'`` — a real photograph drawn from :data:`PHOTO_SOURCES` under
      a pan + zoom + roll camera path; the training-pool variant.
    """
    if style is None:
        style = "textured" if textured else "smooth"
    if style not in ("smooth", "textured", "leaves", "photo", "photos"):
        raise ValueError(f"unknown scene style {style!r}")
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, h, w)) > 0.5).astype(np.float32)

    cfa = cfa_masks((h, w)).astype(np.float32)

    metas, origs_b, origs_rgb = [], [], []
    for i in range(n_meas):
        if style == "leaves":
            rgb = _dead_leaves_video(b, h, w, rng)
        elif style == "photo":
            rgb = _photo_video(b, h, w, rng, source=photo_source or "hopper")
        elif style == "photos":
            rgb = _photos_video(b, h, w, rng)
        else:
            rgb = _smooth_video(b, h, w, rng)
        if style == "textured":
            rgb = np.clip(rgb + _texture_video(b, h, rng, w), 0.0, 1.0)
        bayer = (rgb * cfa).sum(-1)  # (B, H, W)
        metas.append((bayer * mask).sum(0))  # (H, W)
        origs_b.append(bayer)
        origs_rgb.append(rgb)

    if n_meas == 1:
        return Scene(metas[0], mask, origs_b[0], origs_rgb[0])
    return Scene(
        np.stack(metas, -1), mask, np.stack(origs_b), np.stack(origs_rgb)
    )
