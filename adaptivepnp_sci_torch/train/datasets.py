"""Training data (port of ``adaptivepnp_sci_tpu.train.datasets``; NumPy only).

* :func:`extract_patches`: multiscale strided patches, the FFDNet pipeline's
  (scales 1/0.9/0.8/0.7, ``packages/ffdnet/dataset.py:24-145``);
* :func:`temporal_chunks`: 5-frame training windows from video arrays;
* :func:`synthetic_video_dataset`: procedural clips from
  :mod:`adaptivepnp_sci_torch.data.synthetic`, the same numbers as the JAX
  package for the same seed;
* :func:`load_array_dir`: the ``.npy``/``.npz`` arrays of a directory (read
  with ``np.load``; the JAX package's native prefetch ring is not ported);
* the HDF5 patch database (needs ``h5py``; refused by name without it);
* shuffled epoch iterators over arrays, one host batch per step.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from adaptivepnp_sci_torch.data.native_loader import iter_npy_prefetched

FFDNET_SCALES = (1.0, 0.9, 0.8, 0.7)


def _rescale(img: np.ndarray, scale: float) -> np.ndarray:
    """Nearest-neighbour rescale (data preparation only)."""
    if scale == 1.0:
        return img
    h, w = img.shape[:2]
    nh, nw = int(h * scale), int(w * scale)
    yi = (np.arange(nh) / scale).astype(np.int32).clip(0, h - 1)
    xi = (np.arange(nw) / scale).astype(np.int32).clip(0, w - 1)
    return img[yi][:, xi]


def extract_patches(img: np.ndarray, patch: int, stride: int,
                    scales: tuple[float, ...] = FFDNET_SCALES) -> np.ndarray:
    """Multiscale strided patches of one image ``(H, W, C) -> (N, p, p, C)``."""
    out = []
    for s in scales:
        im = _rescale(img, s)
        h, w = im.shape[:2]
        for y in range(0, h - patch + 1, stride):
            for x in range(0, w - patch + 1, stride):
                out.append(im[y:y + patch, x:x + patch])
    if not out:
        return np.zeros((0, patch, patch) + img.shape[2:], img.dtype)
    return np.stack(out)


def temporal_chunks(video: np.ndarray, length: int = 5, stride: int = 3) -> np.ndarray:
    """Overlapping temporal windows ``(T, H, W, C) -> (N, length, H, W, C)``."""
    t = video.shape[0]
    starts = list(range(0, max(t - length + 1, 1), stride))
    return np.stack([video[s:s + length] for s in starts if s + length <= t])


def synthetic_video_dataset(
    n_clips: int, length: int = 5, size: int = 96, seed: int = 0,
    textured: bool = False, source_sizes: tuple[int, ...] | None = None,
    crops_per_video: int = 8, styles: tuple[str, ...] | None = None,
) -> np.ndarray:
    """Procedural video clips ``(n, length, size, size, 3)`` in [0, 1].

    ``textured`` mixes in drifting gratings and rectangles (on even clip
    indices, or a coin per source video with ``source_sizes``). ``styles``,
    when given, draws each source video's scene family from ``'smooth'``,
    ``'textured'``, ``'leaves'``, ``'photo'`` (a pan over the portrait) and
    ``'photos'`` (either photograph under a pan + zoom + roll path; see
    :func:`~adaptivepnp_sci_torch.data.synthetic.make_scene`). ``source_sizes``: each
    clip is a random ``size``-square crop of a larger generated video whose
    side is drawn from this tuple, ``crops_per_video`` crops per video.
    ``styles=None`` keeps the JAX package's legacy random stream (the video
    drawn before the textured coin), so its seeds give the same clips.
    """
    from adaptivepnp_sci_torch.data.synthetic import (
        _dead_leaves_video,
        _photo_video,
        _photos_video,
        _smooth_video,
        _texture_video,
    )

    known = ("smooth", "textured", "leaves", "photo", "photos")
    if styles:
        bad = [s for s in styles if s not in known]
        if bad:
            raise ValueError(f"unknown clip style(s) {bad!r}; choose from {known}")

    rng = np.random.default_rng(seed)

    def generate(s: int) -> np.ndarray:
        style = styles[int(rng.integers(len(styles)))] if styles else None
        if style == "leaves":
            return _dead_leaves_video(length, s, s, rng)
        if style == "photo":
            return _photo_video(length, s, s, rng)
        if style == "photos":
            return _photos_video(length, s, s, rng)
        video = _smooth_video(length, s, s, rng)
        if style == "textured" or (style is None and textured and rng.random() < 0.5):
            video = np.clip(video + _texture_video(length, s, rng), 0, 1)
        return video

    clips = []
    if source_sizes:
        while len(clips) < n_clips:
            s = int(rng.choice(source_sizes))
            video = generate(s)
            for _ in range(min(crops_per_video, n_clips - len(clips))):
                y0 = int(rng.integers(0, s - size + 1))
                x0 = int(rng.integers(0, s - size + 1))
                clips.append(video[:, y0:y0 + size, x0:x0 + size])
        return np.stack(clips)
    for i in range(n_clips):
        if styles:
            clips.append(generate(size))
        else:
            # legacy direct generation: textured on even indices
            clip = _smooth_video(length, size, size, rng)
            if textured and i % 2 == 0:
                clip = np.clip(clip + _texture_video(length, size, rng), 0, 1)
            clips.append(clip)
    return np.stack(clips)


def load_array_dir(path: str) -> list[np.ndarray]:
    """All arrays of the ``.npy`` and ``.npz`` files of a directory (videos
    or images): the ``.npy`` files in name order, streamed through the
    native prefetch ring (:mod:`adaptivepnp_sci_torch.data.native_loader`),
    then each ``.npz``'s arrays, the files in name order."""
    names = sorted(os.listdir(path))
    npys = [os.path.join(path, n) for n in names if n.endswith(".npy")]
    arrays = list(iter_npy_prefetched(npys)) if npys else []
    for name in names:
        if name.endswith(".npz"):
            with np.load(os.path.join(path, name)) as z:
                arrays.extend(z[k] for k in z.files)
    return arrays


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("the patch database is an HDF5 file and needs h5py, "
                          "which is not installed") from e
    return h5py


def write_patch_db(path: str, patches: np.ndarray, chunk: int = 256) -> None:
    """Write a patch set as an HDF5 database (the FFDNet pipeline's
    ``prepare_patches`` file, ``packages/ffdnet/dataset.py:24-145``)."""
    h5py = _h5py()
    with h5py.File(path, "w") as f:
        f.create_dataset("patches", data=patches,
                         chunks=(min(chunk, len(patches)),) + patches.shape[1:])


def read_patch_db(path: str) -> np.ndarray:
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        return np.asarray(f["patches"])


def batch_iterator(data: np.ndarray, batch_size: int, seed: int = 0,
                   epochs: int | None = None) -> Iterator[np.ndarray]:
    """Shuffled epoch iterator over the leading axis."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(data))
        for i in range(0, len(data) - batch_size + 1, batch_size):
            yield data[order[i:i + batch_size]]
        epoch += 1


def paired_batch_iterator(arrays: tuple, batch_size: int, seed: int = 0,
                          epochs: int | None = None) -> Iterator[tuple]:
    """Shuffled epoch iterator over several same-length arrays at once (e.g.
    ``(clips, sigmas, flags)``), one shared permutation per epoch."""
    n = len(arrays[0])
    if not all(len(a) == n for a in arrays):
        raise ValueError(f"misaligned array lengths: {[len(a) for a in arrays]}")
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = order[i:i + batch_size]
            yield tuple(a[sel] for a in arrays)
        epoch += 1
