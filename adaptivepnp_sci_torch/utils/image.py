"""KAIR-style image utilities, host-side NumPy in NHWC (port of
``adaptivepnp_sci_tpu.utils.image``).

The reference's image-utility zoo (``packages/DDnet/utils_image.py``):
paths and image IO, dtype and layout converters, the 8-mode dihedral
augmentation, the MATLAB colour-space transforms, mod-crop and shave, and
the KAIR/MATLAB PSNR and gaussian-window SSIM in the 0-255 domain.
Layouts are NHWC / ``(H, W, C)`` as in the JAX package, whose array
converters stand in for the reference's NCHW tensor converters. Image IO
uses PIL, imported only by :func:`imread_uint` and :func:`imsave`.
The on-device metrics are in :mod:`adaptivepnp_sci_torch.ops.metrics`, the
MATLAB bicubic resize in :mod:`adaptivepnp_sci_torch.ops.resize`
(re-exported here).
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np

from adaptivepnp_sci_torch.ops.resize import imresize  # noqa: F401  (re-export)

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


# ---------------------------------------------------------------------------
# paths / IO
# ---------------------------------------------------------------------------

def is_image_file(filename: str) -> bool:
    return filename.lower().endswith(IMG_EXTENSIONS)


def get_timestamp() -> str:
    return datetime.now().strftime("%y%m%d-%H%M%S")


def get_image_paths(dataroot: str) -> list[str]:
    """All image files under ``dataroot``, sorted (``utils_image.py:66-89``)."""
    paths = []
    for dirpath, _, fnames in sorted(os.walk(dataroot)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                paths.append(os.path.join(dirpath, fname))
    return paths


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def mkdirs(paths) -> None:
    if isinstance(paths, str):
        mkdir(paths)
    else:
        for p in paths:
            mkdir(p)


def mkdir_and_rename(path: str) -> None:
    """If ``path`` exists, archive it as ``path_archived_<ts>`` then recreate."""
    if os.path.exists(path):
        os.rename(path, path + "_archived_" + get_timestamp())
    os.makedirs(path)


def _pil_image():
    """PIL's ``Image`` module, imported at the first image read or write: the
    rest of this module (and the package) needs no PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading and writing image files needs PIL (the Pillow "
                          "package), which is not installed") from e
    return Image


def imread_uint(path: str, n_channels: int = 3) -> np.ndarray:
    """Read an image as uint8 ``(H, W, n_channels)`` (PIL backend)."""
    img = _pil_image().open(path)
    if n_channels == 1:
        img = img.convert("L")
        return np.asarray(img, np.uint8)[..., None]
    img = img.convert("RGB")
    return np.asarray(img, np.uint8)


def imsave(img: np.ndarray, img_path: str) -> None:
    """Save a uint8 ``(H, W[, C])`` image."""
    img = np.squeeze(np.asarray(img, np.uint8))
    _pil_image().fromarray(img).save(img_path)


# ---------------------------------------------------------------------------
# dtype converters (``utils_image.py:182-276``)
# ---------------------------------------------------------------------------

def uint2single(img: np.ndarray) -> np.ndarray:
    return np.float32(img / 255.0)


def single2uint(img: np.ndarray) -> np.ndarray:
    return np.uint8((np.clip(img, 0.0, 1.0) * 255.0).round())


def uint162single(img: np.ndarray) -> np.ndarray:
    return np.float32(img / 65535.0)


def single2uint16(img: np.ndarray) -> np.ndarray:
    return np.uint16((np.clip(img, 0.0, 1.0) * 65535.0).round())


def uint2array4(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W[, C]) -> float32 (1, H, W, C) in [0, 1]
    (the torch ``uint2tensor4``, NHWC here)."""
    if img.ndim == 2:
        img = img[..., None]
    return uint2single(img)[None]


def uint2array3(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W[, C]) -> float32 (H, W, C) in [0, 1]."""
    if img.ndim == 2:
        img = img[..., None]
    return uint2single(img)


def array2uint(img: np.ndarray) -> np.ndarray:
    """float array in [0, 1] (any leading dims) -> squeezed uint8."""
    return single2uint(np.squeeze(np.asarray(img)))


def single2array4(img: np.ndarray) -> np.ndarray:
    return np.asarray(img, np.float32)[None]


def single2array5(img: np.ndarray) -> np.ndarray:
    return np.asarray(img, np.float32)[None, None]


def array2single(img: np.ndarray) -> np.ndarray:
    return np.squeeze(np.asarray(img, np.float32))


def array2img(arr: np.ndarray, out_type=np.uint8,
              min_max: tuple[float, float] = (0.0, 1.0)) -> np.ndarray:
    """Clamp to ``min_max``, rescale to [0, 1], convert (``tensor2img``).

    Accepts (H, W), (H, W, C) or (N, H, W, C); batches are returned with the
    batch axis intact.
    """
    arr = np.asarray(arr, np.float64)
    arr = np.clip(arr, *min_max)
    arr = (arr - min_max[0]) / (min_max[1] - min_max[0])
    if out_type == np.uint8:
        return np.uint8((arr * 255.0).round())
    return arr.astype(out_type)


# ---------------------------------------------------------------------------
# augmentation (``utils_image.py:316-427``): the 8-element dihedral group,
# same mode numbering as the reference's ``augment_img``
# ---------------------------------------------------------------------------

def augment_img(img: np.ndarray, mode: int = 0) -> np.ndarray:
    """Flip/rotate ``(H, W[, C])`` by KAIR mode 0-7."""
    if mode == 0:
        return img
    if mode == 1:
        return np.flipud(np.rot90(img))
    if mode == 2:
        return np.flipud(img)
    if mode == 3:
        return np.rot90(img, k=3)
    if mode == 4:
        return np.flipud(np.rot90(img, k=2))
    if mode == 5:
        return np.rot90(img)
    if mode == 6:
        return np.rot90(img, k=2)
    if mode == 7:
        return np.flipud(np.rot90(img, k=3))
    raise ValueError(f"mode must be 0-7, got {mode}")


def augment_imgs(img_list, hflip: bool = True, rot: bool = True, rng=None):
    """Apply one random flip/rotation consistently to every image in the
    list (``utils_image.py:399-427``)."""
    rng = rng or np.random.default_rng()
    do_h = hflip and rng.random() < 0.5
    do_v = rot and rng.random() < 0.5
    do_r = rot and rng.random() < 0.5

    def _aug(img):
        if do_h:
            img = img[:, ::-1]
        if do_v:
            img = img[::-1]
        if do_r:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.T
        return img

    return [_aug(img) for img in img_list]


# ---------------------------------------------------------------------------
# color spaces — MATLAB-exact coefficient matrices (``utils_image.py:429-495``)
# ---------------------------------------------------------------------------

_YCBCR_FROM_RGB = np.array(
    [[65.481, -37.797, 112.0],
     [128.553, -74.203, -93.786],
     [24.966, 112.0, -18.214]], np.float64)
_RGB_FROM_YCBCR = np.array(
    [[0.00456621, 0.00456621, 0.00456621],
     [0.0, -0.00153632, 0.00791071],
     [0.00625893, -0.00318811, 0.0]], np.float64)


def _color_convert(img, fn):
    in_type = img.dtype
    x = np.asarray(img, np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    out = fn(x)
    if in_type == np.uint8:
        return np.uint8(out.round())
    return (out / 255.0).astype(in_type)


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """MATLAB ``rgb2ycbcr``: uint8 in [0,255] or float in [0,1]."""
    def fn(x):
        if only_y:
            return x @ _YCBCR_FROM_RGB[:, 0] / 255.0 + 16.0
        return x @ _YCBCR_FROM_RGB / 255.0 + np.array([16.0, 128.0, 128.0])

    return _color_convert(img, fn)


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """BGR-order variant (cv2-loaded images)."""
    def fn(x):
        m = _YCBCR_FROM_RGB[::-1]
        if only_y:
            return x @ m[:, 0] / 255.0 + 16.0
        return x @ m / 255.0 + np.array([16.0, 128.0, 128.0])

    return _color_convert(img, fn)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """MATLAB ``ycbcr2rgb`` (inverse of :func:`rgb2ycbcr`)."""
    def fn(x):
        return x @ _RGB_FROM_YCBCR * 255.0 + np.array(
            [-222.921, 135.576, -276.836])

    return _color_convert(img, fn)


def channel_convert(in_c: int, tar_type: str, img_list):
    """Batch color conversion (``utils_image.py:521-537``)."""
    if in_c == 3 and tar_type == "gray":
        return [rgb2ycbcr(img, only_y=True)[..., None] for img in img_list]
    if in_c == 3 and tar_type == "y":
        return [rgb2ycbcr(img, only_y=True)[..., None] for img in img_list]
    if in_c == 1 and tar_type == "RGB":
        return [np.repeat(img, 3, axis=2) for img in img_list]
    return img_list


# ---------------------------------------------------------------------------
# crops (``utils_image.py:497-518``)
# ---------------------------------------------------------------------------

def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H and W to multiples of ``scale``."""
    h, w = img.shape[0] - img.shape[0] % scale, img.shape[1] - img.shape[1] % scale
    return img[:h, :w].copy()


def shave(img: np.ndarray, border: int = 0) -> np.ndarray:
    if border == 0:
        return img
    return img[border:-border, border:-border].copy()


# ---------------------------------------------------------------------------
# metrics: KAIR/MATLAB semantics, 0-255 domain (``utils_image.py:545-630``)
# ---------------------------------------------------------------------------

def calculate_psnr(img1: np.ndarray, img2: np.ndarray, border: int = 0) -> float:
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    img1 = shave(np.asarray(img1, np.float64), border)
    img2 = shave(np.asarray(img2, np.float64), border)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(255.0 / np.sqrt(mse)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def _filter2_valid(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    """'valid' 2-D correlation with a small window."""
    kh, kw = window.shape
    h, w = img.shape
    shape = (h - kh + 1, w - kw + 1, kh, kw)
    patches = np.lib.stride_tricks.as_strided(img, shape, img.strides * 2)
    return np.einsum("hwkl,kl->hw", patches, window)


def ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    """MATLAB-style single-channel SSIM, 0-255 domain, 11x11 gaussian
    window sigma=1.5, valid region only."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    win = _gaussian_window()
    mu1 = _filter2_valid(img1, win)
    mu2 = _filter2_valid(img2, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _filter2_valid(img1 ** 2, win) - mu1_sq
    s2 = _filter2_valid(img2 ** 2, win) - mu2_sq
    s12 = _filter2_valid(img1 * img2, win) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray, border: int = 0) -> float:
    """Mean per-channel SSIM over (H, W), (H, W, C) or (N, H, W, C)."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    img1, img2 = np.asarray(img1), np.asarray(img2)
    if border:
        img1, img2 = shave(img1, border), shave(img2, border)
    if img1.ndim == 2:
        return ssim_single(img1, img2)
    if img1.ndim == 3:
        return float(np.mean([ssim_single(img1[..., c], img2[..., c])
                              for c in range(img1.shape[-1])]))
    if img1.ndim == 4:
        return float(np.mean([calculate_ssim(img1[i], img2[i]) for i in range(img1.shape[0])]))
    raise ValueError("Wrong input image dimensions.")
