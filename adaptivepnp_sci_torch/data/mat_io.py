"""MATLAB ``.mat`` scene and result I/O (port of
``adaptivepnp_sci_tpu.data.mat_io``; NumPy and SciPy only, the same arrays
as the JAX package for the same file).

The data contract of the upstream reconstruction scripts:

  * the scene ``.mat``, v7.3 (HDF5) or v5, with keys ``meas_bayer (H, W[, T])``,
    ``mask_bayer (H, W, B)``, optional ``orig_bayer (H, W, T*B)`` and ``orig``
    (MATLAB shapes; an HDF5 reader sees them reversed, and the loader turns
    them back). ``meas_bayer`` and ``orig_bayer`` are divided by ``maxb``;
  * the warm-start ``.mat`` (v5) with key ``v_Admm_tv_denoise (H, W, B*T)``;
  * the results ``.mat``: the reconstruction, PSNR/SSIM and the
    per-iteration trace ``psnr_all_iter``.

In memory: ``meas (T, H, W)``, ``mask (B, H, W)``, ``orig (T, B, H, W)``.
A v7.3 file needs ``h5py``; without it such a file is refused, never read
as something else.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


@dataclass
class SceneData:
    name: str
    meas: np.ndarray        # (T, H, W) snapshots, float32 in [0, ~B]
    mask: np.ndarray        # (B, H, W) float32 binary
    orig_bayer: np.ndarray | None  # (T, B, H, W) ground truth or None
    #: the raw ``orig`` key (RGB ground truth), carried verbatim into results
    orig_real: np.ndarray | None = None
    #: the MAXB the measurement and ground truth were divided by at load time
    maxb: float = 255.0

    @property
    def n_meas(self) -> int:
        return self.meas.shape[0]

    @property
    def n_frames(self) -> int:
        return self.mask.shape[0]


def is_hdf5(path: str) -> bool:
    """Whether ``path`` is an HDF5 file (a MATLAB v7.3 ``.mat``): the HDF5
    signature at offset 0 or at a power-of-two offset from 512 on, where
    MATLAB's 512-byte header puts it."""
    with open(path, "rb") as f:
        head = f.read(len(_HDF5_SIGNATURE))
        if head == _HDF5_SIGNATURE:
            return True
        offset = 512
        while True:
            f.seek(offset)
            head = f.read(len(_HDF5_SIGNATURE))
            if len(head) < len(_HDF5_SIGNATURE):
                return False
            if head == _HDF5_SIGNATURE:
                return True
            offset *= 2


def _read_hdf5(path: str):
    import h5py

    with h5py.File(path, "r") as f:
        raw = {k: np.asarray(f[k]) for k in f.keys() if not k.startswith("#")}
    # h5py yields MATLAB arrays transposed: meas_bayer (W, H) or (T, W, H),
    # mask_bayer (B, W, H); the spatial axes are turned back to (H, W)
    meas = raw["meas_bayer"]
    mask = raw["mask_bayer"]
    orig = raw.get("orig_bayer")
    orig_real = raw.get("orig")
    if meas.ndim == 2:
        meas = meas.T[None]                    # (1, H, W)
    else:
        meas = np.transpose(meas, (0, 2, 1))   # (T, H, W)
    mask = np.transpose(mask, (0, 2, 1))       # (B, H, W)
    if orig is not None:
        orig = np.transpose(orig, (0, 2, 1))   # (T*B, H, W)
    return meas, mask, orig, orig_real


def _read_v5(path: str):
    import scipy.io as sio

    raw = sio.loadmat(path)
    meas = raw["meas_bayer"].astype(np.float32)
    mask = raw["mask_bayer"]
    orig = raw.get("orig_bayer")
    orig_real = raw.get("orig")
    # scipy yields MATLAB shapes directly: meas (H, W[, T]), mask (H, W, B)
    meas = meas[None] if meas.ndim == 2 else np.transpose(meas, (2, 0, 1))
    mask = np.transpose(mask, (2, 0, 1))
    if orig is not None:
        orig = np.transpose(orig, (2, 0, 1))
    return meas, mask, orig, orig_real


def load_cacti_mat(path: str, name: str = "", maxb: float = 255.0) -> SceneData:
    """Read a CACTI scene from a ``.mat`` file (v7.3 HDF5 or v5).

    ``meas_bayer`` and ``orig_bayer`` are divided by ``maxb``
    UNCONDITIONALLY, as the upstream scripts divide by MAXB: a float-stored
    0-255 scene must still be scaled. Pass ``maxb=1.0`` for data already in
    [0, 1]. The mask is never scaled.

    With ``h5py`` installed the file is tried as HDF5 first and read with
    SciPy when that fails, as the JAX package does. Without it a v7.3 file
    raises ``ImportError`` naming ``h5py``.
    """
    try:
        import h5py  # noqa: F401
    except ImportError:
        if is_hdf5(path):
            raise ImportError(
                f"{path} is a MATLAB v7.3 (HDF5) file; reading it needs h5py, "
                "which is not installed") from None
        meas, mask, orig, orig_real = _read_v5(path)
    else:
        try:
            meas, mask, orig, orig_real = _read_hdf5(path)
        except (OSError, KeyError):
            meas, mask, orig, orig_real = _read_v5(path)

    meas = np.asarray(meas).astype(np.float32) / maxb
    mask = np.asarray(mask).astype(np.float32)
    b = mask.shape[0]
    if orig is not None:
        orig = np.asarray(orig).astype(np.float32) / maxb
        t = orig.shape[0] // b
        orig = orig[: t * b].reshape(t, b, *orig.shape[1:])
    return SceneData(name=name, meas=meas, mask=mask, orig_bayer=orig,
                     orig_real=orig_real, maxb=maxb)


def save_warm_start(path: str, recon: np.ndarray) -> None:
    """Write the warm-start contract: key ``v_Admm_tv_denoise`` shaped
    ``(H, W, B*T)`` from ``recon (T, B, H, W)``."""
    import scipy.io as sio

    t, b, h, w = recon.shape
    flat = np.transpose(recon.reshape(t * b, h, w), (1, 2, 0))
    sio.savemat(path, {"v_Admm_tv_denoise": flat})


def load_warm_start(path: str, n_frames: int) -> np.ndarray:
    """Read ``v_Admm_tv_denoise (H, W, B*T)`` -> ``(T, B, H, W)``."""
    import scipy.io as sio

    flat = sio.loadmat(path)["v_Admm_tv_denoise"].astype(np.float32)
    h, w, tb = flat.shape
    t = tb // n_frames
    return np.transpose(flat, (2, 0, 1)).reshape(t, n_frames, h, w)


def save_results(
    path: str,
    x_bayer: np.ndarray,            # (T, B, H, W)
    x_rgb: np.ndarray | None,       # (T, B, H, W, 3)
    psnr: np.ndarray,
    ssim: np.ndarray,
    psnr_all_iter: np.ndarray,
    meta: dict | None = None,
    orig_real: np.ndarray | None = None,
    meas_bayer: np.ndarray | None = None,
) -> None:
    """Write the results with the upstream scripts' key set: ``v_recon_bayer
    (H, W, T*B)``, ``psnr``, ``ssim``, ``psnr_all_iter``, ``v_recon_rgb
    (H, W, 3, T*B)`` when given, the verbatim RGB ground truth ``orig_real``
    and the unscaled measurement ``meas_bayer`` when given, and ``meta``."""
    import scipy.io as sio

    t, b, h, w = x_bayer.shape
    out = {
        "v_recon_bayer": np.transpose(x_bayer.reshape(t * b, h, w), (1, 2, 0)),
        "psnr": np.asarray(psnr),
        "ssim": np.asarray(ssim),
        "psnr_all_iter": np.asarray(psnr_all_iter),
    }
    if orig_real is not None:
        out["orig_real"] = np.asarray(orig_real)
    if meas_bayer is not None:
        out["meas_bayer"] = np.asarray(meas_bayer)
    if x_rgb is not None:
        out["v_recon_rgb"] = np.transpose(x_rgb.reshape(t * b, h, w, 3), (1, 2, 3, 0))
    if meta:
        out.update(meta)
    sio.savemat(path, out)
