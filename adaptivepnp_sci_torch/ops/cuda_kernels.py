"""Hand-written CUDA kernels for Hopper and their wrappers
(port of ``adaptivepnp_sci_tpu.ops.pallas_kernels``).

Two kernels carry the flagship path, with the JAX package's wrapper names:

* ``csrc/x_update.cu``: the fused GAP / ADMM x-update
  (:func:`admm_x_update`, :func:`gap_x_update`);
* ``csrc/tv_chambolle.cu``: the channel-wise Chambolle TV prox with the
  per-plane early stop (:func:`tv_chambolle_fused`).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, into ``_build/`` beside the
package; the libraries are loaded with ``ctypes``. A library's file name
carries a hash of its source and flags, so an edited source is rebuilt.

A wrapper given CPU tensors runs the plain PyTorch version
(:mod:`.physics`, :mod:`.tv`). Given CUDA tensors it launches its kernel on
the current stream or raises; a failed build or launch is never caught to
fall back. :data:`launches` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch import Tensor

from adaptivepnp_sci_torch.ops import physics, tv

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: sources, one shared library each
SOURCES = {"x_update": CSRC / "x_update.cu", "tv_chambolle": CSRC / "tv_chambolle.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: kernel launches since the last :func:`reset_launches`, per kernel
launches = {"x_update": 0, "tv_chambolle": 0}

_libs: dict[str, ctypes.CDLL] = {}
#: ptxas register / shared-memory report of each library built in this process
build_log: dict[str, str] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str) -> Path:
    """nvcc one source into its library (skipped when it is already built)."""
    target = _lib_path(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {SOURCES[name].name}:\n{proc.stderr}")
    build_log[name] = proc.stderr
    os.replace(tmp, target)
    return target


def build() -> float:
    """Compile every kernel library (one ``nvcc`` per source, all started
    together) and load them; returns the seconds taken."""
    t0 = time.perf_counter()
    missing = [n for n in SOURCES if n not in _libs]
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        paths = dict(zip(missing, pool.map(_compile, missing)))
    for name, path in paths.items():
        _libs[name] = _bind(name, ctypes.CDLL(str(path)))
    return time.perf_counter() - t0


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    if name == "x_update":
        lib.apnp_x_update.argtypes = [p, p, p, p, p, p, i, ll, f, f, f, f, i, p]
        lib.apnp_x_update.restype = i
    else:
        lib.apnp_tv_chambolle.argtypes = [p, p, p, p, p, i, i, i, f, f, f, i, p]
        lib.apnp_tv_chambolle.restype = i
    return lib


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build()
    return _libs[name]


def _check(name: str, t: Tensor, shape: tuple[int, ...], device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _x_update_cuda(theta: Tensor, b: Tensor, y: Tensor, phi: Tensor, phi_s: Tensor,
                   sign: float, rho: float, c: float, lam: float) -> Tensor:
    if theta.dim() != 4:
        raise ValueError(f"x_update: expected theta (B, C, H, W), got {tuple(theta.shape)}")
    cube, plane = tuple(theta.shape), tuple(theta.shape[1:])
    dev = theta.device
    for nm, t, shp in (("theta", theta, cube), ("b", b, cube), ("phi", phi, cube),
                       ("y", y, plane), ("phi_s", phi_s, plane)):
        _check(f"x_update {nm}", t, shp, dev)
    out = torch.empty_like(theta)
    n_plane = theta[0].numel()
    vec4 = n_plane % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (theta, b, y, phi, phi_s, out))
    lib = _lib("x_update")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.apnp_x_update(
            theta.data_ptr(), b.data_ptr(), y.data_ptr(), phi.data_ptr(),
            phi_s.data_ptr(), out.data_ptr(), cube[0], n_plane,
            sign, rho, c, lam, int(vec4), stream)
    _raise_on(rc, "x_update")
    launches["x_update"] += 1
    return out


def admm_x_update(theta: Tensor, b: Tensor, y: Tensor, phi: Tensor, phi_s: Tensor,
                  rho: float, alpha: float) -> Tensor:
    """Fused equivalent of :func:`physics.admm_x_update`."""
    if theta.device.type == "cpu":
        return physics.admm_x_update(theta, b, y, phi, phi_s, rho, alpha)
    return _x_update_cuda(theta, b, y, phi, phi_s, -1.0, rho, alpha * rho, 1.0)


def gap_x_update(theta: Tensor, b: Tensor, y: Tensor, phi: Tensor, phi_s: Tensor,
                 lam: float = 1.0, gamma: float = 0.01) -> Tensor:
    """Fused equivalent of :func:`physics.gap_x_update`, for any ``lam``."""
    if theta.device.type == "cpu":
        return physics.gap_x_update(theta, b, y, phi, phi_s, lam, gamma)
    return _x_update_cuda(theta, b, y, phi, phi_s, 1.0, 1.0, gamma, lam)


def tv_chambolle_planes_cuda(planes: Tensor, weight: float = 0.1, eps: float = 2.0e-4,
                             max_iter: int = 5) -> tuple[Tensor, Tensor]:
    """The TV kernel on ``(N, H, W)`` CUDA planes; returns ``(out, iterations)``
    like :func:`tv.tv_chambolle_planes`."""
    if planes.dim() != 3:
        raise ValueError(f"tv_chambolle: expected (N, H, W), got {tuple(planes.shape)}")
    _check("tv_chambolle input", planes, tuple(planes.shape), planes.device)
    n, h, w = planes.shape
    out = torch.empty_like(planes)
    py = torch.empty_like(planes)
    px = torch.empty_like(planes)
    iters = torch.empty(n, dtype=torch.int32, device=planes.device)
    lib = _lib("tv_chambolle")
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        rc = lib.apnp_tv_chambolle(
            planes.data_ptr(), out.data_ptr(), py.data_ptr(), px.data_ptr(),
            iters.data_ptr(), n, h, w, weight, 0.25 / weight, eps, max_iter, stream)
    _raise_on(rc, "tv_chambolle")
    launches["tv_chambolle"] += 1
    return out, iters


def tv_chambolle_fused(x: Tensor, weight: float = 0.1, eps: float = 2.0e-4,
                       max_iter: int = 5) -> Tensor:
    """Channel-wise 2-D TV prox over ``(..., H, W)``: the CUDA kernel for
    CUDA tensors, :func:`tv.tv_chambolle_multichannel` for CPU tensors. Any
    plane size runs on the kernel."""
    if x.device.type == "cpu":
        return tv.tv_chambolle_multichannel(x, weight, eps, max_iter)
    _check("tv_chambolle input", x, tuple(x.shape), x.device)
    lead, hw = tuple(x.shape[:-2]), tuple(x.shape[-2:])
    out, _ = tv_chambolle_planes_cuda(x.reshape((-1,) + hw), weight, eps, max_iter)
    return out.reshape(lead + hw)
