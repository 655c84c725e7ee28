"""Hand-written CUDA kernels for Hopper and their wrappers
(port of ``adaptivepnp_sci_tpu.ops.pallas_kernels``).

Two kernels carry the flagship path, with the JAX package's wrapper names:

* ``csrc/x_update.cu``: the fused GAP / ADMM x-update
  (:func:`admm_x_update`, :func:`gap_x_update`), and its split form of two
  launches for a solve whose frames are spread over ranks (``frame=``);
* ``csrc/tv_chambolle.cu``: the channel-wise Chambolle TV prox with the
  per-plane early stop (:func:`tv_chambolle_fused`), in two designs: a
  thread-block cluster per plane with the state in shared memory
  (``"cluster"``), and one block per plane with the state in device scratch
  (``"block"``) for planes too large for that; :func:`tv_plan` chooses by
  the plane's shape.

A third carries the bf16 mode of the FastDVDnet prior, and replaces the
fused kernel of ``scripts/ab_pallas_convpair.py``: FastDVDnet's CvBlock, two
3x3 convolutions with folded BatchNorm and ReLU, on the tensor cores with
the intermediate kept on chip (:func:`convpair`), in two designs:

* ``csrc/convpair_wgmma.cu`` (``"wgmma"``): warpgroup matrix instructions
  fed from shared memory, a persistent block per SM; C = 64 and 128;
* ``csrc/convpair.cu`` (``"mma"``): warp-level ``mma.sync`` fed by
  ``ldmatrix``; every C, and the only design for C = 32.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, into ``_build/`` beside the
package; the libraries are loaded with ``ctypes``. A library's file name
carries a hash of its source and flags, so an edited source is rebuilt.

A wrapper given CPU tensors runs the plain PyTorch version
(:mod:`.physics`, :mod:`.tv`, :mod:`.convpair`). Given CUDA tensors it launches its kernel on
the current stream or raises; a failed build or launch is never caught to
fall back. The x-update and TV wrappers take ``use_kernels`` (the solvers'
switch, JAX's ``use_pallas``; :func:`runs_kernel`): ``False`` runs the plain
version on any device, ``True`` insists on the kernel. :data:`launches`
counts kernel launches per kernel.
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

from adaptivepnp_sci_torch.ops import convpair as convpair_ops
from adaptivepnp_sci_torch.ops import physics, tv

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: sources, one shared library each
SOURCES = {"x_update": CSRC / "x_update.cu", "tv_chambolle": CSRC / "tv_chambolle.cu",
           "convpair": CSRC / "convpair.cu", "convpair_wgmma": CSRC / "convpair_wgmma.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: kernel launches since the last :func:`reset_launches`, per kernel
launches = {"x_update": 0, "tv_chambolle": 0, "convpair": 0}
#: the conv pair's launches once more, by ``(C, H, W)`` of the activation
convpair_launches: dict[tuple[int, int, int], int] = {}

_libs: dict[str, ctypes.CDLL] = {}
#: ptxas register / shared-memory report of each library built in this process
build_log: dict[str, str] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    convpair_launches.clear()


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


def _signatures() -> dict[str, dict[str, list]]:
    """Argument types of every exported C function, by library."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    pair = [p, p, p, p, p, p, p, p, i, i, i, i, p]
    return {
        "x_update": {"apnp_x_update": [p, p, p, p, p, p, i, i, ll, ll, ll, f, f, f, f, i, p],
                     "apnp_x_update_partial": [p, p, p, p, p, i, i, ll, ll, f, f, i, p],
                     "apnp_x_update_finish": [p, p, p, p, p, i, i, i, ll, ll, ll, f, f, i, p]},
        "tv_chambolle": {
            "apnp_tv_chambolle": [p, p, p, p, p, i, i, i, f, f, f, i, p],
            "apnp_tv_chambolle_cluster": [p, p, p, i, i, i, i, i, f, f, f, i, p],
            "apnp_tv_cluster_occupancy": [i, i, i, p, p]},
        "convpair": {"apnp_convpair": pair},
        "convpair_wgmma": {"apnp_convpair_wgmma": pair},
    }


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, argtypes in _signatures()[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build()
    return _libs[name]


def _check(name: str, t: Tensor, shape: tuple[int, ...], device: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


def runs_kernel(t: Tensor, use_kernels: bool | None) -> bool:
    """Whether a wrapper given ``t`` launches its kernel: by ``t``'s device
    when ``use_kernels`` is None (the plain version on the CPU, the kernel
    elsewhere); the plain version on any device when it is False; the
    kernel when it is True, which a CPU tensor refuses with a ``ValueError``."""
    if use_kernels is None:
        return t.device.type != "cpu"
    if use_kernels and t.device.type == "cpu":
        raise ValueError("use_kernels=True: the CUDA kernels take CUDA tensors, "
                         "not CPU tensors")
    return bool(use_kernels)


def _x_update_cuda(theta: Tensor, b: Tensor, y: Tensor, phi: Tensor, phi_s: Tensor,
                   sign: float, rho: float, c: float, lam: float, frame=None) -> Tensor:
    if theta.dim() not in (4, 5):
        raise ValueError(f"x_update: expected theta (B, C, H, W) or (N, B, C, H, W), "
                         f"got {tuple(theta.shape)}")
    cube, plane = tuple(theta.shape[-4:]), tuple(theta.shape[-3:])
    items = tuple(theta.shape[:-4])
    n_items = items[0] if items else 1
    if not 1 <= n_items <= 65535:
        raise ValueError(f"x_update: {n_items} items are outside the kernel's grid")
    dev = theta.device
    # phi and phi_s belong to each item, or one of each is shared by all
    phi_items = items if phi.dim() == theta.dim() else ()
    phis_items = items if phi_s.dim() == y.dim() and phi_items else ()
    for nm, t, shp in (("theta", theta, items + cube), ("b", b, items + cube),
                       ("phi", phi, phi_items + cube), ("y", y, items + plane),
                       ("phi_s", phi_s, phis_items + plane)):
        _check(f"x_update {nm}", t, shp, dev)
    out = torch.empty_like(theta)
    n_plane = theta[(0,) * (len(items) + 1)].numel()
    phi_stride = cube[0] * n_plane if phi_items else 0
    phis_stride = n_plane if phis_items else 0
    aligned = (theta, b, y, phi, phi_s, out)
    lib = _lib("x_update")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if frame is None:
            vec4 = n_plane % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in aligned)
            rc = lib.apnp_x_update(
                theta.data_ptr(), b.data_ptr(), y.data_ptr(), phi.data_ptr(),
                phi_s.data_ptr(), out.data_ptr(), n_items, cube[0], n_plane,
                phi_stride, phis_stride, sign, rho, c, lam, int(vec4), stream)
            _raise_on(rc, "x_update launch")
            launches["x_update"] += 1
            return out
        terms = torch.empty_like(theta)
        vec4 = n_plane % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (*aligned, terms))
        rc = lib.apnp_x_update_partial(
            theta.data_ptr(), b.data_ptr(), phi.data_ptr(), out.data_ptr(), terms.data_ptr(),
            n_items, cube[0], n_plane, phi_stride, sign, rho, int(vec4), stream)
    _raise_on(rc, "x_update partial launch")
    launches["x_update"] += 1
    terms = frame.gather(terms, physics.PACKED_FRAME_AXIS).contiguous()
    _check("x_update gathered terms", terms, items + (terms.shape[-4],) + plane, dev)
    vec4 = vec4 and terms.data_ptr() % 16 == 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.apnp_x_update_finish(
            out.data_ptr(), terms.data_ptr(), y.data_ptr(), phi.data_ptr(), phi_s.data_ptr(),
            n_items, cube[0], terms.shape[-4], n_plane, phi_stride, phis_stride, c, lam,
            int(vec4), stream)
    _raise_on(rc, "x_update finish launch")
    launches["x_update"] += 1
    return out


def _x_update_split(theta: Tensor, b: Tensor, y: Tensor, phi: Tensor, phi_s: Tensor,
                    sign: float, rho: float, c: float, lam: float, frame) -> Tensor:
    """The plain split form: the partial pass, the terms gathered over the
    ranks, the finish."""
    p, terms = physics.x_update_partial(theta, b, phi, sign, rho)
    terms = frame.gather(terms, physics.PACKED_FRAME_AXIS)
    return physics.x_update_finish(p, terms, y, phi, phi_s, c, lam)


def admm_x_update(theta: Tensor, b: Tensor, y: Tensor, phi: Tensor, phi_s: Tensor,
                  rho: float, alpha: float, frame=None, use_kernels: bool | None = None
                  ) -> Tensor:
    """Fused equivalent of :func:`physics.admm_x_update`: ``theta``, ``b``
    ``(B, 4, h, w)`` with ``y``, ``phi_s`` ``(4, h, w)``, or with an item axis
    in one launch: ``theta``, ``b`` ``(N, B, 4, h, w)``, ``y`` ``(N, 4, h, w)``,
    and ``phi``, ``phi_s`` per item or one ``(B, 4, h, w)`` / ``(4, h, w)``
    shared by all items.

    ``frame``: ``theta``, ``b`` and ``phi`` hold this rank's frames of a cube
    whose frames are spread over ranks, and ``frame.gather(t, dim)``
    concatenates every rank's ``t`` along ``dim`` in frame order (a
    :class:`~adaptivepnp_sci_torch.adapt.online.FrameShard`); ``phi_s`` is
    the whole cube's. The update then runs as the split form's two launches,
    the terms of the frame sum gathered between them. ``use_kernels``: see
    :func:`runs_kernel`."""
    if not runs_kernel(theta, use_kernels):
        if frame is not None:
            return _x_update_split(theta, b, y, phi, phi_s, -1.0, rho, alpha * rho, 1.0, frame)
        return physics.admm_x_update(theta, b, y, phi, phi_s, rho, alpha)
    return _x_update_cuda(theta, b, y, phi, phi_s, -1.0, rho, alpha * rho, 1.0, frame)


def gap_x_update(theta: Tensor, b: Tensor, y: Tensor, phi: Tensor, phi_s: Tensor,
                 lam: float = 1.0, gamma: float = 0.01, frame=None,
                 use_kernels: bool | None = None) -> Tensor:
    """Fused equivalent of :func:`physics.gap_x_update`, for any ``lam``, over
    the shapes and with the ``frame`` and ``use_kernels`` of
    :func:`admm_x_update`."""
    if not runs_kernel(theta, use_kernels):
        if frame is not None:
            return _x_update_split(theta, b, y, phi, phi_s, 1.0, 1.0, gamma, lam, frame)
        return physics.gap_x_update(theta, b, y, phi, phi_s, lam, gamma)
    return _x_update_cuda(theta, b, y, phi, phi_s, 1.0, 1.0, gamma, lam, frame)


#: shared memory a block of the TV cluster kernel may take for its strip
#: (the 227 KB limit less the kernel's static reduction buffers), the bytes
#: a pixel of the strip costs there (out, p_y, p_x in float32), and the
#: largest strip of which two blocks fit on one SM (228 KB, 1 KB reserved
#: per block)
TV_STRIP_SMEM_BYTES = 227 * 1024 - 2048
TV_STRIP_BYTES_PER_PIXEL = 12
TV_STRIP_PIXELS = 9600
TV_CLUSTER_SIZES = (1, 2, 3, 4, 5, 6, 7, 8)
TV_DESIGNS = ("cluster", "block")


def tv_plan(h: int, w: int) -> tuple[str, int, int]:
    """``(design, cluster size, strip height)`` of the TV kernel for ``(h, w)``
    planes, a pure function of the shape.

    ``"cluster"``: the plane is cut into ``cluster size`` strips of
    ``strip height`` rows (the last ones shorter, or empty), one per block of
    a thread-block cluster, each strip's state in shared memory. The smallest
    cluster whose strips hold at most :data:`TV_STRIP_PIXELS` pixels is
    taken (256 x 256: 7 strips of 37 rows, the last of 34), else 8 blocks if their strips
    still fit in shared memory. ``"block"``: planes too large for that
    (512 x 512 and up) run one block per plane with the state in device
    scratch; cluster size 1, strip height ``h``."""
    if h < 1 or w < 1:
        raise ValueError(f"tv_plan: expected a plane of at least 1 x 1, got {h} x {w}")
    for cluster in TV_CLUSTER_SIZES:
        strip_h = -(-h // cluster)
        if strip_h * w <= TV_STRIP_PIXELS:
            return "cluster", cluster, strip_h
    if strip_h * w * TV_STRIP_BYTES_PER_PIXEL <= TV_STRIP_SMEM_BYTES:
        return "cluster", cluster, strip_h
    return "block", 1, h


def tv_sms_used(n: int, h: int, w: int) -> int:
    """SMs that one TV launch over ``n`` planes of ``(h, w)`` keeps busy at
    once, asked of the device for the launch's block and cluster shape."""
    design, cluster, strip_h = tv_plan(h, w)
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    if design == "block":
        return min(n, sms)
    clusters, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib("tv_chambolle").apnp_tv_cluster_occupancy(
        cluster, strip_h, w, ctypes.byref(clusters), ctypes.byref(per_sm))
    _raise_on(rc, "tv_chambolle occupancy query")
    return min(sms, -(-min(n, clusters.value) * cluster // per_sm.value))


def tv_chambolle_planes_cuda(planes: Tensor, weight: float = 0.1, eps: float = 2.0e-4,
                             max_iter: int = 5, design: str | None = None
                             ) -> tuple[Tensor, Tensor]:
    """The TV kernel on ``(N, H, W)`` CUDA planes; returns ``(out, iterations)``
    like :func:`tv.tv_chambolle_planes`. ``design`` is :func:`tv_plan`'s choice
    for the shape unless given: ``"block"`` runs any shape, ``"cluster"``
    raises for a plane that :func:`tv_plan` sends to ``"block"``."""
    if planes.dim() != 3:
        raise ValueError(f"tv_chambolle: expected (N, H, W), got {tuple(planes.shape)}")
    _check("tv_chambolle input", planes, tuple(planes.shape), planes.device)
    n, h, w = planes.shape
    planned, cluster, strip_h = tv_plan(h, w)
    if design is None:
        design = planned
    if design not in TV_DESIGNS:
        raise ValueError(f"tv_chambolle: design must be one of {TV_DESIGNS}, got {design!r}")
    if design == "cluster" and planned != "cluster":
        raise ValueError(f"tv_chambolle: a {h} x {w} plane does not fit the cluster design")
    out = torch.empty_like(planes)
    iters = torch.empty(n, dtype=torch.int32, device=planes.device)
    lib = _lib("tv_chambolle")
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        if design == "cluster":
            rc = lib.apnp_tv_chambolle_cluster(
                planes.data_ptr(), out.data_ptr(), iters.data_ptr(), n, h, w, cluster,
                strip_h, weight, 0.25 / weight, eps, max_iter, stream)
        else:
            py = torch.empty_like(planes)
            px = torch.empty_like(planes)
            rc = lib.apnp_tv_chambolle(
                planes.data_ptr(), out.data_ptr(), py.data_ptr(), px.data_ptr(),
                iters.data_ptr(), n, h, w, weight, 0.25 / weight, eps, max_iter, stream)
    _raise_on(rc, "tv_chambolle launch")
    launches["tv_chambolle"] += 1
    return out, iters


def tv_chambolle_fused(x: Tensor, weight: float = 0.1, eps: float = 2.0e-4,
                       max_iter: int = 5, use_kernels: bool | None = None) -> Tensor:
    """Channel-wise 2-D TV prox over ``(..., H, W)``: the CUDA kernel for
    CUDA tensors, :func:`tv.tv_chambolle_multichannel` for CPU tensors. Any
    plane size runs on a kernel: planes whose strips fit in shared memory
    (up to 8 strips of 19,200 pixels, e.g. 256 x 256 and 384 x 384) on the
    cluster design, larger ones (512 x 512 and up) on the one-block-per-plane
    design; see :func:`tv_plan`. ``use_kernels``: see :func:`runs_kernel`."""
    if not runs_kernel(x, use_kernels):
        return tv.tv_chambolle_multichannel(x, weight, eps, max_iter)
    _check("tv_chambolle input", x, tuple(x.shape), x.device)
    lead, hw = tuple(x.shape[:-2]), tuple(x.shape[-2:])
    out, _ = tv_chambolle_planes_cuda(x.reshape((-1,) + hw), weight, eps, max_iter)
    return out.reshape(lead + hw)


#: channel counts the conv-pair kernels are compiled for, and the design
#: each takes unless the caller names one: ``"wgmma"``
#: (``csrc/convpair_wgmma.cu``, C = 64 and 128) or ``"mma"``
#: (``csrc/convpair.cu``, every C)
CONVPAIR_CHANNELS = (32, 64, 128)
CONVPAIR_DESIGN = {32: "mma", 64: "wgmma", 128: "wgmma"}
CONVPAIR_DESIGNS = {"mma": ("convpair", "apnp_convpair", (32, 64, 128)),
                    "wgmma": ("convpair_wgmma", "apnp_convpair_wgmma", (64, 128))}


def convpair(x: Tensor, w1: Tensor, s1: Tensor, b1: Tensor,
             w2: Tensor, s2: Tensor, b2: Tensor, design: str | None = None) -> Tensor:
    """Fused equivalent of :func:`adaptivepnp_sci_torch.ops.convpair.convpair`:
    ``x (N, H, W, C)`` bf16, kernels ``(3, 3, C, C)`` bf16, ``s``/``b`` float32
    with ``C`` elements, ``C`` in :data:`CONVPAIR_CHANNELS`; any ``H``, ``W``.
    ``design`` is :data:`CONVPAIR_DESIGN`'s for ``C`` unless given.

    The kernel has no backward: with CUDA inputs that need a gradient it
    raises, and a caller that differentiates takes the plain version."""
    if x.device.type == "cpu":
        return convpair_ops.convpair(x, w1, s1, b1, w2, s2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, s1, b1, w2, s2, b2)):
        raise RuntimeError("convpair: the fused kernel has no backward; "
                           "call ops.convpair.convpair for a forward with gradient")
    if x.dim() != 4 or x.shape[3] not in CONVPAIR_CHANNELS:
        raise ValueError(f"convpair: expected x (N, H, W, C) with C in {CONVPAIR_CHANNELS}, "
                         f"got {tuple(x.shape)}")
    n, h, w, c = x.shape
    if design is None:
        design = CONVPAIR_DESIGN[c]
    if design not in CONVPAIR_DESIGNS or c not in CONVPAIR_DESIGNS[design][2]:
        raise ValueError(f"convpair: no design {design!r} for C = {c}")
    source, entry, _ = CONVPAIR_DESIGNS[design]
    if n > 65535 or min(n, h, w) < 1:
        raise ValueError(f"convpair: batch {n} and size {h}x{w} are outside the kernel's grid")
    dev = x.device
    _check("convpair x", x, (n, h, w, c), dev, torch.bfloat16)
    for nm, t in (("w1", w1), ("w2", w2)):
        _check(f"convpair {nm}", t, (3, 3, c, c), dev, torch.bfloat16)
    vecs = [t.reshape(-1) for t in (s1, b1, s2, b2)]
    for nm, t in zip(("s1", "b1", "s2", "b2"), vecs):
        _check(f"convpair {nm}", t, (c,), dev)
    out = torch.empty_like(x)
    if any(t.data_ptr() % 16 for t in (x, w1, w2, out, *vecs)):
        raise ValueError("convpair: every tensor must be aligned to 16 bytes")
    lib = _lib(source)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            x.data_ptr(), w1.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
            w2.data_ptr(), vecs[2].data_ptr(), vecs[3].data_ptr(), out.data_ptr(),
            n, h, w, c, stream)
    _raise_on(rc, "convpair launch")
    launches["convpair"] += 1
    convpair_launches[(c, h, w)] = convpair_launches.get((c, h, w), 0) + 1
    return out
