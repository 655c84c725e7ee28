"""ctypes bindings for the native prefetch ring ``native/prefetch.cpp``
(port of ``adaptivepnp_sci_tpu.data.native_loader``).

The device synthesizes augmentation and noise; the host only streams raw
``.npy`` bytes, read ahead by a C++ worker pool while the steps run (the
reference's optional NVIDIA DALI loader slot,
``packages/{fastdvdnet,DDnet}/dataloaders.py``).

The library is built at first use with ``g++`` from the repository's
unchanged ``native/prefetch.cpp`` into ``adaptivepnp_sci_torch/_build/``,
under a name hashed from the source and the flags and moved into place
atomically, so concurrent processes never load a half-written file; nothing
is built into ``native/``. Without a toolchain the files are read
synchronously, with one warning.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator

import numpy as np

from adaptivepnp_sci_torch.utils.logging import get_logger

log = get_logger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "prefetch.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
#: ``native/Makefile``'s flags
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread")

_lib: ctypes.CDLL | None = None
#: why the library is unavailable, once a build has failed (then the warning
#: has been logged and no build is tried again)
_unavailable: str | None = None


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libprefetch-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    target = _lib_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cxx = os.environ.get("CXX", "g++")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _load_library() -> ctypes.CDLL | None:
    global _lib, _unavailable
    if _lib is not None or _unavailable is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.CalledProcessError) as err:
        detail = getattr(err, "stderr", "") or str(err)
        _unavailable = detail.strip().splitlines()[-1] if detail.strip() else repr(err)
        log.warning("native prefetch ring unavailable (%s): .npy files are read "
                    "synchronously", _unavailable)
        return None
    lib.prefetch_create.restype = ctypes.c_void_p
    lib.prefetch_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.prefetch_next.restype = ctypes.c_int64
    lib.prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ]
    lib.prefetch_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the ring is built and loaded (building it on first call)."""
    return _load_library() is not None


def iter_npy_prefetched(
    paths: list[str], workers: int = 2, capacity: int = 4
) -> Iterator[np.ndarray]:
    """Yield the arrays of ``.npy`` files in order, the reads overlapped by
    the native worker pool (``workers`` threads, at most ``capacity`` files
    read ahead); synchronous reads without a toolchain. A file that cannot
    be read ends the stream."""
    lib = _load_library()
    if lib is None:
        for p in paths:
            yield np.load(p)
        return

    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    ring = lib.prefetch_create(arr, len(paths), workers, capacity)
    try:
        while True:
            data_ptr = ctypes.POINTER(ctypes.c_uint8)()
            size = lib.prefetch_next(ring, ctypes.byref(data_ptr))
            if size < 0:
                break
            raw = ctypes.string_at(data_ptr, size)
            yield np.load(io.BytesIO(raw))
    finally:
        lib.prefetch_destroy(ring)
