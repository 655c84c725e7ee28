"""Logging and timing helpers (port of ``adaptivepnp_sci_tpu.utils.logging``).

One standard logging setup under the ``adaptivepnp_sci_torch`` logger, an
optional file handler, the commit hash for run provenance, and a host-clock
timer that waits for the CUDA device of the tensors it times (kernel launches
return before the device finishes, so a span without that wait measures the
enqueue).
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from typing import Any, Iterator

import torch

_ROOT = "adaptivepnp_sci_torch"
_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = _ROOT) -> logging.Logger:
    """The logger ``name``; the package's root logger gets a stream handler at
    INFO the first time."""
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
    return logging.getLogger(name)


def add_file_handler(path: str) -> None:
    """Also append the package's log records to the file ``path``."""
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logging.getLogger(_ROOT).addHandler(handler)


def git_revision(path: str = ".") -> str:
    """The current commit hash of the checkout at ``path``, or ``"unknown"``."""
    import subprocess

    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=path, stderr=subprocess.DEVNULL
        ).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def _cuda_devices(obj: Any) -> set[torch.device]:
    """The CUDA devices of the tensors in ``obj`` (a tensor, or nested lists,
    tuples and dicts of them)."""
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.device.type == "cuda" else set()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return set().union(*(_cuda_devices(o) for o in obj)) if obj else set()
    return set()


@contextmanager
def device_timer(label: str, result_holder: dict | None = None) -> Iterator[dict]:
    """Host-clock span of a device computation. The caller puts the tensors
    to wait for in ``holder['out']`` before leaving the context; the CUDA
    devices they lie on are synchronised before the clock stops. The span is
    logged and stored in ``holder['seconds']``."""
    t0 = time.perf_counter()
    holder = result_holder if result_holder is not None else {}
    yield holder
    for dev in _cuda_devices(holder.get("out")):
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    get_logger().info("%s: %.3fs", label, dt)
    holder["seconds"] = dt
