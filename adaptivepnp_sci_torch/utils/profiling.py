"""Profiling and tracing (port of ``adaptivepnp_sci_tpu.utils.profiling``).

The reference's only observability is ad-hoc ``time.time()`` spans and a
globally enabled ``torch.autograd.set_detect_anomaly(True)`` that slows every
backward (``packages/ffdnet/test_ffdnet_ipol.py:26``, deliberately not
replicated). Here: :func:`trace`, a ``torch.profiler`` trace of the host and
the CUDA device written as a Chrome trace (Perfetto, ``chrome://tracing``);
:func:`annotate`, a named span in it; and :class:`StepTimer`, a host-clock
step timer that waits for the device.

The JAX package's ``utils.enable_compile_cache`` has no counterpart: the CUDA
kernels are built once into ``adaptivepnp_sci_torch/_build/`` and loaded from
there by every later process.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from adaptivepnp_sci_torch.utils.logging import _cuda_devices

#: the file :func:`trace` writes in its ``log_dir``
TRACE_NAME = "trace.json"


@contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the host and, when CUDA is available, the device:
    ``with trace(d) as prof: run_step()`` writes ``d/trace.json`` (Chrome
    trace format) on exit, also when the body raises; ``prof.key_averages()``
    gives the per-operator table."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


def annotate(name: str) -> record_function:
    """A named span in :func:`trace`'s timeline, as a context
    (``with annotate("step"): ...``) or a decorator (``@annotate("step")``)."""
    return record_function(name)


class StepTimer:
    """Host-clock step timer; keeps every step's seconds."""

    def __init__(self):
        self.history: list[float] = []

    @contextmanager
    def measure(self) -> Iterator[dict]:
        """``with timer.measure() as h: h['out'] = step(...)``: the CUDA
        devices of the tensors in ``h['out']`` (a tensor, or nested lists,
        tuples and dicts of them) are synchronised before the clock stops."""
        holder: dict = {}
        t0 = time.perf_counter()
        yield holder
        for dev in _cuda_devices(holder.get("out")):
            torch.cuda.synchronize(dev)
        self.history.append(time.perf_counter() - t0)

    @property
    def best(self) -> float:
        return min(self.history)

    @property
    def mean(self) -> float:
        return sum(self.history) / len(self.history)
