"""Joining a multi-process job (port of
``adaptivepnp_sci_tpu.parallel.distributed``).

The JAX package calls ``jax.distributed.initialize`` and then builds one
mesh over every process's devices. Here each process drives one device and
joins the job through ``torch.distributed.init_process_group``; then
:func:`global_mesh` lays all ranks out as a ``(data, frame)`` mesh.

The backend is an explicit argument. Its default follows the device: NCCL
for CUDA, gloo for the CPU. Nothing switches from one to the other after an
error. (Two NCCL ranks cannot share one GPU; several ranks on one card run
gloo, which takes CUDA tensors for its collectives.)
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from adaptivepnp_sci_torch.parallel.mesh import Mesh, make_mesh
from adaptivepnp_sci_torch.utils.logging import get_logger

log = get_logger(__name__)


def default_backend(device: torch.device | str) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device: torch.device | str = "cuda") -> None:
    """Join the job as rank ``process_id`` of ``num_processes``; a no-op when
    this process has joined already.

    ``coordinator_address``: ``host:port`` (TCP), or an ``init_method`` URL
    such as ``tcp://host:port`` or ``file:///path`` (None: the ``env://``
    variables). ``backend`` None takes :func:`default_backend` of ``device``;
    with NCCL the process drives CUDA device ``process_id`` modulo the cards
    it sees."""
    if dist.is_initialized():
        log.debug("distributed init skipped: already rank %d of %d", dist.get_rank(),
                  dist.get_world_size())
        return
    backend = backend or default_backend(device)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend == "nccl" and process_id is not None:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)
    log.info("distributed: rank %d of %d, backend %s", dist.get_rank(),
             dist.get_world_size(), backend)


def global_mesh(frame: int = 1) -> Mesh:
    """The ``(data, frame)`` mesh over every rank of the job: ``frame``
    consecutive ranks per frame group."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % frame != 0:
        raise ValueError(f"{n} devices not divisible by frame={frame}")
    return make_mesh(data=n // frame, frame=frame)
