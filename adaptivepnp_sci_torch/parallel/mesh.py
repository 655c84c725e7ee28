"""Process meshes over ``torch.distributed``
(port of ``adaptivepnp_sci_tpu.parallel.mesh``).

The JAX package lays its devices out as a ``(data, frame)`` ``Mesh`` and lets
XLA insert the collectives. Here each device is one process (a rank), and a
:class:`Mesh` holds the grid and one process group per axis: rank ``r`` sits
at ``(r // frame, r % frame)``, as ``np.asarray(devices).reshape(data,
frame)`` places the JAX package's devices, so the ranks of a frame group are
consecutive, and a batch split over ``("data", "frame")`` gives rank ``r``
its ``r``-th contiguous slice.

The collectives are explicit and differentiable where a gradient crosses
them:

* :func:`shard` takes a rank's contiguous slice along an axis (what a
  ``NamedSharding`` over that axis hands each device);
* :func:`gather` all-gathers the slices back (``replicated``). Every rank then
  holds the whole tensor and computes the same loss from it, so the backward
  keeps the rank's own slice of the upstream gradient and sends nothing (the
  ``SUM`` reduce-scatter of ``torch.distributed.nn``'s all-gather would hand
  each rank ``world`` times its share);
* :func:`all_reduce_sum`: a sum over an axis whose backward is the sum of the
  upstream gradients over the same ranks (synchronised BatchNorm statistics);
* :func:`gathered_sum`: a sum of per-rank terms that every rank takes over
  all of them in rank order, for a loss that every rank computes alike from
  it (the frame sum of the adaptation loss): its backward hands each rank the
  upstream gradient of its own terms as it is;
* :func:`reduce_gradients`: the in-place sum or mean of ``.grad`` over an
  axis, one flat all-reduce for all of them.

Without an initialised process group there is one rank, every collective is
the identity, and only a ``(1, 1)`` mesh can be made. Once a group is
initialised every axis gets a process group, of one rank too, so the
collectives run through the backend at any world size.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import torch
import torch.distributed as dist
from torch import Tensor

AXES = ("data", "frame")


def _axes(axis: str | Sequence[str]) -> tuple[str, ...]:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if not axes or any(a not in AXES for a in axes):
        raise ValueError(f"mesh axes are {AXES}, got {axis!r}")
    return tuple(a for a in AXES if a in axes)  # row-major order


class Mesh:
    """A ``(data, frame)`` grid of ranks and a process group per axis.

    ``shape`` is ``{"data": d, "frame": f}``; ``coords`` this rank's
    ``{"data": r // f, "frame": r % f}`` (None for a rank past ``d * f``,
    which is in no group). :meth:`group` is the process group of an axis or
    of ``("data", "frame")`` that holds this rank; None without an
    initialised process group."""

    def __init__(self, data: int, frame: int, rank: int, groups: dict[tuple[str, ...], Any]):
        self.shape = {"data": data, "frame": frame}
        self.rank = rank
        self.coords = ({"data": rank // frame, "frame": rank % frame}
                       if rank < data * frame else None)
        self._groups = groups

    def axis_size(self, axis: str | Sequence[str]) -> int:
        n = 1
        for a in _axes(axis):
            n *= self.shape[a]
        return n

    def axis_index(self, axis: str | Sequence[str]) -> int:
        """This rank's position along ``axis`` (row-major over several)."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is outside the {self.shape} mesh")
        i = 0
        for a in _axes(axis):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axis: str | Sequence[str]):
        self.axis_index(axis)  # raises for a rank outside the mesh
        return self._groups.get(_axes(axis))

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, frame={self.shape['frame']}, rank={self.rank})"


def make_mesh(data: int = 1, frame: int = 1) -> Mesh:
    """Build a ``(data, frame)`` mesh from the first ``data * frame`` ranks.

    Every rank of the job must call it, with the same shape: the process
    groups are made collectively, in one order. ``frame`` groups should
    span the fastest links, since the halo exchanges ride them every
    denoiser call."""
    n = data * frame
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    if not dist.is_initialized():
        return Mesh(data, frame, 0, {})
    rank = dist.get_rank()
    grid = [[d * frame + f for f in range(frame)] for d in range(data)]
    members = {
        ("frame",): grid,
        ("data",): [[grid[d][f] for d in range(data)] for f in range(frame)],
        ("data", "frame"): [list(range(n))],
    }
    groups: dict[tuple[str, ...], Any] = {}
    for axes, lists in members.items():
        for ranks in lists:
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axes] = group
    return Mesh(data, frame, rank, groups)


def shard(x: Any, mesh: Mesh, axis: str | Sequence[str], dim: int = 0) -> Any:
    """This rank's contiguous slice of ``x`` (a tensor or a NumPy array)
    along ``dim``, split evenly over ``axis``."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} does not split over {n} ranks "
                         f"of mesh axis {axis!r}")
    m = size // n
    return x[(slice(None),) * dim + (slice(i * m, (i + 1) * m),)]


def _all_gather(x: Tensor, group) -> list[Tensor]:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, group, index: int, dim: int) -> Tensor:
        ctx.index, ctx.dim, ctx.size = index, dim, x.shape[dim]
        return torch.cat(_all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, grad: Tensor):
        # every rank computed the same loss from the whole tensor: its own
        # slice's gradient is already complete on this rank
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None


def gather(x: Tensor, mesh: Mesh, axis: str | Sequence[str], dim: int = 0) -> Tensor:
    """The slices of ``axis``'s ranks concatenated along ``dim``, in rank
    order (the inverse of :func:`shard`), on every rank of the axis. The
    backward gives each rank the gradient of its own slice, for a loss that
    every rank computes alike from the gathered tensor."""
    group = mesh.group(axis)
    if group is None:
        return x
    return _Gather.apply(x, group, mesh.axis_index(axis), dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: Tensor, mesh: Mesh, axis: str | Sequence[str]) -> Tensor:
    """``x`` summed over ``axis``'s ranks, on each of them; the backward sums
    the upstream gradients over the same ranks."""
    group = mesh.group(axis)
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def gathered_sum(x: Tensor, mesh: Mesh, axis: str | Sequence[str], dim: int = 0) -> Tensor:
    """The sum over ``dim`` of the slices of ``axis``'s ranks, taken over the
    gathered tensor (:func:`gather`) in rank order, so every rank gets the one
    process's sum bit for bit. Every rank then computes the same loss from
    it, and the backward hands each rank the upstream gradient of its own
    slice as it is; :func:`all_reduce_sum`'s backward would sum those equal
    gradients over the ranks, ``axis``'s size times too large."""
    return torch.sum(gather(x, mesh, axis, dim), dim=dim)


def all_reduce_tensors(tensors: Iterable[Tensor], mesh: Mesh,
                       axis: str | Sequence[str], scale: float = 1.0) -> None:
    """Sum ``tensors`` over ``axis``'s ranks in place (then times ``scale``),
    through one flat all-reduce per dtype and device."""
    tensors = [t for t in tensors if t is not None]
    group = mesh.group(axis)
    if not tensors:
        return
    if group is not None:
        buckets: dict[tuple, list[Tensor]] = {}
        for t in tensors:
            buckets.setdefault((t.dtype, t.device), []).append(t)
        for ts in buckets.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, group=group)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))
    if scale != 1.0:
        for t in tensors:
            t.mul_(scale)


def reduce_gradients(params: Iterable[torch.nn.Parameter], mesh: Mesh,
                     axis: str | Sequence[str], average: bool = False) -> None:
    """Sum (or, with ``average``, average) the ``.grad`` of ``params`` over
    ``axis``'s ranks in place; parameters without a gradient are skipped."""
    grads = [p.grad for p in params if p.grad is not None]
    all_reduce_tensors(grads, mesh, axis, 1.0 / mesh.axis_size(axis) if average else 1.0)
