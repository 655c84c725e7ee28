"""Ring halo exchange for frame-sharded sliding-window denoising
(port of ``adaptivepnp_sci_tpu.parallel.halo``).

The FastDVDnet prior reads a circular window of frames around each frame.
With the B-frame cube split over a mesh axis, each rank needs only
``(window - 1) // 2`` boundary frames from each ring neighbour; the ring
wraps, so the circular windows of the reference fall out as they are.

The JAX package sends the halos with two ``ppermute`` s. Here every rank of
the axis all-gathers the boundary frames of all of them (its first and last
``hw`` frames) and takes its neighbours': one collective that gloo runs on
CPU and CUDA tensors alike and NCCL on CUDA tensors, where gloo's
point-to-point sends take CPU tensors only. The exchange is differentiable:
its backward all-gathers the halos' gradients and adds each to the frames
it came from, on the rank that owns them.
"""

from __future__ import annotations

import torch
from torch import Tensor

from adaptivepnp_sci_torch.parallel.mesh import Mesh, _all_gather


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local: Tensor, hw: int, group, index: int, size: int):
        ctx.hw, ctx.group, ctx.index, ctx.size = hw, group, index, size
        ctx.b_local = local.shape[0]
        parts = _all_gather(torch.cat([local[:hw], local[-hw:]]), group)
        # the left neighbour's last frames and the right neighbour's first
        return parts[(index - 1) % size][hw:], parts[(index + 1) % size][:hw]

    @staticmethod
    def backward(ctx, g_left: Tensor, g_right: Tensor):
        hw, index, size = ctx.hw, ctx.index, ctx.size
        parts = _all_gather(torch.cat([g_left, g_right]), ctx.group)
        # this rank's first frames were its left neighbour's right halo, its
        # last frames its right neighbour's left halo
        first = parts[(index - 1) % size][hw:]
        last = parts[(index + 1) % size][:hw]
        grad = torch.zeros((ctx.b_local, *first.shape[1:]), dtype=first.dtype,
                           device=first.device)
        grad[:hw] += first
        grad[-hw:] += last
        return grad, None, None, None, None


def _exchange(local: Tensor, hw: int, mesh: Mesh, axis: str) -> tuple[Tensor, Tensor]:
    group = mesh.group(axis)
    if group is None:  # one rank: the ring wraps onto its own frames
        return local[-hw:], local[:hw]
    return _Halo.apply(local, hw, group, mesh.axis_index(axis), mesh.axis_size(axis))


def halo_windows(local: Tensor, mesh: Mesh, axis: str = "frame", window: int = 5) -> Tensor:
    """Per-frame sliding windows of a frame-sharded cube.

    ``local`` is this rank's frames ``(B_local, ...)``; returns ``(B_local,
    window, ...)`` where window ``w`` of frame ``f`` spans the *global*
    circular range ``f - hw .. f + hw``. Requires ``B_local >= (window - 1)
    // 2``: the halos come from the immediate ring neighbours only (e.g. B = 8
    over at most 4 ranks for 5-frame windows)."""
    hw = (window - 1) // 2
    b_local = local.shape[0]
    if b_local < hw:
        raise ValueError(
            f"B_local={b_local} < halo={hw}: too many shards for window={window}")
    if hw == 0:
        return local[:, None]
    left, right = _exchange(local, hw, mesh, axis)
    ext = torch.cat([left, local, right], dim=0)
    idx = torch.arange(b_local, device=local.device)[:, None] + torch.arange(
        window, device=local.device)[None, :]
    return ext[idx]
