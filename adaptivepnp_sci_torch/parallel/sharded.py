"""Frame-sharded priors and data-parallel training steps over a
``(data, frame)`` mesh (port of ``adaptivepnp_sci_tpu.parallel.sharded``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
from torch import Tensor

from adaptivepnp_sci_torch.parallel.halo import halo_windows
from adaptivepnp_sci_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    all_reduce_tensors,
    gather,
    reduce_gradients,
    shard,
)
from adaptivepnp_sci_torch.solvers.priors import Prior
from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32


def fastdvd_prior_sharded(model: nn.Module, mesh: Mesh, window: int = 5,
                          shared_triplet: bool = True) -> Prior:
    """FastDVDnet prior with the frame axis spread over the mesh's ``frame``
    ranks; a drop-in for :func:`~adaptivepnp_sci_torch.solvers.priors.fastdvd_prior`.

    Every rank is given the whole ``(B, H, W, 3)`` cube, denoises its own
    ``B / frame`` consecutive frames and returns the whole denoised cube,
    all-gathered over the frame group.

    Default (``shared_triplet``, 5-frame windows): ``triplet_stage1`` once
    per distinct circular triplet of the rank's frames, a 1-frame ring halo
    exchange of its output, then ``triplet_stage2``: half the convolutions
    of per-window evaluation, and ``B_local >= 1`` suffices (frozen
    BatchNorm, as ``seq_circular``). ``shared_triplet=False`` (and any
    ``window != 5``) gathers each frame's window through one 2-frame halo
    exchange and runs the model on the windows (``B_local >= 2``).

    Under the adaptation's gradient, each rank's backward reaches the
    parameters through its own frames only (the gather hands each rank its
    slice's gradient, the halo exchange routes the halos' gradients to the
    frames' owners), and ``Prior.reduce_grads`` sums the parameters'
    gradients over the frame group: every rank steps with the gradient of
    the unsharded prior."""

    def apply(net: nn.Module, rgb: Tensor, sigma: Tensor) -> Tensor:
        local = shard(rgb, mesh, "frame")
        if shared_triplet and window == 5:
            trip = halo_windows(local, mesh, "frame", 3)
            t1 = net.triplet_stage1(trip[:, 0], trip[:, 1], trip[:, 2], sigma)
            t1trip = halo_windows(t1, mesh, "frame", 3)
            out = net.triplet_stage2(t1trip[:, 0], t1trip[:, 1], t1trip[:, 2], sigma)
        else:
            out = net(halo_windows(local, mesh, "frame", window), sigma)
        return gather(out, mesh, "frame")

    def reduce_grads(grads: list[Tensor]) -> None:
        all_reduce_tensors(grads, mesh, "frame")

    return Prior("fastdvd", model, apply, loss_mode="bayer1", adapt_noise_std=5.0 / 255.0,
                 reduce_grads=reduce_grads)


def make_dp_train_step(net: nn.Module, optimizer: torch.optim.Optimizer, mesh: Mesh
                       ) -> tuple[Callable[[Tensor, Tensor, Tensor], Tensor],
                                  Callable[..., tuple[Tensor, Tensor, Tensor]]]:
    """Data-parallel denoiser training step over the ``("data", "frame")``
    ranks: returns ``(step, place)``.

    ``place(noisy, clean, sigma)`` takes the global batch (the same on every
    rank) and returns this rank's contiguous slice of each, on the device of
    ``net``'s parameters. ``step(noisy, clean, sigma)`` runs ``net`` on the
    slice, takes the reference's loss (MSE / 2, ``packages/ffdnet/train.py:
    154``), averages the gradients over the ranks and steps ``optimizer``
    (TF32 off, as the trainer's step); it returns the loss over the global
    batch. ``net`` and ``optimizer`` hold the replicated state (the JAX step
    takes and returns it); every rank must start from the same weights."""
    axis = ("data", "frame")
    count = mesh.axis_size(axis)

    def place(noisy, clean, sigma) -> tuple[Tensor, Tensor, Tensor]:
        dev = next(net.parameters()).device
        return tuple(torch.as_tensor(shard(a, mesh, axis), device=dev)
                     for a in (noisy, clean, sigma))

    def step(noisy: Tensor, clean: Tensor, sigma: Tensor) -> Tensor:
        with full_f32():
            optimizer.zero_grad(set_to_none=True)
            out = net(noisy, sigma)
            loss = torch.mean((out - clean) ** 2) / 2.0
            loss.backward()
            reduce_gradients(net.parameters(), mesh, axis, average=True)
            optimizer.step()
        with torch.no_grad():
            return all_reduce_sum(loss.detach(), mesh, axis) / count

    return step, place
