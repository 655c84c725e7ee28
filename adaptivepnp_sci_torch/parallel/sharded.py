"""Frame-sharded priors and data-parallel training steps over a
``(data, frame)`` mesh (port of ``adaptivepnp_sci_tpu.parallel.sharded``).

Two forms of a frame-sharded prior: :func:`fastdvd_prior_sharded` takes and
returns the whole cube (a drop-in prior for a solve that runs on every
rank alike), and the ``*_prior_frames`` priors take and return the rank's
frames, for a solve whose own state is spread over the ``frame`` axis
(``two_stage_admm(mesh=)``; each prior's ``Prior.frame_sharded``).
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
from adaptivepnp_sci_torch.solvers.priors import Prior, _apply_module
from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32


def _frame_grads(mesh: Mesh) -> Callable[[list[Tensor]], None]:
    def reduce_grads(grads: list[Tensor]) -> None:
        all_reduce_tensors(grads, mesh, "frame")

    return reduce_grads


def fastdvd_frames_apply(mesh: Mesh, window: int = 5, shared_triplet: bool = True,
                         chunk: int | None = None) -> Callable[[nn.Module, Tensor, Tensor], Tensor]:
    """FastDVDnet on this rank's frames ``(B_local, H, W, 3)`` of a cube
    spread over ``mesh``'s ``frame`` axis, returning the rank's denoised
    frames; the circular windows reach the neighbours' frames through the
    ring halo.

    ``shared_triplet`` with 5-frame windows and no ``chunk``:
    ``triplet_stage1`` once per distinct circular triplet of the rank's
    frames, a 1-frame halo exchange of its output, then ``triplet_stage2``
    (``B_local >= 1``; frozen BatchNorm, as ``seq_circular``). Otherwise each
    frame's window comes through one 2-frame halo exchange (``B_local >=
    2``) and the model runs on the windows, in sequential groups of ``chunk``
    when given."""

    def apply(net: nn.Module, local: Tensor, sigma: Tensor) -> Tensor:
        if shared_triplet and window == 5 and chunk is None:
            trip = halo_windows(local, mesh, "frame", 3)
            t1 = net.triplet_stage1(trip[:, 0], trip[:, 1], trip[:, 2], sigma)
            t1trip = halo_windows(t1, mesh, "frame", 3)
            return net.triplet_stage2(t1trip[:, 0], t1trip[:, 1], t1trip[:, 2], sigma)
        windows = halo_windows(local, mesh, "frame", window)
        b = windows.shape[0]
        if chunk is None or chunk >= b:
            return net(windows, sigma)
        if b % chunk:
            raise ValueError(f"window_chunk {chunk} does not divide the rank's {b} frames")
        return torch.cat([net(windows[i:i + chunk], sigma) for i in range(0, b, chunk)])

    return apply


def fastdvd_prior_frames(model: nn.Module, mesh: Mesh, window: int = 5,
                         window_chunk: int | None = None, adapt_window_chunk: int | None = None,
                         adapt_mask: tuple[str, float] | None = None,
                         shared_triplet: bool = True) -> Prior:
    """The FastDVDnet prior (:func:`~adaptivepnp_sci_torch.solvers.priors.fastdvd_prior`'s
    options) on this rank's frames (:func:`fastdvd_frames_apply`), with its
    parameters' gradients summed over the frame ranks."""
    return Prior("fastdvd", model,
                 fastdvd_frames_apply(mesh, window, shared_triplet, window_chunk),
                 loss_mode="bayer1", adapt_noise_std=5.0 / 255.0, adapt_mask=adapt_mask,
                 apply_adapt=fastdvd_frames_apply(mesh, window, shared_triplet,
                                                  adapt_window_chunk or window_chunk),
                 reduce_grads=_frame_grads(mesh))


def ffdnet_prior_frames(model: nn.Module, mesh: Mesh) -> Prior:
    """The FFDNet prior on this rank's frames (it denoises each frame alone),
    with its parameters' gradients summed over the frame ranks."""
    return Prior("ffdnet", model, _apply_module, loss_mode="packed4", adapt_noise_std=0.0,
                 reduce_grads=_frame_grads(mesh))


def fastdvd_prior_sharded(model: nn.Module, mesh: Mesh, window: int = 5,
                          shared_triplet: bool = True) -> Prior:
    """FastDVDnet prior with the frame axis spread over the mesh's ``frame``
    ranks; a drop-in for :func:`~adaptivepnp_sci_torch.solvers.priors.fastdvd_prior`.

    Every rank is given the whole ``(B, H, W, 3)`` cube, denoises its own
    ``B / frame`` consecutive frames (:func:`fastdvd_frames_apply`) and
    returns the whole denoised cube, all-gathered over the frame group.

    Under the adaptation's gradient, each rank's backward reaches the
    parameters through its own frames only (the gather hands each rank its
    slice's gradient, the halo exchange routes the halos' gradients to the
    frames' owners), and ``Prior.reduce_grads`` sums the parameters'
    gradients over the frame group: every rank steps with the gradient of
    the unsharded prior. Its ``frame_sharded`` form is
    :func:`fastdvd_prior_frames`."""
    local_apply = fastdvd_frames_apply(mesh, window, shared_triplet)

    def apply(net: nn.Module, rgb: Tensor, sigma: Tensor) -> Tensor:
        return gather(local_apply(net, shard(rgb, mesh, "frame"), sigma), mesh, "frame")

    def on_frames(m: Mesh) -> Prior:
        return fastdvd_prior_frames(model, m, window, shared_triplet=shared_triplet)

    return Prior("fastdvd", model, apply, loss_mode="bayer1", adapt_noise_std=5.0 / 255.0,
                 reduce_grads=_frame_grads(mesh), frame_sharded=on_frames)


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
