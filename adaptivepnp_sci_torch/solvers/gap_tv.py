"""GAP-TV warm-start solver (port of ``adaptivepnp_sci_tpu.solvers.gap_tv``).

Generalized alternating projection with a TV prior on the packed Bayer cube
``(B, 4, H/2, W/2)``. Each iteration runs the GAP x-update, the Chambolle TV
prox over all ``B*4`` planes, a clip to [0, 1] and the dual update. The
x-update and the prox go through the kernel wrappers of
:mod:`adaptivepnp_sci_torch.ops.cuda_kernels`: CUDA kernels for CUDA
tensors, the plain versions for CPU tensors, unless ``use_kernels`` says
otherwise. With the frames spread over the
ranks of a mesh's ``frame`` axis, each rank holds its frames' planes: the
x-update runs in its split form (the frame sum's terms gathered between its
two launches) and the TV prox on the rank's planes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch
from torch import Tensor

from adaptivepnp_sci_torch.ops import bayer, cuda_kernels, metrics, physics

if TYPE_CHECKING:
    from adaptivepnp_sci_torch.adapt.online import FrameShard
    from adaptivepnp_sci_torch.parallel.mesh import Mesh


@dataclass(frozen=True)
class GapTVConfig:
    iters: int = 40
    lam: float = 1.0
    gamma: float = 0.01
    tv_weight: float = 0.1
    tv_iters: int = 5
    #: the x-update and TV kernels (JAX's ``use_pallas``): None by the
    #: tensors' device, False the plain versions on any device, True the
    #: kernels (a ValueError on CPU tensors); see ``cuda_kernels.runs_kernel``
    use_kernels: bool | None = None


class GapTVResult(NamedTuple):
    x_bayer: Tensor      # (B, H, W) reconstruction (from x, reference parity)
    psnr_per_frame: Tensor
    ssim_per_frame: Tensor
    psnr_trace: Tensor   # per-iteration PSNR vs orig (0 if orig not given)


def _gap_tv_packed(y: Tensor, phi: Tensor, x0: Tensor, orig: Tensor | None,
                   config: GapTVConfig, frames: "FrameShard | None" = None
                   ) -> tuple[Tensor, Tensor]:
    """Runs the warm start on packed tensors, ``(B, 4, h, w)`` or with a
    leading item axis (``phi`` per item or shared; one kernel launch per step
    for all items); returns ``(x, psnr_trace)``, the trace of ``x`` against
    ``orig`` (zeros without ``orig``). ``frames``: ``phi``, ``x0``, ``orig``
    and the returned ``x`` hold this rank's frames; the trace is the whole
    cube's PSNR."""
    phi_s = physics.phi_sum(phi, physics.PACKED_FRAME_AXIS,
                            None if frames is None else frames.gather)
    psnr = metrics.psnr if frames is None else frames.psnr
    x, theta, b = x0, x0, torch.zeros_like(x0)
    trace = []
    for _ in range(config.iters):
        x = cuda_kernels.gap_x_update(theta, b, y, phi, phi_s, config.lam, config.gamma, frames,
                                      config.use_kernels)
        xb = x - b
        theta = cuda_kernels.tv_chambolle_fused(xb, weight=config.tv_weight,
                                                max_iter=config.tv_iters,
                                                use_kernels=config.use_kernels)
        theta = torch.clamp(theta, 0.0, 1.0)
        b = b - (x - theta)
        if orig is not None:
            trace.append(psnr(orig, bayer.unpack(x)))
    if orig is None:
        return x, torch.zeros(config.iters, dtype=torch.float32, device=x.device)
    return x, torch.stack(trace)


def as_f32(a: np.ndarray | Tensor, device: torch.device | str) -> Tensor:
    """A float32 tensor on ``device`` (no copy when it already is one)."""
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def gap_tv(
    y_bayer: np.ndarray | Tensor,
    phi_bayer: np.ndarray | Tensor,
    config: GapTVConfig = GapTVConfig(),
    x0_bayer: np.ndarray | Tensor | None = None,
    orig_bayer: np.ndarray | Tensor | None = None,
    device: torch.device | str = "cuda",
    mesh: "Mesh | None" = None,
) -> GapTVResult:
    """Warm-start reconstruction.

    Args:
      y_bayer:   snapshot measurement ``(H, W)``.
      phi_bayer: per-frame masks ``(B, H, W)``.
      x0_bayer:  optional initialization ``(B, H, W)`` (default ``At(y)``).
      orig_bayer: optional ground truth ``(B, H, W)`` for metrics.
      device:    where to run; the kernels run on CUDA.
      mesh:      every rank given the whole inputs solves its ``B / frame``
        consecutive frames of the mesh's ``frame`` axis and returns the
        whole result (:class:`~adaptivepnp_sci_torch.adapt.online.FrameShard`);
        one ``frame`` rank: the one-process path.
    """
    from adaptivepnp_sci_torch.adapt.online import FrameShard

    y = bayer.pack(as_f32(y_bayer, device))
    phi = bayer.pack(as_f32(phi_bayer, device))
    frames = FrameShard.of(mesh, phi.shape[0])

    def mine(t: Tensor) -> Tensor:
        return t if frames is None else frames.local(t)

    x0 = (physics.adjoint(y, mine(phi)) if x0_bayer is None
          else mine(bayer.pack(as_f32(x0_bayer, device))))
    orig = as_f32(orig_bayer, device) if orig_bayer is not None else None
    with torch.no_grad():
        x, trace = _gap_tv_packed(y, mine(phi), x0, None if orig is None else mine(orig),
                                  config, frames)
        if frames is not None:
            x = frames.gather(x)
        x_bayer = bayer.unpack(x)
        if orig is not None:
            p = metrics.psnr_per_frame(orig, x_bayer)
            s = metrics.ssim_per_frame(orig, x_bayer)
        else:
            p = s = torch.zeros(x_bayer.shape[0], dtype=torch.float32, device=x.device)
    return GapTVResult(x_bayer, p, s, trace)
