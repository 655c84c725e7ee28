"""Distill an FFDNet teacher into FastDVDnet (port of
``scripts/distill_fastdvd.py``).

FastDVDnet trained to match the FFDNet operator on a mixed-style input pool
(scale-matched 64 px crops of 256 and 512 px procedural videos): the
targets carry the teacher's natural-image prior and its contraction
behaviour rather than the procedural generator's inverse
(``train.tasks.fastdvd_task`` with ``teacher=`` and ``distill_weight``).

The teacher is FFDNet-color with the weights of ``--teacher PATH``: the
reference's ``.pth``, a ``/``-keyed ``.npz`` of Flax variables or a
trainer ``.pt``. The student starts from PyTorch's default initialisation
under seed 0; the draws come from a CPU generator seeded with 0. A run
writes ``{out}/final.pt`` and ``{out}/final.npz``.

Usage:
  python -m adaptivepnp_sci_torch.distill_fastdvd --teacher PATH [steps] [n_clips]
      [styles] [w] [out] [--device cuda|cpu]
    styles  comma list for synthetic_video_dataset (default
            smooth,textured,leaves,photos: the full mix)
    w       distill weight in [0,1] (1 = pure distillation; default 1)
"""

from __future__ import annotations

import argparse
from typing import Callable

import torch
from torch import Tensor

STYLES = ("smooth", "textured", "leaves", "photos")


def load_teacher(path: str) -> dict[str, Tensor]:
    """FFDNet-color's state dict from a reference ``.pth``, a ``/``-keyed
    ``.npz`` of Flax variables or a trainer ``.pt``."""
    from adaptivepnp_sci_torch.models import convert
    from adaptivepnp_sci_torch.train.trainer import load_checkpoint_variables

    if path.endswith(".pth"):
        return convert.load_ffdnet(path)
    return load_checkpoint_variables(path)


def teacher_fn(path: str, device: torch.device | str) -> Callable[[Tensor, Tensor], Tensor]:
    """``(noisy (N, H, W, 3), sigma) -> FFDNet's output`` with the weights of
    ``path``, in eval mode on ``device``."""
    from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color
    from adaptivepnp_sci_torch.solvers.priors import module_copy

    net = module_copy(ffdnet_color(), load_teacher(path), device).requires_grad_(False)

    def teacher(noisy_center: Tensor, sigma: Tensor) -> Tensor:
        return net(noisy_center, sigma)

    return teacher


def main(teacher: str, steps: int = 25000, n_clips: int = 4096,
         styles: tuple[str, ...] = STYLES, distill_weight: float = 1.0,
         out_dir: str = "weights/fastdvd_distill", device: torch.device | str = "cuda"):
    """Distill the FFDNet of ``teacher`` into FastDVDnet for ``steps`` on
    ``device``; returns the trainer and its losses."""
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.regenerate_weights import BATCH, initial_variables, train_and_save
    from adaptivepnp_sci_torch.train.datasets import batch_iterator, synthetic_video_dataset
    from adaptivepnp_sci_torch.train.tasks import fastdvd_task

    pool = synthetic_video_dataset(n_clips, length=5, size=64, seed=123,
                                   source_sizes=(256, 512), styles=styles)
    clips = torch.as_tensor(pool, device=device)
    task = fastdvd_task(FastDVDnet(), demosaic_aug=True, teacher=teacher_fn(teacher, device),
                        distill_weight=distill_weight)
    trainer, losses = train_and_save(task, initial_variables("fastdvd"), len(clips), steps,
                                     out_dir, batch_iterator(clips, BATCH, seed=0), device, 500)
    print(f"distill: {trainer.step} steps, loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f} -> {out_dir}/final.pt")
    return trainer, losses


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*", help="steps, n_clips, styles, w, out")
    ap.add_argument("--teacher", required=True,
                    help="FFDNet-color weights: .pth, /-keyed .npz or trainer .pt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain versions of the kernels")
    ns = ap.parse_args()
    a = ns.args
    main(
        ns.teacher,
        steps=int(a[0]) if len(a) > 0 else 25000,
        n_clips=int(a[1]) if len(a) > 1 else 4096,
        styles=tuple(a[2].split(",")) if len(a) > 2 else STYLES,
        distill_weight=float(a[3]) if len(a) > 3 else 1.0,
        out_dir=a[4] if len(a) > 4 else "weights/fastdvd_distill",
        device=_check_device(ns.device),
    )
