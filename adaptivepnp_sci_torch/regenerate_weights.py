"""Regenerate the FastDVDnet / DDnet weights by offline training (port of
``scripts/regenerate_weights.py``).

Without the DAVIS data the reference trained on, training uses procedurally
generated video clips from the same family as the synthetic benchmark
scenes, or the clips of real videos under ``video_dir``
(:func:`~adaptivepnp_sci_torch.data.video.video_clip_dataset`). The defaults
reproduce the recipe of the shipped weights: the data stays on the device,
Adam at lr 1e-3 over batches of 32, milestone drops at 2/3 and 5/6 of the
run, FastDVDnet with the demosaicking augmentation and the optional
Lipschitz and spectral penalties (``train.tasks.fastdvd_task``).

The weights start from PyTorch's default initialisation under seed 0
(:func:`initial_variables`); the trainer's draws come from a CPU generator
seeded with 0, so a run on the card draws what a CPU run draws. A run writes
``{out_dir}/final.pt`` (a trainer checkpoint) and ``{out_dir}/final.npz``
(the Flax-layout variables, which both packages read), where the JAX
script writes an orbax ``final`` directory.

Usage: python -m adaptivepnp_sci_torch.regenerate_weights [fastdvd|ddnet] [steps]
       [textured] [lipschitz_weight] [spectral_weight] [out_dir] [spectral_target]
       [spectral_iters] [n_clips] [clip_size] [styles] [video_dir] [--device cuda|cpu]
``styles`` is a comma-separated scene-family mix (e.g. ``smooth,leaves``)
for ``synthetic_video_dataset``; ``-`` keeps the default and reaches the
``video_dir`` position.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Iterator

import numpy as np
import torch

#: clips per step of every run of the weight tooling
BATCH = 32


def initial_variables(network: str) -> dict[str, torch.Tensor]:
    """The starting state dict of ``network`` (``fastdvd`` or ``ddnet``):
    PyTorch's default initialisation under seed 0."""
    from adaptivepnp_sci_torch.cli import _seeded_init
    from adaptivepnp_sci_torch.models.ddnet import DDnet
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet

    return _seeded_init({"fastdvd": FastDVDnet, "ddnet": DDnet}[network], 0)


def schedule(n_clips: int, steps: int) -> tuple[int, tuple[int, int]]:
    """``(steps_per_epoch, milestones)`` of a run of ``steps`` over a pool of
    ``n_clips``: one epoch a pass over the pool, the drops at 2/3 and 5/6 of
    the run's epochs (both 0 in a run shorter than an epoch)."""
    spe = max(n_clips // BATCH, 1)
    return spe, (steps // spe * 2 // 3, steps // spe * 5 // 6)


def train_and_save(task, variables: dict, n_clips: int, steps: int, out_dir: str,
                   batches: Iterator[Any], device: torch.device | str, log_every: int):
    """Train ``task`` from ``variables`` for ``steps`` at lr 1e-3 on
    ``batches`` (a pool of ``n_clips``), then write ``{out_dir}/final.pt``
    and ``{out_dir}/final.npz``; returns the trainer and its losses."""
    from adaptivepnp_sci_torch.train import Trainer, TrainerConfig
    from adaptivepnp_sci_torch.train.trainer import save_variables_npz

    spe, milestones = schedule(n_clips, steps)
    trainer = Trainer(task, variables,
                      TrainerConfig(lr=1e-3, steps_per_epoch=spe, milestones=milestones,
                                    ckpt_dir=out_dir, ckpt_every_epochs=10**9, seed=0),
                      device=device)
    trainer.generator = torch.Generator().manual_seed(trainer.config.seed)
    losses = trainer.fit(batches, max_steps=steps, log_every=log_every)
    trainer.save(os.path.join(out_dir, "final.pt"))
    save_variables_npz(os.path.join(out_dir, "final.npz"), trainer.variables)
    return trainer, losses


def make_pool(n_clips: int = 0, textured: bool = False, clip_size: int = 64,
              styles: tuple[str, ...] | None = None, video_dir: str | None = None) -> np.ndarray:
    """The training clips ``(n, 5, clip_size, clip_size, 3)``: 768 (textured)
    or 512 procedural clips by default; ``n_clips > 0`` switches to random
    crops of 256 and 512 px source videos, whose pixel statistics match the
    full-resolution scenes; ``video_dir``: clips of the videos there."""
    from adaptivepnp_sci_torch.train.datasets import synthetic_video_dataset

    n = n_clips or (768 if textured else 512)
    if video_dir is not None:
        if textured or styles:
            raise SystemExit(
                "video_dir supplies the training data; textured/styles configure the "
                "synthetic pool only: pass '0' and '-' for those positions when training "
                "from video files")
        from adaptivepnp_sci_torch.data.video import video_clip_dataset

        return video_clip_dataset(video_dir, n, length=5, size=clip_size, seed=123)
    return synthetic_video_dataset(n, length=5, size=clip_size, seed=123, textured=textured,
                                   source_sizes=(256, 512) if n_clips else None, styles=styles)


def main(network: str, steps: int, textured: bool = False, lipschitz: float = 0.0,
         spectral: float = 0.0, out_dir: str | None = None, spectral_target: float = 1.0,
         spectral_iters: int = 2, n_clips: int = 0, clip_size: int = 64,
         styles: tuple[str, ...] | None = None, video_dir: str | None = None,
         device: torch.device | str = "cuda"):
    """Train ``network`` for ``steps`` on ``device`` and write its weights
    under ``out_dir`` (default ``weights/{network}``); returns the trainer
    and its losses."""
    from adaptivepnp_sci_torch.train.datasets import batch_iterator
    from adaptivepnp_sci_torch.train.tasks import ddnet_task, fastdvd_task

    clips = torch.as_tensor(make_pool(n_clips, textured, clip_size, styles, video_dir),
                            device=device)
    if network == "fastdvd":
        from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet

        task = fastdvd_task(FastDVDnet(), demosaic_aug=True, lipschitz_penalty=lipschitz,
                            spectral_penalty=spectral, spectral_target=spectral_target,
                            spectral_iters=spectral_iters)
    elif network == "ddnet":
        from adaptivepnp_sci_torch.models.ddnet import DDnet

        task = ddnet_task(DDnet())
    else:
        raise SystemExit(f"unknown network {network}")
    out_dir = out_dir or f"weights/{network}"
    trainer, losses = train_and_save(task, initial_variables(network), len(clips), steps,
                                     out_dir, batch_iterator(clips, BATCH, seed=0), device, 200)
    print(f"{network}: {trainer.step} steps, loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    return trainer, losses


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*", help="the positional arguments of the usage line")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain versions of the kernels")
    ns = ap.parse_args()
    a = ns.args
    if not a:
        ap.error("the network (fastdvd or ddnet) is required")
    main(
        a[0],
        int(a[1]) if len(a) > 1 else 3000,
        textured=len(a) > 2 and a[2] == "textured",
        lipschitz=float(a[3]) if len(a) > 3 else 0.0,
        spectral=float(a[4]) if len(a) > 4 else 0.0,
        out_dir=a[5] if len(a) > 5 else None,
        spectral_target=float(a[6]) if len(a) > 6 else 1.0,
        spectral_iters=int(a[7]) if len(a) > 7 else 2,
        n_clips=int(a[8]) if len(a) > 8 else 0,
        clip_size=int(a[9]) if len(a) > 9 else 64,
        # '-'/''/'none' = placeholder to reach the video_dir position
        styles=tuple(a[10].split(",")) if len(a) > 10 and a[10] not in ("-", "", "none")
        else None,
        video_dir=a[11] if len(a) > 11 else None,
        device=_check_device(ns.device),
    )
