"""Distill an FFDNet teacher into FastDVDnet on the plug-and-play loop's own
iterates (port of ``scripts/distill_iterates.py``).

Stage 2 of the distillation chain: value matching on Gaussian-noised clips
(``adaptivepnp_sci_torch.distill_fastdvd``) transfers the teacher's prior
standalone, but the student's Jacobian can be expansive off that manifold.
This run trains on the union of

  * the harvested ADMM iterates (``adaptivepnp_sci_torch.harvest_iterates``),
    used as they are, and
  * clean synthetic clips (the scale-matched mixed-style pool) with fresh
    Gaussian noise each step, sigma uniform in [5, 55]/255,

with the teacher's output as the only target, plus optional Jacobian (jvp)
matching (``train.tasks.fastdvd_distill_task``).

The teacher is FFDNet-color with the weights of ``--teacher PATH`` (``.pth``,
``/``-keyed ``.npz`` or trainer ``.pt``); the student starts from PyTorch's
default initialisation under seed 0; the draws come from a CPU generator
seeded with 0. A run writes ``{out}/final.pt`` and ``{out}/final.npz``.

Usage:
  python -m adaptivepnp_sci_torch.distill_iterates --teacher PATH pool.npz [steps]
      [jac_weight] [n_synth] [out_dir] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def make_pool(pool_path: str, n_synth: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(clips, sigmas, needs_noise)``: the harvested iterates (no noise),
    then ``n_synth`` synthetic clips with sigmas uniform in [5, 55]/255
    (noised each step)."""
    from adaptivepnp_sci_torch.distill_fastdvd import STYLES
    from adaptivepnp_sci_torch.train.datasets import synthetic_video_dataset

    with np.load(pool_path) as z:
        it_clips = z["clips"].astype(np.float32)
        it_sigmas = z["sigmas"].astype(np.float32)
    synth = synthetic_video_dataset(n_synth, length=5, size=64, seed=123,
                                    source_sizes=(256, 512), styles=STYLES).astype(np.float32)
    rng = np.random.default_rng(3)
    synth_sigmas = rng.uniform(5 / 255, 55 / 255, len(synth)).astype(np.float32)
    clips = np.concatenate([it_clips, synth])
    sigmas = np.concatenate([it_sigmas, synth_sigmas])
    needs_noise = np.concatenate([np.zeros(len(it_clips), np.float32),
                                  np.ones(len(synth), np.float32)])
    print(f"pool: {len(it_clips)} iterate probes + {len(synth)} synth clips")
    return clips, sigmas, needs_noise


def main(pool_path: str, teacher: str, steps: int = 25000, jac_weight: float = 0.0,
         n_synth: int = 2048, out_dir: str = "weights/fastdvd_distill_it",
         device: torch.device | str = "cuda"):
    """Distill the FFDNet of ``teacher`` into FastDVDnet for ``steps`` on
    ``device``; returns the trainer and its losses."""
    from adaptivepnp_sci_torch.distill_fastdvd import teacher_fn
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.regenerate_weights import BATCH, initial_variables, train_and_save
    from adaptivepnp_sci_torch.train.datasets import paired_batch_iterator
    from adaptivepnp_sci_torch.train.tasks import fastdvd_distill_task

    arrays = tuple(torch.as_tensor(a, device=device) for a in make_pool(pool_path, n_synth))
    task = fastdvd_distill_task(FastDVDnet(), teacher_fn(teacher, device), jac_weight=jac_weight)
    trainer, losses = train_and_save(task, initial_variables("fastdvd"), len(arrays[0]), steps,
                                     out_dir, paired_batch_iterator(arrays, BATCH, seed=0),
                                     device, 500)
    print(f"distill-iterates: {trainer.step} steps, jac_weight={jac_weight}, "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f} -> {out_dir}/final.pt")
    return trainer, losses


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*", help="pool.npz, steps, jac_weight, n_synth, out_dir")
    ap.add_argument("--teacher", required=True,
                    help="FFDNet-color weights: .pth, /-keyed .npz or trainer .pt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain versions of the kernels")
    ns = ap.parse_args()
    a = ns.args
    main(
        a[0] if a else "weights/iterate_pool.npz",
        ns.teacher,
        steps=int(a[1]) if len(a) > 1 else 25000,
        jac_weight=float(a[2]) if len(a) > 2 else 0.0,
        n_synth=int(a[3]) if len(a) > 3 else 2048,
        out_dir=a[4] if len(a) > 4 else "weights/fastdvd_distill_it",
        device=_check_device(ns.device),
    )
