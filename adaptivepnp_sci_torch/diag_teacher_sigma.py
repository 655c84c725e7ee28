"""Diagnostic: is the distilled FastDVDnet student's expansive Jacobian
inherited from its FFDNet teacher, or imitation error? (port of
``scripts/diag_teacher_sigma.py``)

On the held-out clips ``eval_weights`` uses (4 synthetic clips of 5 frames
at 64^2, seed 9), it measures:
  * the teacher's sigma_max: FFDNet applied frame by frame, the operator
    the student was distilled toward (:class:`FrameWise`);
  * each student's sigma_max (as ``eval_weights`` reports it);
  * the teacher-student output distance (rms) on noisy clips (sigma 20/255,
    train-like inputs).

Every draw goes through :func:`adaptivepnp_sci_torch.eval_weights.draw_normal`
from a CPU generator seeded with 0 (the power iteration's start, the noise).
A student path that does not exist prints a ``[skip]`` line.

Usage: python -m adaptivepnp_sci_torch.diag_teacher_sigma --ffdnet PATH [student ...]
       [--device cuda|cpu]   (default students: weights/fastdvd_distill/final.pt,
       weights/fastdvd.npz)
"""

from __future__ import annotations

import os

import torch
from torch import Tensor

from adaptivepnp_sci_torch import studies
from adaptivepnp_sci_torch.models.ffdnet import FFDNet

STUDENTS = ("weights/fastdvd_distill/final.pt", str(studies.REPO_WEIGHTS / "fastdvd.npz"))
NOISE_SIGMA = 20 / 255


class FrameWise(FFDNet):
    """FFDNet applied to each frame of ``(N, F, H, W, 3)`` clips, the input
    signature of ``eval_weights.sigma_max_eval``, so that the teacher's
    Jacobian is measured at the student's probe points. Its state dict is
    FFDNet's."""

    def forward(self, x: Tensor, sigma: Tensor | float) -> Tensor:
        n, f, h, w, c = x.shape
        s = torch.as_tensor(sigma, dtype=x.dtype, device=x.device).reshape(-1).expand(n)
        out = super().forward(x.reshape(n * f, h, w, c), s.repeat_interleave(f))
        return out.reshape(n, f, h, w, c)


def teacher_model() -> FrameWise:
    return FrameWise(in_nc=3, out_nc=3, nc=96, nb=12)


def diagnose(teacher: FrameWise, teacher_params: dict, students: dict[str, dict],
             clips: Tensor) -> tuple[float, list[tuple[str, float, float]]]:
    """The teacher's sigma_max and ``(name, sigma_max, rms(student,
    teacher))`` per student, on ``clips`` (on the device to run on)."""
    from adaptivepnp_sci_torch.eval_weights import draw_normal, sigma_max_eval
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.solvers.priors import module_copy
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32

    def key() -> torch.Generator:
        return torch.Generator().manual_seed(0)

    t_smax = sigma_max_eval(teacher, teacher_params, clips, key())
    dev = clips.device
    t_net = module_copy(teacher, teacher_params, dev)
    student = FastDVDnet()
    sig = torch.full((clips.shape[0],), NOISE_SIGMA, device=dev)
    rows = []
    for name, v in students.items():
        s_smax = sigma_max_eval(student, v, clips, key())
        noisy = clips + NOISE_SIGMA * draw_normal(key(), tuple(clips.shape)).to(dev)
        s_net = module_copy(student, v, dev)
        with full_f32(), torch.no_grad():
            t_out = t_net(noisy, sig)[:, 2]
            s_out = s_net(noisy, sig)
        rows.append((name, s_smax, float(torch.sqrt(torch.mean((t_out - s_out) ** 2)))))
    return t_smax, rows


def main(ffdnet: str | dict, students: list[str] | None = None,
         device: torch.device | str = "cuda", teacher: FrameWise | None = None,
         size: int = 64) -> tuple[float, list[tuple[str, float, float]]]:
    """Print the teacher's and each present student's line; returns
    :func:`diagnose`'s result."""
    from adaptivepnp_sci_torch.train.datasets import synthetic_video_dataset
    from adaptivepnp_sci_torch.train.trainer import load_checkpoint_variables

    clips = torch.as_tensor(synthetic_video_dataset(4, length=5, size=size, seed=9),
                            device=device)
    loaded = {}
    for path in students or STUDENTS:
        if os.path.exists(path):
            loaded[path] = load_checkpoint_variables(path)
        else:
            print(f"[skip] {path} absent")
    t_smax, rows = diagnose(teacher_model() if teacher is None else teacher,
                            studies.load_ffdnet_weights(ffdnet), loaded, clips)
    print(f"teacher (FFDNet frame-wise) sigma_max = {t_smax:.3f}")
    for path, s_smax, d in rows:
        print(f"{path}: sigma_max={s_smax:.3f}  rmse(student, teacher)={d:.4f}")
    return t_smax, rows


if __name__ == "__main__":
    from adaptivepnp_sci_torch.cli import _check_device

    ap = studies.parser(__doc__, ffdnet=True)
    ap.add_argument("students", nargs="*")
    args = ap.parse_args()
    main(args.ffdnet, args.students or None, _check_device(args.device))
