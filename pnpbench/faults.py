"""Faults planted in the program under the benchmark, for the checks that
``correct`` catches them (``tests/test_pnpbench_faults.py`` on the CPU,
``control.py --faults`` on the card), and the kernel-free variant of the
bf16 prior that serves as a second witness.

Each takes ``patch(obj, name, value)`` (``monkeypatch.setattr``, or
:class:`Patches`) and breaks one step of the timed path:

* a step that returns its state unchanged: the ADMM x-update, the TV prox,
  Adam;
* half of the batch left out: the prior on half of the frames (the rest
  passed through), the adaptation's mean loss over half of the rows, the TV
  prox on half of the planes;
* an answer altered where it is produced: one frame of the reconstruction
  the entry returns set to zero;
* a step cut short: the TV prox stopping one inner iteration before the
  schedule's last.

One chip has no exchange between chips to leave out.
"""

from __future__ import annotations

from typing import Any, Callable


class Patches:
    """``setattr`` with undo, as a context manager."""

    def __init__(self):
        self.undo: list[tuple[Any, str, Any]] = []

    def __call__(self, obj: Any, name: str, value: Any) -> None:
        self.undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def __enter__(self) -> "Patches":
        return self

    def __exit__(self, *exc) -> None:
        for obj, name, value in reversed(self.undo):
            setattr(obj, name, value)


def x_update_unchanged(patch: Callable) -> None:
    from adaptivepnp_sci_torch.ops import cuda_kernels

    patch(cuda_kernels, "admm_x_update", lambda theta, *a, **k: theta)


def adam_unchanged(patch: Callable) -> None:
    import torch

    patch(torch.optim.Adam, "step", lambda self, closure=None: None)


def prior_on_half_the_frames(patch: Callable) -> None:
    from pnpbench.models import fastdvdnet, ffdnet

    for mod in (ffdnet, fastdvdnet):
        make = mod.program_prior

        def broken(config, params, device, make=make):
            prior = make(config, params, device)

            def apply(net, rgb, sigma, apply=prior.apply):
                out = rgb.clone()
                half = rgb.shape[0] // 2
                out[:half] = apply(net, rgb[:half], sigma)
                return out

            return prior._replace(apply=apply)

        patch(mod, "program_prior", broken)


def loss_over_half_the_rows(patch: Callable) -> None:
    from adaptivepnp_sci_torch.adapt import online

    make = online.measurement_loss_fn

    def half(prior, net, rgb, sigma, y_p, phi_p, y_f, phi_f, frames=None):
        h = rgb.shape[-3] // 4 * 2
        return make(prior, net, rgb[..., :h, :, :], sigma, y_p[..., :h // 2, :],
                    phi_p[..., :h // 2, :], y_f[..., :h, :], phi_f[..., :h, :], frames)

    patch(online, "measurement_loss_fn", half)


def _frame_zeroed(patch: Callable, module: Any, name: str) -> None:
    solve = getattr(module, name)

    def altered(*a, **k):
        res = solve(*a, **k)
        res.x_bayer[0] = 0.0
        return res

    patch(module, name, altered)


def reconstruction_altered(patch: Callable) -> None:
    from adaptivepnp_sci_torch.solvers import end_to_end

    _frame_zeroed(patch, end_to_end, "reconstruct_single_dispatch")


def tv_unchanged(patch: Callable) -> None:
    from adaptivepnp_sci_torch.ops import cuda_kernels

    patch(cuda_kernels, "tv_chambolle_fused", lambda x, *a, **k: x)


def tv_on_half_the_planes(patch: Callable) -> None:
    from adaptivepnp_sci_torch.ops import cuda_kernels

    tv = cuda_kernels.tv_chambolle_fused

    def half(x, *a, **k):
        out = x.clone()
        n = x.shape[0] // 2
        out[:n] = tv(x[:n], *a, **k)
        return out

    patch(cuda_kernels, "tv_chambolle_fused", half)


def tv_one_inner_iteration_fewer(patch: Callable) -> None:
    from adaptivepnp_sci_torch.ops import cuda_kernels

    tv = cuda_kernels.tv_chambolle_fused

    def fewer(x, weight=0.1, eps=2.0e-4, max_iter=5, use_kernels=None):
        return tv(x, weight, eps, max_iter - 1, use_kernels)

    patch(cuda_kernels, "tv_chambolle_fused", fewer)


def warm_start_altered(patch: Callable) -> None:
    from adaptivepnp_sci_torch.solvers import gap_tv

    _frame_zeroed(patch, gap_tv, "gap_tv")


def plain_conv_pair(patch: Callable) -> None:
    """Not a fault: the bf16 prior's conv pairs on the library's
    convolutions (the plain version) in place of the fused kernel K3."""
    from adaptivepnp_sci_torch.ops import convpair, cuda_kernels

    patch(cuda_kernels, "convpair", lambda x, *a, design=None: convpair.convpair(x, *a))


ADAPTIVE = (x_update_unchanged, adam_unchanged, prior_on_half_the_frames,
            loss_over_half_the_rows, reconstruction_altered)
WARM_START = (tv_unchanged, tv_on_half_the_planes, tv_one_inner_iteration_fewer,
              warm_start_altered)
BY_NAME = {f.__name__: f for f in (*ADAPTIVE, *WARM_START, plain_conv_pair)}
