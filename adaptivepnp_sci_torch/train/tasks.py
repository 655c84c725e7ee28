"""Training tasks: batch synthesis and loss per network
(port of ``adaptivepnp_sci_tpu.train.tasks``).

A task's ``loss_fn(net, generator, batch)`` augments and noises the raw
batch, runs the module ``net`` and returns the loss; train-mode BatchNorm
moves ``net``'s running statistics as the forward runs, once per step.

Reference semantics:

* FFDNet: sigma uniform in [0, 75]/255, loss MSE/2
  (``packages/ffdnet/train.py:126-154``);
* FastDVDnet: 5-frame clips, sigma in [5, 55]/255, loss against the clean
  centre frame /2, train-mode BatchNorm
  (``packages/fastdvdnet/train_fastdvdnet.py:118-136``);
* DDnet: sigma = 1/255, every frame mosaicked to sparse RGB, the target the
  *noisy* centre frame, plain MSE (``packages/DDnet/train_DDnet.py:114-124``).

The draws go through :mod:`adaptivepnp_sci_torch.train.augment`'s functions
and, for these tasks' own, :func:`draw_fraction`, :func:`draw_coin` and
:func:`draw_probe`: one function per kind of draw, for tests to replace with
the JAX package's draws. The Bernoulli and the uniform of the mismatched-
sigma fraction are separate draws, as the JAX package keeps them on separate
keys. Each is a per-sample draw of the global batch when the generator is a
:class:`~adaptivepnp_sci_torch.train.augment.ShardedGenerator`.

The penalties run the network again without touching the step's BatchNorm
statistics: the Lipschitz penalty's second train-mode forward under
:func:`~adaptivepnp_sci_torch.models.common.frozen_batch_stats` (JAX
discards its statistics), and the spectral and Jacobian penalties through the
eval-mode operator with the running statistics as they stood at the start
of the step (``torch.func.functional_call`` on a copy of the buffers, with
``torch.func.jvp`` / ``vjp`` for the Jacobian products).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, NamedTuple

import torch
import torch.nn as nn
from torch import Tensor

from adaptivepnp_sci_torch.models.common import frozen_batch_stats
from adaptivepnp_sci_torch.ops import bayer
from adaptivepnp_sci_torch.ops.demosaic import malvar2004
from adaptivepnp_sci_torch.train import augment


class TrainTask(NamedTuple):
    """``loss_fn(net, generator, batch) -> loss`` over a working copy ``net``
    of the template ``model``."""

    name: str
    model: nn.Module
    loss_fn: Callable[[nn.Module, augment.Draws, Any], Tensor]


def _uniform(g: torch.Generator, rows: int) -> Tensor:
    return torch.rand(rows, generator=g, device=g.device)


def draw_fraction(generator: augment.Draws, n: int) -> Tensor:
    """The mismatched-sigma fraction per sample: 1 with probability 1/2,
    else uniform in [0, 1); the coin and the uniform are separate draws."""
    coin = augment.per_sample(generator, n, _uniform) < 0.5
    u = augment.per_sample(generator, n, _uniform)
    return torch.where(coin, torch.ones_like(u), u)


def draw_coin(generator: augment.Draws, n: int) -> Tensor:
    """``demosaic_aug``'s per-sample fair coin (bool)."""
    return augment.per_sample(generator, n, _uniform) < 0.5


def draw_probe(generator: augment.Draws, shape: tuple[int, ...]) -> Tensor:
    """Standard normal probe directions: the Lipschitz perturbation (before
    its 0.02 scale), the power iteration's start, the Jacobian direction."""
    return augment.per_sample(generator, shape[0], lambda g, rows: torch.randn(
        (rows, *shape[1:]), generator=g, device=g.device))


def _to(t: Tensor, like: Tensor) -> Tensor:
    return t.to(device=like.device)


def _unit(v: Tensor) -> Tensor:
    """``v`` scaled to unit norm per sample (over all axes but the first)."""
    axes = tuple(range(1, v.dim()))
    return v / torch.sqrt(torch.clamp(torch.sum(v * v, dim=axes, keepdim=True), min=1e-20))


@contextlib.contextmanager
def _eval_operator(net: nn.Module, buffers: dict[str, Tensor], sigma: Tensor
                   ) -> Iterator[Callable[[Tensor], Tensor]]:
    """``x -> net(x, sigma)`` in eval mode with the given BatchNorm buffers and
    ``net``'s live parameters (differentiable in them), without
    recomputation, for ``torch.func`` transforms; ``net``'s mode is restored."""
    params = dict(net.named_parameters())
    training, remat = net.training, getattr(net, "remat", None)
    net.eval()
    if remat is not None:
        net.remat = False
    try:
        yield lambda x: torch.func.functional_call(net, {**params, **buffers}, (x, sigma))
    finally:
        net.train(training)
        if remat is not None:
            net.remat = remat


def _buffers(net: nn.Module) -> dict[str, Tensor]:
    return {k: b.detach().clone() for k, b in net.named_buffers()}


def ffdnet_task(model: nn.Module,
                sigma_range: tuple[float, float] = (0.0, 75 / 255)) -> TrainTask:
    def loss_fn(net: nn.Module, generator: augment.Draws, clean: Tensor) -> Tensor:
        clean = augment.augment_batch(generator, clean)
        sigma = _to(augment.random_sigma(generator, clean.shape[0], *sigma_range), clean)
        noisy = augment.add_gaussian_noise(generator, clean, sigma)
        out = net(noisy, sigma)
        return torch.mean((out - clean) ** 2) / 2.0

    return TrainTask("ffdnet", model, loss_fn)


def fastdvd_task(
    model: nn.Module,
    sigma_range: tuple[float, float] = (5 / 255, 55 / 255),
    demosaic_aug: bool = False,
    lipschitz_penalty: float = 0.0,
    spectral_penalty: float = 0.0,
    spectral_iters: int = 2,
    spectral_target: float = 1.0,
    teacher: Callable[[Tensor, Tensor], Tensor] | None = None,
    distill_weight: float = 1.0,
) -> TrainTask:
    """FastDVDnet on ``(N, 5, H, W, 3)`` clips, with the JAX package's options:

    * ``demosaic_aug``: a fair coin per sample passes the clip through
      ``mosaic`` -> Malvar before the noise (the solver feeds the denoiser
      demosaicked iterates);
    * half the batch noised at a fraction of its conditioning sigma
      (:func:`draw_fraction`);
    * ``teacher`` ``(noisy_centre, sigma) -> x_hat``, blended in at
      ``distill_weight``: ``(1-w)*MSE(out, clean)/2 + w*MSE(out, teacher)/2``;
    * ``lipschitz_penalty``: ``relu(||f(x+d)-f(x)||^2/||d_centre||^2 - 1)``
      through a second train-mode forward;
    * ``spectral_penalty``: ``relu(sigma_max - spectral_target)^2`` with
      sigma_max of the eval-mode operator's Jacobian by ``spectral_iters``
      rounds of power iteration on J^T J.
    """

    def loss_fn(net: nn.Module, generator: augment.Draws, clips: Tensor) -> Tensor:
        start = _buffers(net) if spectral_penalty > 0 else None
        clips = augment.augment_batch(generator, clips)
        n, f, h, w, _ = clips.shape
        net_in = clips
        if demosaic_aug:
            dm = malvar2004(bayer.mosaic(clips.reshape(n * f, h, w, 3))).reshape(clips.shape)
            use_dm = _to(draw_coin(generator, n), clips).reshape(n, 1, 1, 1, 1)
            net_in = torch.where(use_dm, dm, clips)
        sigma = _to(augment.random_sigma(generator, n, *sigma_range), clips)
        frac = _to(draw_fraction(generator, n), clips)
        noisy = augment.add_gaussian_noise(generator, net_in, sigma * frac)
        out = net(noisy, sigma)
        center = clips[:, f // 2]
        loss = torch.mean((out - center) ** 2) / 2.0
        if teacher is not None:
            with torch.no_grad():
                t_out = teacher(noisy[:, f // 2], sigma)
            loss = (1.0 - distill_weight) * loss + distill_weight * (
                torch.mean((out - t_out) ** 2) / 2.0)
        if lipschitz_penalty > 0:
            delta = 0.02 * _to(draw_probe(generator, tuple(noisy.shape)), noisy)
            with frozen_batch_stats(net):
                out2 = net(noisy + delta, sigma)
            num = torch.sum((out2 - out) ** 2, dim=(1, 2, 3))
            # against the centre frame's slice of the perturbation: the PnP
            # loop feeds the centre-frame output back as the next centre frame
            den = torch.sum(delta[:, f // 2] ** 2, dim=(1, 2, 3))
            ratio = num / torch.clamp(den, min=1e-12)
            loss = loss + lipschitz_penalty * torch.mean(torch.relu(ratio - 1.0))
        if spectral_penalty > 0:
            u = _unit(_to(draw_probe(generator, tuple(noisy.shape)), noisy))
            with _eval_operator(net, start, sigma) as op:
                with torch.no_grad():
                    for _ in range(spectral_iters):
                        _, ju = torch.func.jvp(op, (noisy,), (u,))
                        _, vjp_fn = torch.func.vjp(op, noisy)
                        u = _unit(vjp_fn(ju)[0])
                _, ju = torch.func.jvp(op, (noisy,), (u,))
            # per-sample sigma_max estimate ||J u|| with ||u|| = 1
            sig_max = torch.sqrt(torch.clamp(torch.sum(ju * ju, dim=(1, 2, 3)), min=1e-20))
            loss = loss + spectral_penalty * torch.mean(torch.relu(sig_max - spectral_target) ** 2)
        return loss

    return TrainTask("fastdvd", model, loss_fn)


def fastdvd_distill_task(model: nn.Module, teacher: Callable[[Tensor, Tensor], Tensor],
                         jac_weight: float = 0.0) -> TrainTask:
    """Operator distillation on probe points: the batch is ``(clips (N, 5, H,
    W, 3), sigmas (N,), needs_noise (N,))``; clips with ``needs_noise`` 1 get
    fresh noise at ``sigma * fraction``, the others are used as they are; the
    target is always the teacher's output on the centre frame. ``jac_weight``
    adds ``mean ||J_student(x) u - J_teacher(centre) u_centre||^2`` along a
    random unit direction ``u``, both eval-mode operators (the student's with
    the running statistics of the start of the step)."""

    def loss_fn(net: nn.Module, generator: augment.Draws, batch: Any) -> Tensor:
        clips, sigmas, needs_noise = batch
        start = _buffers(net) if jac_weight > 0 else None
        clips = augment.augment_batch(generator, clips)
        n = clips.shape[0]
        frac = _to(draw_fraction(generator, n), clips)
        noise = _to(augment.draw_noise(generator, tuple(clips.shape)), clips) * (
            sigmas * frac)[:, None, None, None, None]
        x = clips + needs_noise[:, None, None, None, None] * noise
        c = x.shape[1] // 2
        with torch.no_grad():
            t_out = teacher(x[:, c], sigmas)
        out = net(x, sigmas)
        loss = torch.mean((out - t_out) ** 2) / 2.0
        if jac_weight > 0:
            u = _unit(_to(draw_probe(generator, tuple(x.shape)), x))
            with _eval_operator(net, start, sigmas) as op:
                _, s_jvp = torch.func.jvp(op, (x,), (u,))
            with torch.no_grad():
                _, t_jvp = torch.func.jvp(lambda centre: teacher(centre, sigmas),
                                          (x[:, c],), (u[:, c],))
            jac = torch.mean(torch.sum((s_jvp - t_jvp) ** 2, dim=(1, 2, 3)))
            loss = loss + jac_weight * jac
        return loss

    return TrainTask("fastdvd_distill", model, loss_fn)


def ddnet_task(model: nn.Module, sigma: float = 1 / 255) -> TrainTask:
    def loss_fn(net: nn.Module, generator: augment.Draws, clips: Tensor) -> Tensor:
        clips = augment.augment_batch(generator, clips)
        n, f, h, w, _ = clips.shape
        noisy = augment.add_gaussian_noise(
            generator, clips, torch.full((n,), sigma, device=clips.device))
        # every frame mosaicked into sparse RGB, the network's input domain
        mosaicked = bayer.embed_rgb(bayer.mosaic(noisy.reshape(n * f, h, w, 3)))
        out = net(mosaicked.reshape(n, f, h, w, 3))
        return torch.mean((out - noisy[:, f // 2]) ** 2)

    return TrainTask("ddnet", model, loss_fn)
