"""Two-stage online-adaptive plug-and-play ADMM
(port of ``adaptivepnp_sci_tpu.solvers.two_stage_admm``).

Stage 1 works on packed Bayer planes (dual ``b``): the diagonalized
x-update, then demosaicking to RGB. Stage 2 works on the RGB cube (dual
``w``, penalty ``tau``): the deep denoiser, then the re-mosaic into the
theta-update. Online adaptation of the denoiser fires on a mask computed on
the host from the static schedule, so the solver is a plain Python loop with
``if mask[k]: adapt``.

Ported: the ``ffdnet``, ``fastdvd`` and ``tv`` denoiser branches; Malvar,
bilinear and DDnet demosaicking (a fixed-weight ``demosaic_fn``, or in-scan
adaptation of the demosaicker through a :class:`DmSpec`); the closed-form
demosaic; ``denoiser_relax``; ``faithful_aliasing``; the ``select_best``
guard, raw and held-out; and ``two_stage_admm`` for one measurement. Options
of the JAX solver outside that subset raise ``NotImplementedError``
(:func:`check_supported`); none is silently ignored.

The held-out pixels of the ``select_best_holdout`` guard are drawn by
:func:`holdout_mask` from a ``torch.Generator``: the JAX package's PRNG stream
is not reproduced, so the two packages hold out different pixels for the
same seed.

Convolutions run in full float32: on entry the solver turns TF32 off for
cuDNN and matmuls and restores the previous settings on exit.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch
import torch.nn as nn
from torch import Tensor

from adaptivepnp_sci_torch.adapt.ddnet_online import dm_adam_steps
from adaptivepnp_sci_torch.adapt.online import (
    AdaptConfig,
    check_adapt_supported,
    make_adapt_fn,
    make_schedule,
)
from adaptivepnp_sci_torch.ops import bayer, cuda_kernels, demosaic, metrics, physics
from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, _gap_tv_packed, as_f32
from adaptivepnp_sci_torch.solvers.priors import (
    Prior,
    ddnet_demosaic_param,
    module_copy,
    working_copy,
)


@dataclass(frozen=True)
class ADMMConfig:
    """Solver configuration; fields mirror the JAX ``ADMMConfig``."""

    sigma: tuple[float, ...]
    iters: tuple[int, ...]
    denoiser: str = "ffdnet"          # 'tv' | 'ffdnet' | 'fastdvd'
    demosaic_method: str = "malvar"   # 'malvar' | 'bilinear' | 'ddnet'
    closed_form_demosaic: bool = False
    tv_weight: float = 0.1
    tv_iters: int = 5
    adapt: AdaptConfig | None = None
    #: relaxed denoiser step ``xhat = (1 - r) x + r D(x)``; a tuple gives one
    #: r per sigma stage
    denoiser_relax: float | tuple[float, ...] = 1.0
    #: return the iterate with the lowest measurement residual, the warm start
    #: included as candidate 0, instead of the last one
    select_best: bool = False
    #: held-out guard: a Bernoulli(f) pixel subset leaves the whole data term,
    #: and iterates are ranked by their prediction error there (0 = raw residual)
    select_best_holdout: float = 0.0
    select_best_seed: int = 0
    #: GAP-TV iterations of the masked warm start that ranks candidate 0
    select_best_warm_iters: int = 40
    #: replay the reference's iteration-1 aliasing: at k = 0 the dual update
    #: sees the pre-clip theta
    faithful_aliasing: bool = False

    @property
    def rho(self) -> float:
        if self.closed_form_demosaic or self.denoiser == "fastdvd":
            return 0.55
        return 1.0

    @property
    def alpha(self) -> float:
        return 0.01 if self.denoiser == "tv" else 1.0

    @property
    def tau(self) -> float:
        return 10.0 if self.closed_form_demosaic else 100.0


class ADMMResult(NamedTuple):
    x_rgb: Tensor            # (B, H, W, 3) final denoised RGB cube
    x_bayer: Tensor          # (B, H, W) final Bayer estimate (from theta)
    psnr_per_frame: Tensor   # (B,)
    ssim_per_frame: Tensor   # (B,)
    psnr_trace: Tensor       # (T,) per-iteration PSNR (zeros without orig)
    variables: Any           # the (possibly adapted) denoiser state dict
    dm_variables: Any = None  # the in-scan-adapted demosaicker state dict
    dm_opt_state: Any = None  # and its Adam state dict
    #: (T + 1,) the select_best ranking statistic of candidate 0 (the warm
    #: start) and of each iterate; the first minimum is the returned one.
    #: None without select_best.
    resid_trace: Tensor | None = None


class DmSpec(NamedTuple):
    """In-scan demosaicker adaptation (the reference's ``dm_update``): every
    solver iteration runs ``update_per_iter`` Adam steps at ``lr`` on the
    self-consistency loss ``MSE(mosaic(demosaic(x)), x) / 3`` of a private
    float32 copy of ``model``, then demosaics with the refined weights.
    ``fresh_opt`` builds a new Adam before every step (the reference's
    semantics); otherwise one Adam state carries through the solve."""

    model: nn.Module
    apply: Callable[[nn.Module, Tensor], Tensor]  # (net, (B,H,W)) -> (B,H,W,3)
    lr: float = 1e-6
    update_per_iter: int = 1
    fresh_opt: bool = False


def make_dm_spec(model: nn.Module, lr: float = 1e-6, update_per_iter: int = 1,
                 window: int = 5, fresh_opt: bool = False) -> DmSpec:
    """The :class:`DmSpec` of a DDnet-style demosaicker ``model``."""
    return DmSpec(model, ddnet_demosaic_param(model, window), lr, update_per_iter, fresh_opt)


class DmState:
    """The solve's private copy of the in-scan demosaicker and its Adam."""

    def __init__(self, spec: DmSpec, params: Mapping[str, Tensor] | None,
                 opt_state: Mapping | None, device: torch.device | str):
        self.spec = spec
        self.net = module_copy(spec.model, params, device)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=spec.lr)
        if opt_state is not None:
            self.opt.load_state_dict(opt_state)

    def demosaic(self, mosaic_frames: Tensor) -> Tensor:
        return self.spec.apply(self.net, mosaic_frames)

    def update(self, mosaic_frames: Tensor) -> None:
        """``update_per_iter`` self-consistency Adam steps on ``mosaic_frames``."""
        def loss() -> Tensor:
            out = self.demosaic(mosaic_frames)
            return torch.mean((bayer.mosaic(out) - mosaic_frames) ** 2) / 3.0

        self.opt, _ = dm_adam_steps(self.net, self.opt, loss, self.spec.lr,
                                    self.spec.update_per_iter, self.spec.fresh_opt)


def check_supported(config: ADMMConfig, prior: Prior | None = None,
                    demosaic_fn: Callable | None = None, dm_spec: DmSpec | None = None) -> None:
    """Raise ``NotImplementedError`` for an option outside the ported subset,
    then ``ValueError`` for a combination that makes no sense."""
    if config.denoiser not in ("ffdnet", "fastdvd", "tv"):
        raise NotImplementedError(f"denoiser={config.denoiser!r} is not ported yet")
    if config.demosaic_method not in ("malvar", "bilinear", "ddnet"):
        raise NotImplementedError(
            f"demosaic_method={config.demosaic_method!r} is not ported yet")
    if config.adapt is not None and prior is not None:
        check_adapt_supported(prior, config.adapt)
    if config.denoiser != "tv" and prior is None:
        raise ValueError(f"denoiser={config.denoiser!r} requires a prior")
    if dm_spec is not None and config.closed_form_demosaic:
        raise ValueError("in-scan dm adaptation requires a demosaic call "
                         "every iteration (closed_form_demosaic=False)")
    if dm_spec is not None and config.denoiser == "tv":
        raise ValueError("in-scan dm adaptation needs the two-stage deep "
                         "path, not the TV solver")
    if (config.demosaic_method == "ddnet" and config.denoiser != "tv"
            and demosaic_fn is None and dm_spec is None):
        raise ValueError("demosaic_method='ddnet' needs a demosaic_fn "
                         "(ddnet_demosaic) or a dm_spec (make_dm_spec)")
    relax_schedule(config)


def relax_schedule(config: ADMMConfig) -> np.ndarray | None:
    """Per-iteration ``denoiser_relax`` (float32), None when every r is 1."""
    relax = config.denoiser_relax
    if isinstance(relax, tuple):
        if len(relax) != len(config.sigma):
            raise ValueError(f"denoiser_relax stages ({len(relax)}) must match sigma "
                             f"stages ({len(config.sigma)})")
        if all(r == 1.0 for r in relax):
            return None
        return np.concatenate([np.full(n, r, np.float32) for r, n in zip(relax, config.iters)])
    if relax == 1.0:
        return None
    return np.full(sum(config.iters), float(relax), np.float32)


def holdout_mask(seed: int, frac: float, shape: tuple[int, ...],
                 device: torch.device | str) -> Tensor:
    """The held-out pixels of the ``select_best_holdout`` guard: a float32
    mask of ``shape`` whose pixels are 1 with probability ``frac``, drawn from
    a CPU ``torch.Generator`` seeded with ``seed`` (the same mask on any
    device)."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g) < frac).to(device=device, dtype=torch.float32)


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls; restore the
    previous settings on exit."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def run_admm(config: ADMMConfig, prior: Prior | None, net: nn.Module | None,
             y_full: Tensor, phi_full: Tensor, x0: Tensor, orig: Tensor | None,
             generator: torch.Generator | None = None, demosaic_fn: Callable | None = None,
             dm: DmState | None = None) -> tuple[Tensor, Tensor, Tensor, Tensor | None]:
    """The whole sigma schedule from the packed warm start ``x0``; adapts
    ``net`` in place when the schedule fires, drawing the adaptation noise
    from ``generator`` (None: one seeded with 0 on the run's device).
    ``demosaic_fn`` (e.g. :func:`~adaptivepnp_sci_torch.solvers.priors.ddnet_demosaic`)
    replaces ``config.demosaic_method``'s demosaicker; ``dm`` adapts and runs
    the demosaicker in the loop. Returns ``(theta, xhat, trace, resid_trace)``:
    the packed final (or, with ``select_best``, chosen) theta, its RGB cube
    (zeros for 'tv'), the per-iteration PSNR of theta against ``orig`` (zeros
    without it) and the ``select_best`` ranking statistics (None without)."""
    sigmas_np, mask = make_schedule(config.sigma, config.iters, config.adapt)
    total = int(sigmas_np.shape[0])
    relax_np = relax_schedule(config)
    rho, alpha, tau = config.rho, config.alpha, config.tau
    dev = x0.device

    hold_p = None
    if config.select_best and config.select_best_holdout > 0:
        # held-out CV guard: the pixel subset leaves the whole data term (the
        # x-update and the adaptation loss), and iterates are ranked by their
        # prediction error of the true measurement there
        hold = holdout_mask(config.select_best_seed, config.select_best_holdout,
                            tuple(y_full.shape), dev)
        y_true_p, phi_true_p = bayer.pack(y_full), bayer.pack(phi_full)
        hold_p = bayer.pack(hold)
        hold_n = torch.clamp(hold_p.sum(), min=1.0)
        y_full = y_full * (1.0 - hold)
        phi_full = phi_full * (1.0 - hold)[None]
    y_p = bayer.pack(y_full)      # (4, H2, W2)
    phi_p = bayer.pack(phi_full)  # (B, 4, H2, W2)
    phi_s = physics.phi_sum(phi_p)
    n_frames, h, w = phi_full.shape
    trace: list[Tensor] = []
    resids: list[Tensor] = []
    best: list[Tensor | None] = []

    def trace_psnr(theta: Tensor) -> None:
        if orig is not None:
            trace.append(metrics.psnr(orig, bayer.unpack(theta)))

    def resid(theta: Tensor) -> Tensor:
        if hold_p is None:
            return torch.mean((physics.forward(theta, phi_p) - y_p) ** 2)
        err = (physics.forward(theta, phi_true_p) - y_true_p) ** 2
        return torch.sum(err * hold_p) / hold_n

    def cand0_resid(x0: Tensor) -> Tensor:
        # under the held-out guard the passed warm start was fit to the full
        # measurement, so candidate 0 is ranked by a GAP-TV warm start
        # recomputed from the masked data; a pin still returns x0 itself
        if hold_p is None:
            return resid(x0)
        x_ref, _ = _gap_tv_packed(y_p, phi_p, physics.adjoint(y_p, phi_p), None,
                                  GapTVConfig(iters=config.select_best_warm_iters))
        return resid(x_ref)

    def consider(r: Tensor, theta: Tensor, xhat: Tensor | None = None) -> None:
        # strict r < best: the earliest of equal candidates stays; on the
        # device, without a host sync
        resids.append(r)
        if not best:
            best[:] = [r, theta, xhat]
            return
        take = r < best[0]
        best[:] = [torch.where(take, r, best[0]), torch.where(take, theta, best[1]),
                   None if xhat is None else torch.where(take, xhat, best[2])]

    def finish() -> tuple[Tensor, Tensor | None]:
        if orig is None:
            tr = torch.zeros(total, dtype=torch.float32, device=dev)
        else:
            tr = torch.stack(trace)
        return tr, torch.stack(resids) if resids else None

    x, theta, b = x0, x0, torch.zeros_like(x0)
    if config.denoiser == "tv":
        if config.select_best:
            consider(cand0_resid(x0), x0)
        for _ in range(total):
            x = cuda_kernels.admm_x_update(theta, b, y_p, phi_p, phi_s, rho, alpha)
            xb = x + b / rho
            theta = cuda_kernels.tv_chambolle_fused(xb, weight=config.tv_weight,
                                                    max_iter=config.tv_iters)
            theta = torch.clamp(theta, 0.0, 1.0)
            b = b + (x - theta)
            if config.select_best:
                consider(resid(theta), theta)
            trace_psnr(theta)
        if config.select_best:
            theta = best[1]
        zero_rgb = torch.zeros((n_frames, h, w, 3), dtype=torch.float32, device=dev)
        return theta, zero_rgb, *finish()

    if dm is not None:
        dm_fn = dm.demosaic
    elif demosaic_fn is not None:
        dm_fn = demosaic_fn
    elif config.demosaic_method == "bilinear":
        dm_fn = demosaic.bilinear
    else:
        dm_fn = demosaic.malvar2004
    cfa = bayer.mask_like(x0, (h, w))
    adapt = make_adapt_fn(prior, config.adapt) if config.adapt is not None else None
    if adapt is not None and prior.adapt_noise_std > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    sigmas = torch.as_tensor(sigmas_np, device=dev)  # one copy; sigmas[k] is a view
    relax = torch.as_tensor(relax_np, device=dev) if relax_np is not None else None
    w_dual = torch.zeros((n_frames, h, w, 3), dtype=torch.float32, device=dev)
    xhat = w_dual
    if config.select_best:
        # candidate 0: the warm start and its RGB view through the initial
        # demosaicker
        consider(cand0_resid(x0), x0, dm_fn(bayer.unpack(x0)))
    for k in range(total):
        sigma = sigmas[k]
        x = cuda_kernels.admm_x_update(theta, b, y_p, phi_p, phi_s, rho, alpha)
        xb_full = bayer.unpack(x + b / rho)
        if dm is not None:
            dm.update(xb_full)
            x_rgb = dm.demosaic(xb_full)
        elif config.closed_form_demosaic and k > 0:
            num = (rho * bayer.embed_rgb(bayer.unpack(x)) + bayer.embed_rgb(bayer.unpack(b))
                   + tau * xhat + w_dual)
            x_rgb = num / (rho * cfa + tau)
            if config.denoiser == "ffdnet":
                x_rgb = torch.clamp(x_rgb, 0.0, 1.0)
        else:
            x_rgb = dm_fn(xb_full)
        x_rgb_w = x_rgb - w_dual / tau
        if adapt is not None and mask[k]:
            adapt(net, x_rgb_w, sigma, y_p, phi_p, y_full, phi_full, generator)
        xhat = prior.apply(net, x_rgb_w, sigma)
        if relax is not None:
            xhat = x_rgb_w + relax[k] * (xhat - x_rgb_w)
        theta_pre = bayer.rggb_subsample(xhat)
        theta = torch.clamp(theta_pre, 0.0, 1.0)
        # faithful aliasing: at k = 0 the dual sees the pre-clip theta
        x_for_dual = theta_pre if config.faithful_aliasing and k == 0 else x
        b = b + (x_for_dual - theta)
        w_dual = w_dual + (x_rgb - xhat)
        if config.select_best:
            consider(resid(theta), theta, xhat)
        trace_psnr(theta)
    if config.select_best:
        _, theta, xhat = best
    return theta, xhat, *finish()


def frame_metrics(orig: Tensor | None, x_bayer: Tensor) -> tuple[Tensor, Tensor]:
    if orig is None:
        z = torch.zeros(x_bayer.shape[0], dtype=torch.float32, device=x_bayer.device)
        return z, z
    return metrics.psnr_per_frame(orig, x_bayer), metrics.ssim_per_frame(orig, x_bayer)


def two_stage_admm(
    y_bayer: np.ndarray | Tensor,
    phi_bayer: np.ndarray | Tensor,
    config: ADMMConfig,
    prior: Prior | None = None,
    params: Mapping[str, Tensor] | None = None,
    x0_bayer: np.ndarray | Tensor | None = None,
    orig_bayer: np.ndarray | Tensor | None = None,
    device: torch.device | str = "cuda",
    generator: torch.Generator | None = None,
    demosaic_fn: Callable[[Tensor], Tensor] | None = None,
    dm_spec: DmSpec | None = None,
    dm_variables: Mapping[str, Tensor] | None = None,
    dm_opt_state: Mapping | None = None,
) -> ADMMResult:
    """Reconstruct one measurement.

    Args:
      y_bayer:    snapshot ``(H, W)``.
      phi_bayer:  masks ``(B, H, W)``.
      config:     solver schedule and penalties.
      prior:      deep denoiser plugin (None for 'tv').
      params:     denoiser state dict; never modified. The adapted weights
        come back in ``ADMMResult.variables``.
      x0_bayer:   warm start ``(B, H, W)`` (e.g. GAP-TV output).
      orig_bayer: optional ground truth for metrics.
      device:     where to run; the kernels run on CUDA.
      generator:  source of the adaptation input noise (FastDVDnet); None
        seeds one with 0.
      demosaic_fn: fixed-weight deep demosaicker ``(B,H,W) -> (B,H,W,3)``
        (:func:`~adaptivepnp_sci_torch.solvers.priors.ddnet_demosaic`).
      dm_spec/dm_variables/dm_opt_state: in-scan demosaicker adaptation
        (:func:`make_dm_spec`), from the demosaicker state dict
        ``dm_variables`` (None: the template's weights) and an Adam state
        dict; never modified. The refined ones come back in
        ``ADMMResult.dm_variables`` and ``.dm_opt_state``.
    """
    check_supported(config, prior, demosaic_fn, dm_spec)
    y = as_f32(y_bayer, device)
    phi = as_f32(phi_bayer, device)
    if y.dim() != 2 or phi.dim() != 3 or tuple(phi.shape[1:]) != tuple(y.shape):
        raise ValueError(
            f"expected y (H, W) and phi (B, H, W) with matching spatial dims; "
            f"got y {tuple(y.shape)}, phi {tuple(phi.shape)}"
        )
    if y.shape[0] % 2 or y.shape[1] % 2:
        raise ValueError(f"Bayer dims must be even, got {tuple(y.shape)}")

    if x0_bayer is None:
        x0 = physics.adjoint(bayer.pack(y), bayer.pack(phi))
    else:
        x0 = bayer.pack(as_f32(x0_bayer, device))
    orig = as_f32(orig_bayer, device) if orig_bayer is not None else None

    with full_f32(), torch.no_grad():
        net = working_copy(prior, params, device) if config.denoiser != "tv" else None
        dm = DmState(dm_spec, dm_variables, dm_opt_state, device) if dm_spec else None
        theta, xhat, trace, resids = run_admm(config, prior, net, y, phi, x0, orig,
                                              generator, demosaic_fn, dm)
        x_bayer = bayer.unpack(theta)
        p, s = frame_metrics(orig, x_bayer)
    variables = net.state_dict() if net is not None else params
    if dm is None:
        return ADMMResult(xhat, x_bayer, p, s, trace, variables, resid_trace=resids)
    return ADMMResult(xhat, x_bayer, p, s, trace, variables, dm.net.state_dict(),
                      dm.opt.state_dict(), resids)
