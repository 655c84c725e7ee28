"""Two-stage online-adaptive plug-and-play ADMM
(port of ``adaptivepnp_sci_tpu.solvers.two_stage_admm``).

Stage 1 works on packed Bayer planes (dual ``b``): the diagonalized
x-update, then demosaicking to RGB. Stage 2 works on the RGB cube (dual
``w``, penalty ``tau``): the deep denoiser, then the re-mosaic into the
theta-update. Online adaptation of the denoiser fires on a mask computed on
the host from the static schedule, so the solver is a plain Python loop with
``if mask[k]: adapt``.

Ported: the ``ffdnet``, ``fastdvd`` and ``tv`` denoiser branches; Malvar,
bilinear, Menon 2007 and DDnet demosaicking (a fixed-weight ``demosaic_fn``,
or in-scan adaptation of the demosaicker through a :class:`DmSpec`); the
closed-form demosaic; ``denoiser_relax``; ``faithful_aliasing``; the
``select_best`` guard, raw and held-out; a carried Adam state
(``AdaptConfig.fresh_opt_per_trigger=False``); ``two_stage_admm`` for one
measurement and the three multi-measurement drivers:
:func:`two_stage_admm_sequence` (the weights and Adam states carried from
measurement to measurement), :func:`two_stage_admm_batched` (independent
measurements) and :func:`two_stage_admm_tiled` (one oversized measurement cut
into tiles that share one adaptation). Options of the JAX solver outside that
subset raise ``NotImplementedError`` (:func:`check_supported`); none is
silently ignored. The tiled and batched drivers take a ``mesh``
(:mod:`adaptivepnp_sci_torch.parallel`): their tiles or measurements spread
over the ranks of its ``data`` axis. :func:`two_stage_admm` takes one too: the
measurement's frames spread over the ranks of its ``frame`` axis
(:class:`~adaptivepnp_sci_torch.adapt.online.FrameShard`), each rank holding
its frames of the packed state, the frame sums of the x-update, the
guard's residuals and the adaptation loss taken over every rank's frames,
and the result gathered back on every rank.

Several measurements run in lockstep along a leading item axis
(:func:`run_admm`): the x-update kernel takes all items in one launch, the
TV kernel all their planes, and the priors and demosaickers run item by item.

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
import torch.nn.functional as F
from torch import Tensor

from adaptivepnp_sci_torch.adapt.ddnet_online import dm_adam_steps, frames_mse
from adaptivepnp_sci_torch.adapt.online import (
    AdaptConfig,
    FrameShard,
    ItemShard,
    carried_adam,
    check_adapt_supported,
    draws_randoms,
    make_adapt_fn,
    make_schedule,
    trigger_draws,
)
from adaptivepnp_sci_torch.ops import bayer, cuda_kernels, demosaic, metrics, physics
from adaptivepnp_sci_torch.ops.menon2007 import menon2007
from adaptivepnp_sci_torch.ops.patches import crop_overlapping, crop_patches, stitch_patches
from adaptivepnp_sci_torch.parallel.mesh import Mesh, all_reduce_tensors, gather
from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, _gap_tv_packed, as_f32
from adaptivepnp_sci_torch.solvers.priors import (
    Prior,
    ddnet_demosaic_param,
    module_copy,
    working_copy,
)
from adaptivepnp_sci_torch.utils.profiling import annotate


@dataclass(frozen=True)
class ADMMConfig:
    """Solver configuration; fields mirror the JAX ``ADMMConfig``."""

    sigma: tuple[float, ...]
    iters: tuple[int, ...]
    denoiser: str = "ffdnet"          # 'tv' | 'ffdnet' | 'fastdvd'
    demosaic_method: str = "malvar"   # 'malvar' | 'bilinear' | 'menon2007' | 'ddnet'
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
    #: the x-update kernel, the TV denoiser's kernel and the guard's masked
    #: GAP-TV (JAX's ``use_pallas``): None by the tensors' device, False the
    #: plain versions on any device, True the kernels (a ValueError on CPU
    #: tensors); see ``cuda_kernels.runs_kernel``
    use_kernels: bool | None = None

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
    #: the carried denoiser Adam's state dict (``fresh_opt_per_trigger=False``),
    #: to continue adaptation on the next measurement; None otherwise
    opt_state: Any = None
    dm_variables: Any = None  # the in-scan-adapted demosaicker state dict
    dm_opt_state: Any = None  # and its Adam state dict
    #: (T + 1,) the select_best ranking statistic of candidate 0 (the warm
    #: start) and of each iterate; the first minimum is the returned one.
    #: None without select_best. The drivers stack it: (T_meas, T + 1) for a
    #: sequence or a batch, (groups, T + 1) for tiles. The fields before it
    #: are the JAX ``ADMMResult``'s, in its order.
    resid_trace: Tensor | None = None


class DmSpec(NamedTuple):
    """In-scan demosaicker adaptation (the reference's ``dm_update``): every
    solver iteration runs ``update_per_iter`` Adam steps at ``lr`` on the
    self-consistency loss ``MSE(mosaic(demosaic(x)), x) / 3`` of a private
    float32 copy of ``model``, then demosaics with the refined weights.
    ``fresh_opt`` builds a new Adam before every step (the reference's
    semantics); otherwise one Adam state carries through the solve.
    ``frame_sharded(mesh)``: ``apply``'s form on a rank's frames of a cube
    spread over ``mesh``'s ``frame`` axis (None: a frame-sharded solve
    refuses the spec)."""

    model: nn.Module
    apply: Callable[[nn.Module, Tensor], Tensor]  # (net, (B,H,W)) -> (B,H,W,3)
    lr: float = 1e-6
    update_per_iter: int = 1
    fresh_opt: bool = False
    frame_sharded: Callable[[Mesh], Callable[[nn.Module, Tensor], Tensor]] | None = None


def make_dm_spec(model: nn.Module, lr: float = 1e-6, update_per_iter: int = 1,
                 window: int = 5, fresh_opt: bool = False) -> DmSpec:
    """The :class:`DmSpec` of a DDnet-style demosaicker ``model``."""
    return DmSpec(model, ddnet_demosaic_param(model, window), lr, update_per_iter, fresh_opt,
                  lambda mesh: ddnet_demosaic_param(model, window, mesh))


class DmState:
    """The solve's private copy of the in-scan demosaicker and its Adam."""

    def __init__(self, spec: DmSpec, params: Mapping[str, Tensor] | None,
                 opt_state: Mapping | None, device: torch.device | str,
                 frames: FrameShard | None = None):
        self.spec = spec
        self.frames = frames
        self.net = module_copy(spec.model, params, device)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=spec.lr)
        if opt_state is not None:
            self.opt.load_state_dict(opt_state)

    def demosaic(self, mosaic_frames: Tensor) -> Tensor:
        return self.spec.apply(self.net, mosaic_frames)

    @annotate("apnp.dm_adapt")
    def update(self, mosaic_frames: Tensor, shard: ItemShard | None = None) -> None:
        """``update_per_iter`` self-consistency Adam steps on ``mosaic_frames``
        ``(N, B, H, W)``: one update shared by the ``N`` measurements, on the
        mean of their losses (over the whole group of a ``shard``, and over
        every rank's frames with the state's ``frames``). The update is the
        span ``apnp.dm_adapt``."""
        def loss(frames: Tensor) -> Callable[[], Tensor]:
            def fn() -> Tensor:
                out = self.demosaic(frames)
                return frames_mse(bayer.mosaic(out) - frames, self.frames) / 3.0
            return fn

        self.opt, _ = dm_adam_steps(self.net, self.opt, [loss(f) for f in mosaic_frames],
                                    self.spec.lr, self.spec.update_per_iter,
                                    self.spec.fresh_opt, shard, self.frames)


def check_supported(config: ADMMConfig, prior: Prior | None = None,
                    demosaic_fn: Callable | None = None, dm_spec: DmSpec | None = None) -> None:
    """Raise ``NotImplementedError`` for an option outside the ported subset,
    then ``ValueError`` for a combination that makes no sense."""
    if config.denoiser not in ("ffdnet", "fastdvd", "tv"):
        raise NotImplementedError(f"denoiser={config.denoiser!r} is not ported yet")
    if config.demosaic_method not in ("malvar", "bilinear", "menon2007", "ddnet"):
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


def on_frames(frames: FrameShard | None, prior: Prior | None, demosaic_fn: Callable | None,
              dm_spec: DmSpec | None) -> tuple[Prior | None, Callable | None, DmSpec | None]:
    """The prior, fixed demosaicker and in-scan demosaicker spec in their
    forms for this rank's ``frames`` (their ``frame_sharded``); as they are
    without ``frames``. ``NotImplementedError`` for one that has no such
    form: given the rank's frames, a model whose windows span frames would
    be wrong without a word."""
    if frames is None:
        return prior, demosaic_fn, dm_spec

    def form(obj: Any, what: str) -> Any:
        make = getattr(obj, "frame_sharded", None)
        if make is None:
            raise NotImplementedError(
                f"{what} has no form for a solve whose frames are spread over the mesh's "
                f"'frame' axis ({frames.mesh.axis_size('frame')} ranks)")
        return make(frames.mesh)

    if prior is not None:
        prior = form(prior, f"the {prior.name!r} prior")
    if demosaic_fn is not None:
        demosaic_fn = form(demosaic_fn, "demosaic_fn")
    if dm_spec is not None:
        dm_spec = dm_spec._replace(apply=form(dm_spec, "dm_spec"), frame_sharded=None)
    return prior, demosaic_fn, dm_spec


def _per_item(fn: Callable[[Tensor], Tensor], x: Tensor) -> Tensor:
    """``fn`` on each item of ``x``'s leading axis, stacked: priors and
    demosaickers see one measurement's frames at a time, so no window of
    frames ever spans two items."""
    return torch.stack([fn(x[i]) for i in range(x.shape[0])])


def run_admm(config: ADMMConfig, prior: Prior | None, net: nn.Module | None,
             y_full: Tensor, phi_full: Tensor, x0: Tensor, orig: Tensor | None,
             generator: torch.Generator | None = None, demosaic_fn: Callable | None = None,
             dm: DmState | None = None, opt: torch.optim.Adam | None = None,
             pooled: bool = True, shard: ItemShard | None = None,
             frames: FrameShard | None = None
             ) -> tuple[Tensor, Tensor, Tensor, Tensor | None]:
    """The whole sigma schedule for ``N`` measurements in lockstep, from the
    packed warm starts ``x0 (N, B, 4, h, w)``, with ``y_full (N, H, W)``,
    ``phi_full`` one ``(B, H, W)`` shared by all items or ``(N, B, H, W)``,
    and ``orig (N, B, H, W)`` or None. Adapts ``net`` in place when the
    schedule fires, drawing the adaptation noise from ``generator`` (None: a
    CPU generator seeded with 0, the same draws on any device) and stepping
    ``opt`` when the schedule carries one Adam
    (:func:`~adaptivepnp_sci_torch.adapt.online.carried_adam`).
    ``demosaic_fn`` (e.g. :func:`~adaptivepnp_sci_torch.solvers.priors.ddnet_demosaic`)
    replaces ``config.demosaic_method``'s demosaicker; ``dm`` adapts and runs
    the demosaicker in the loop.

    ``pooled`` (the tiles of one scene): the items share one adaptation (the
    mean of their losses) and one ``select_best`` pick (the mean of their
    residuals). Otherwise (a batch) each item picks its own iterate, and
    adaptation is refused for more than one item. ``shard``: the pooled
    items are this rank's share of a group spread over ranks; the
    adaptations' draws and gradients and the pick's mean residual then span
    the whole group, so every rank takes the same iterate. ``frames``:
    ``phi_full``, ``x0`` and ``orig`` hold this rank's frames (``prior``,
    ``demosaic_fn`` and ``dm`` their :func:`on_frames` forms); every frame
    sum (the x-update's, the residuals', the adaptation loss's, the PSNR's)
    runs over all ranks' frames, so every rank takes the same iterate, and
    theta and its RGB cube come back as the rank's frames.

    Returns ``(theta, xhat, trace, resid_trace)``: the packed final (or, with
    ``select_best``, chosen) theta ``(N, B, 4, h, w)``, its RGB cube (zeros
    for 'tv'), the per-iteration PSNR of each item's theta against ``orig``
    ``(N, T)`` (zeros without it) and the ``select_best`` ranking statistics,
    ``(T + 1,)`` pooled or ``(N, T + 1)`` (None without the guard)."""
    sigmas_np, mask = make_schedule(config.sigma, config.iters, config.adapt)
    total = int(sigmas_np.shape[0])
    relax_np = relax_schedule(config)
    rho, alpha, tau = config.rho, config.alpha, config.tau
    dev = x0.device
    n_items = x0.shape[0]
    adapting = (config.adapt is not None and config.denoiser != "tv") or dm is not None
    if not pooled and n_items > 1 and adapting:
        raise ValueError("independent items cannot share one adaptation: run them one by one")
    fa = physics.PACKED_FRAME_AXIS

    hold_p = None
    if config.select_best and config.select_best_holdout > 0:
        # held-out CV guard: the pixel subset leaves the whole data term (the
        # x-update and the adaptation loss), and iterates are ranked by their
        # prediction error of the true measurement there; one mask per item
        # shape, the same for every item
        hold = holdout_mask(config.select_best_seed, config.select_best_holdout,
                            tuple(y_full.shape[-2:]), dev)
        y_true_p, phi_true_p = bayer.pack(y_full), bayer.pack(phi_full)
        hold_p = bayer.pack(hold)
        hold_n = torch.clamp(hold_p.sum(), min=1.0)
        y_full = y_full * (1.0 - hold)
        phi_full = phi_full * (1.0 - hold)[None]
    y_p = bayer.pack(y_full)      # (N, 4, h, w)
    phi_p = bayer.pack(phi_full)  # (B, 4, h, w) or (N, B, 4, h, w)
    phi_s = physics.phi_sum(phi_p, fa, None if frames is None else frames.gather)
    fwd = physics.forward if frames is None else frames.forward
    psnr = metrics.psnr if frames is None else frames.psnr
    per_phi = phi_full.dim() == 4
    n_frames, h, w = phi_full.shape[-3:]
    trace: list[Tensor] = []
    resids: list[Tensor] = []
    best: list[Tensor | None] = []

    def item_phi(phi: Tensor, i: int) -> Tensor:
        return phi[i] if per_phi else phi

    def trace_psnr(theta: Tensor) -> None:
        if orig is not None:
            trace.append(torch.stack([psnr(orig[i], bayer.unpack(theta[i]))
                                      for i in range(n_items)]))

    def resid(theta: Tensor) -> Tensor:
        if hold_p is None:
            rs = [torch.mean((fwd(theta[i], item_phi(phi_p, i)) - y_p[i]) ** 2)
                  for i in range(n_items)]
        else:
            rs = [torch.sum((fwd(theta[i], item_phi(phi_true_p, i))
                             - y_true_p[i]) ** 2 * hold_p) / hold_n for i in range(n_items)]
        if not pooled:
            return torch.stack(rs)
        if shard is not None:
            total = torch.stack(rs).sum()
            shard.all_reduce([total])
            return total / shard.total
        return rs[0] if n_items == 1 else torch.stack(rs).mean()

    def cand0_resid(x0: Tensor) -> Tensor:
        # under the held-out guard the passed warm start was fit to the full
        # measurement, so candidate 0 is ranked by a GAP-TV warm start
        # recomputed from the masked data; a pin still returns x0 itself
        if hold_p is None:
            return resid(x0)
        x_ref, _ = _gap_tv_packed(y_p, phi_p, physics.adjoint(y_p, phi_p, fa), None,
                                  GapTVConfig(iters=config.select_best_warm_iters,
                                              use_kernels=config.use_kernels), frames)
        return resid(x_ref)

    def consider(r: Tensor, theta: Tensor, xhat: Tensor | None = None) -> None:
        # strict r < best: the earliest of equal candidates stays; on the
        # device, without a host sync
        resids.append(r)
        if not best:
            best[:] = [r, theta, xhat]
            return
        take = r < best[0]

        def pick(new: Tensor, old: Tensor) -> Tensor:
            # one pick for all items, or one per item
            t = take if pooled else take.view(-1, *([1] * (new.dim() - 1)))
            return torch.where(t, new, old)

        best[:] = [pick(r, best[0]), pick(theta, best[1]),
                   None if xhat is None else pick(xhat, best[2])]

    def finish() -> tuple[Tensor, Tensor | None]:
        if orig is None:
            tr = torch.zeros((n_items, total), dtype=torch.float32, device=dev)
        else:
            tr = torch.stack(trace, dim=1)
        if not resids:
            return tr, None
        return tr, torch.stack(resids, dim=-1)

    x, theta, b = x0, x0, torch.zeros_like(x0)
    if config.denoiser == "tv":
        if config.select_best:
            consider(cand0_resid(x0), x0)
        for _ in range(total):
            with annotate("apnp.admm.iter"):
                x = cuda_kernels.admm_x_update(theta, b, y_p, phi_p, phi_s, rho, alpha, frames,
                                               config.use_kernels)
                xb = x + b / rho
                theta = cuda_kernels.tv_chambolle_fused(xb, weight=config.tv_weight,
                                                        max_iter=config.tv_iters,
                                                        use_kernels=config.use_kernels)
                theta = torch.clamp(theta, 0.0, 1.0)
                b = b + (x - theta)
                if config.select_best:
                    consider(resid(theta), theta)
                trace_psnr(theta)
        if config.select_best:
            theta = best[1]
        zero_rgb = torch.zeros((n_items, n_frames, h, w, 3), dtype=torch.float32, device=dev)
        return theta, zero_rgb, *finish()

    if dm is not None:
        dm_fn = dm.demosaic
    elif demosaic_fn is not None:
        dm_fn = demosaic_fn
    elif config.demosaic_method == "bilinear":
        dm_fn = demosaic.bilinear
    elif config.demosaic_method == "menon2007":
        dm_fn = menon2007
    else:
        dm_fn = demosaic.malvar2004
    cfa = bayer.mask_like(x0, (h, w))
    adapt = make_adapt_fn(prior, config.adapt) if config.adapt is not None else None
    if adapt is not None and draws_randoms(prior, config.adapt) and generator is None:
        generator = torch.Generator().manual_seed(0)
    sigmas = torch.as_tensor(sigmas_np, device=dev)  # one copy; sigmas[k] is a view
    relax = torch.as_tensor(relax_np, device=dev) if relax_np is not None else None
    w_dual = torch.zeros((n_items, n_frames, h, w, 3), dtype=torch.float32, device=dev)
    xhat = w_dual
    if config.select_best:
        # candidate 0: the warm start and its RGB view through the initial
        # demosaicker
        consider(cand0_resid(x0), x0, _per_item(dm_fn, bayer.unpack(x0)))
    for k in range(total):
        with annotate("apnp.admm.iter"):
            sigma = sigmas[k]
            x = cuda_kernels.admm_x_update(theta, b, y_p, phi_p, phi_s, rho, alpha, frames,
                                           config.use_kernels)
            xb_full = bayer.unpack(x + b / rho)  # (N, B, H, W)
            with annotate("apnp.demosaic"):
                if dm is not None:
                    dm.update(xb_full, shard)
                    x_rgb = _per_item(dm.demosaic, xb_full)
                elif config.closed_form_demosaic and k > 0:
                    num = (rho * bayer.embed_rgb(bayer.unpack(x))
                           + bayer.embed_rgb(bayer.unpack(b)) + tau * xhat + w_dual)
                    x_rgb = num / (rho * cfa + tau)
                    if config.denoiser == "ffdnet":
                        x_rgb = torch.clamp(x_rgb, 0.0, 1.0)
                else:
                    x_rgb = _per_item(dm_fn, xb_full)
            x_rgb_w = x_rgb - w_dual / tau
            if adapt is not None and mask[k]:
                adapt(net, x_rgb_w, sigma, y_p, phi_p, y_full, phi_full, generator, opt, shard,
                      frames)
            with annotate("apnp.prior"):
                xhat = _per_item(lambda rgb: prior.apply(net, rgb, sigma), x_rgb_w)
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


def check_inputs(y: Tensor, phi: Tensor) -> None:
    if y.dim() != 2 or phi.dim() != 3 or tuple(phi.shape[1:]) != tuple(y.shape):
        raise ValueError(
            f"expected y (H, W) and phi (B, H, W) with matching spatial dims; "
            f"got y {tuple(y.shape)}, phi {tuple(phi.shape)}"
        )
    if y.shape[0] % 2 or y.shape[1] % 2:
        raise ValueError(f"Bayer dims must be even, got {tuple(y.shape)}")


class SolveState:
    """The private state of one solve, or of a sequence of solves that carry
    it: the denoiser's working copy and its carried Adam, the in-scan
    demosaicker, and the adaptation noise generator (None: a CPU generator
    seeded with 0, so a solve draws the same on any device)."""

    def __init__(self, config: ADMMConfig, prior: Prior | None,
                 params: Mapping[str, Tensor] | None, device: torch.device | str,
                 opt_state: Mapping | None = None, dm_spec: DmSpec | None = None,
                 dm_variables: Mapping[str, Tensor] | None = None,
                 dm_opt_state: Mapping | None = None,
                 generator: torch.Generator | None = None, frames: FrameShard | None = None):
        self.params = params
        self.net = working_copy(prior, params, device) if config.denoiser != "tv" else None
        adapting = config.adapt is not None and self.net is not None
        self.opt = carried_adam(self.net, config.adapt, opt_state) if adapting else None
        self.dm = (DmState(dm_spec, dm_variables, dm_opt_state, device, frames) if dm_spec
                   else None)
        if generator is None and adapting and draws_randoms(prior, config.adapt):
            generator = torch.Generator().manual_seed(0)
        self.generator = generator

    def states(self) -> tuple[Any, Any, Any, Any]:
        """``(variables, opt_state, dm_variables, dm_opt_state)`` as they stand."""
        variables = self.net.state_dict() if self.net is not None else self.params
        opt_state = self.opt.state_dict() if self.opt is not None else None
        if self.dm is None:
            return variables, opt_state, None, None
        return variables, opt_state, self.dm.net.state_dict(), self.dm.opt.state_dict()


@annotate("apnp.solve")
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
    opt_state: Mapping | None = None,
    mesh: Mesh | None = None,
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
        seeds a CPU generator with 0 (the same draws on any device).
      demosaic_fn: fixed-weight deep demosaicker ``(B,H,W) -> (B,H,W,3)``
        (:func:`~adaptivepnp_sci_torch.solvers.priors.ddnet_demosaic`).
      dm_spec/dm_variables/dm_opt_state: in-scan demosaicker adaptation
        (:func:`make_dm_spec`), from the demosaicker state dict
        ``dm_variables`` (None: the template's weights) and an Adam state
        dict; never modified. The refined ones come back in
        ``ADMMResult.dm_variables`` and ``.dm_opt_state``.
      opt_state:  the denoiser Adam's state dict to continue from, with
        ``AdaptConfig.fresh_opt_per_trigger=False`` (None: a new Adam); the
        state after this solve comes back in ``ADMMResult.opt_state``.
      mesh:       a ``(data, frame)`` mesh of ranks
        (:mod:`adaptivepnp_sci_torch.parallel`), each given the whole
        inputs: each rank of the ``frame`` axis solves its ``B / frame``
        consecutive frames (:class:`FrameShard`), the prior, demosaicker and
        ``dm_spec`` in their :func:`on_frames` forms, and every rank returns
        the whole result, the same on all of them; the ``data`` axis
        replicates. A mesh with one ``frame`` rank takes the one-process path.
    """
    check_supported(config, prior, demosaic_fn, dm_spec)
    y = as_f32(y_bayer, device)
    phi = as_f32(phi_bayer, device)
    check_inputs(y, phi)
    frames = FrameShard.of(mesh, phi.shape[0])
    prior, demosaic_fn, dm_spec = on_frames(frames, prior, demosaic_fn, dm_spec)

    def mine(t: Tensor) -> Tensor:
        return t if frames is None else frames.local(t)

    if x0_bayer is None:
        x0 = physics.adjoint(bayer.pack(y), bayer.pack(mine(phi)))
    else:
        x0 = bayer.pack(mine(as_f32(x0_bayer, device)))
    orig = as_f32(orig_bayer, device) if orig_bayer is not None else None

    with full_f32(), torch.no_grad():
        st = SolveState(config, prior, params, device, opt_state, dm_spec, dm_variables,
                        dm_opt_state, generator, frames)
        theta, xhat, trace, resids = run_admm(
            config, prior, st.net, y[None], mine(phi), x0[None],
            None if orig is None else mine(orig)[None], st.generator, demosaic_fn, st.dm,
            st.opt, frames=frames)
        if frames is not None:
            theta, xhat = frames.gather(theta, 1), frames.gather(xhat, 1)
        x_bayer = bayer.unpack(theta[0])
        p, s = frame_metrics(orig, x_bayer)
    variables, opt_out, dm_vars, dm_opt = st.states()
    return ADMMResult(xhat[0], x_bayer, p, s, trace[0], variables, opt_out, dm_vars, dm_opt,
                      resids)


def skip_draws(config: ADMMConfig, prior: Prior | None, generator: torch.Generator | None,
               shape: tuple[int, ...]) -> None:
    """Make the adaptation draws of one solve of ``config`` without solving:
    :func:`~adaptivepnp_sci_torch.adapt.online.trigger_draws` once per
    trigger of its schedule, for inputs of ``shape`` (``(1, B, H, W, 3)`` for
    one measurement). The draws depend on the configuration and the shapes
    alone, so a rank that skips the measurements of other ranks leaves
    ``generator`` where one process solving them would."""
    if config.adapt is None or prior is None or config.denoiser == "tv":
        return
    _, mask = make_schedule(config.sigma, config.iters, config.adapt)
    for _ in range(int(mask.sum())):
        trigger_draws(prior, config.adapt, generator, shape)


def gather_states(state: Any, mesh: Mesh, axis: str, device: torch.device | str) -> Any:
    """Every tensor of a state stacked over its leading axis (:func:`stack_states`)
    gathered over ``axis``'s ranks along that axis, through ``device`` (Adam's
    step counts live on the CPU, which NCCL does not take); other leaves as
    they are."""
    if isinstance(state, Tensor):
        return gather(state.to(device), mesh, axis).to(state.device)
    if isinstance(state, Mapping):
        return {k: gather_states(v, mesh, axis, device) for k, v in state.items()}
    if isinstance(state, list):
        return [gather_states(v, mesh, axis, device) for v in state]
    return state


def stack_states(states: list[Any]) -> Any:
    """State dicts (nested dicts of tensors, Adam's included) stacked over a
    new leading axis, tensor by tensor; other leaves are taken from the first."""
    first = states[0]
    if isinstance(first, Tensor):
        return torch.stack(states)
    if isinstance(first, Mapping):
        return {k: stack_states([s[k] for s in states]) for k in first}
    if isinstance(first, list):
        return [stack_states([s[i] for s in states]) for i in range(len(first))]
    return first


def _stack_results(results: list[ADMMResult]) -> tuple[Tensor, ...]:
    """``x_rgb``, ``x_bayer``, PSNR, SSIM, trace and (or None) the ranking
    statistics of each result, stacked over a new leading axis."""
    fields = [torch.stack([getattr(r, f) for r in results])
              for f in ("x_rgb", "x_bayer", "psnr_per_frame", "ssim_per_frame", "psnr_trace")]
    resid = (None if results[0].resid_trace is None
             else torch.stack([r.resid_trace for r in results]))
    return (*fields, resid)


def two_stage_admm_sequence(
    y_seq: np.ndarray | Tensor,
    phi_bayer: np.ndarray | Tensor,
    config: ADMMConfig,
    prior: Prior | None = None,
    params: Mapping[str, Tensor] | None = None,
    x0_seq: np.ndarray | Tensor | None = None,
    orig_seq: np.ndarray | Tensor | None = None,
    dm_spec: DmSpec | None = None,
    dm_variables: Mapping[str, Tensor] | None = None,
    device: torch.device | str = "cuda",
    generator: torch.Generator | None = None,
) -> ADMMResult:
    """Reconstruct ``T`` measurements ``y_seq (T, H, W)`` of one scene under
    one mask ``phi (B, H, W)`` one after another, the reference's
    ``reuse_model`` loop: the adapted denoiser weights and its Adam state (a
    new Adam to start), the in-scan demosaicker and its Adam, and the
    adaptation noise ``generator`` (None: one seeded with 0) carry from
    measurement t to t + 1. Every result field gains a leading ``T`` axis;
    the states returned are those after the last measurement.

    The JAX package draws each measurement's adaptation noise from its own
    split of one PRNG key; the port's one generator gives other numbers."""
    check_supported(config, prior, None, dm_spec)
    y = as_f32(y_seq, device)
    phi = as_f32(phi_bayer, device)
    x0 = None if x0_seq is None else as_f32(x0_seq, device)
    orig = None if orig_seq is None else as_f32(orig_seq, device)
    with full_f32(), torch.no_grad():
        st = SolveState(config, prior, params, device, None, dm_spec, dm_variables, None, generator)
        runs = []
        for t in range(y.shape[0]):
            check_inputs(y[t], phi)
            x0_t = (physics.adjoint(bayer.pack(y[t]), bayer.pack(phi)) if x0 is None
                    else bayer.pack(x0[t]))
            theta, xhat, trace, resids = run_admm(
                config, prior, st.net, y[t][None], phi, x0_t[None],
                None if orig is None else orig[t][None], st.generator, None, st.dm, st.opt)
            x_bayer = bayer.unpack(theta[0])
            p, s = frame_metrics(None if orig is None else orig[t], x_bayer)
            runs.append(ADMMResult(xhat[0], x_bayer, p, s, trace[0], None, resid_trace=resids))
        out = _stack_results(runs)
    variables, opt_state, dm_vars, dm_opt = st.states()
    return ADMMResult(*out[:5], variables, opt_state, dm_vars, dm_opt, out[5])


def two_stage_admm_batched(
    y_batch: np.ndarray | Tensor,
    phi_bayer: np.ndarray | Tensor,
    config: ADMMConfig,
    prior: Prior | None = None,
    params: Mapping[str, Tensor] | None = None,
    x0_batch: np.ndarray | Tensor | None = None,
    orig_batch: np.ndarray | Tensor | None = None,
    demosaic_fn: Callable[[Tensor], Tensor] | None = None,
    opt_state: Mapping | None = None,
    dm_spec: DmSpec | None = None,
    dm_variables: Mapping[str, Tensor] | None = None,
    dm_opt_state: Mapping | None = None,
    device: torch.device | str = "cuda",
    generator: torch.Generator | None = None,
    mesh: Mesh | None = None,
) -> ADMMResult:
    """Reconstruct ``T`` independent measurements ``y_batch (T, H, W)`` of one
    scene under one mask ``phi (B, H, W)``: every result field gains a leading
    ``T`` axis. Each measurement adapts on its own from the same starting
    weights and (dm_)Adam states, which come back stacked over ``T``
    (:func:`stack_states`); no weights pass from one measurement to the next
    (:func:`two_stage_admm_sequence` does that).

    Without adaptation and without ``dm_spec`` the ``T`` measurements run in
    lockstep, one kernel launch per step for all of them, each taking its own
    ``select_best`` pick; with either, one :func:`two_stage_admm` after
    another, the adaptation noise drawn from one ``generator`` in turn (None:
    a CPU generator seeded with 0; the JAX package splits one PRNG key per
    measurement instead).

    ``mesh``: the ``T`` measurements split evenly over the ranks of its
    ``data`` axis, each rank solving its consecutive share (in lockstep, or
    one after another with adaptation or ``dm_spec``, each solve over the
    mesh's ``frame`` axis), and every field and state gathered back on every
    rank (the JAX package places the batch with ``P('data')``). An adapting
    rank makes the draws of the measurements before its share without
    solving them (:func:`skip_draws`), so each measurement draws what it
    draws in one process."""
    check_supported(config, prior, demosaic_fn, dm_spec)
    y = as_f32(y_batch, device)
    phi = as_f32(phi_bayer, device)
    x0 = None if x0_batch is None else as_f32(x0_batch, device)
    orig = None if orig_batch is None else as_f32(orig_batch, device)
    n = y.shape[0]
    for t in range(n):
        check_inputs(y[t], phi)
    adapting = config.adapt is not None and prior is not None
    if adapting or dm_spec is not None:
        if adapting and generator is None and draws_randoms(prior, config.adapt):
            generator = torch.Generator().manual_seed(0)
        mine = range(n) if mesh is None else range(n)[shard_slice(n, mesh, "data")]
        runs = []
        for t in range(n):
            if t not in mine:
                skip_draws(config, prior, generator, (1, *phi.shape, 3))
                continue
            runs.append(two_stage_admm(y[t], phi, config, prior, params,
                                       None if x0 is None else x0[t],
                                       None if orig is None else orig[t], device, generator,
                                       demosaic_fn, dm_spec, dm_variables, dm_opt_state,
                                       opt_state, mesh))
        states = [stack_states([getattr(r, f) for r in runs]) if getattr(runs[0], f) is not None
                  else None for f in ("variables", "opt_state", "dm_variables", "dm_opt_state")]
        out = _stack_results(runs)
        if mesh is not None:
            out = [None if t is None else gather(t, mesh, "data") for t in out]
            states = [gather_states(st, mesh, "data", device) for st in states]
        return ADMMResult(*out[:5], *states, out[5])
    if mesh is not None:
        mine = shard_slice(n, mesh, "data")
        res = two_stage_admm_batched(y[mine], phi, config, prior, params,
                                     None if x0 is None else x0[mine],
                                     None if orig is None else orig[mine], demosaic_fn,
                                     device=device)
        fields = [gather(t, mesh, "data") for t in res[:5]]
        resid = None if res.resid_trace is None else gather(res.resid_trace, mesh, "data")
        variables = None if params is None else stack_states([dict(params)] * n)
        return ADMMResult(*fields, variables, resid_trace=resid)
    with full_f32(), torch.no_grad():
        st = SolveState(config, prior, params, device)
        x0_p = (physics.adjoint(bayer.pack(y), bayer.pack(phi), physics.PACKED_FRAME_AXIS)
                if x0 is None else bayer.pack(x0))
        theta, xhat, trace, resids = run_admm(config, prior, st.net, y, phi, x0_p, orig,
                                              None, demosaic_fn, pooled=False)
        x_bayer = bayer.unpack(theta)
        metrics_t = [frame_metrics(None if orig is None else orig[t], x_bayer[t])
                     for t in range(n)]
        p = torch.stack([m[0] for m in metrics_t])
        s = torch.stack([m[1] for m in metrics_t])
    variables = None if params is None else stack_states([dict(params)] * n)
    return ADMMResult(xhat, x_bayer, p, s, trace, variables, resid_trace=resids)


def shard_slice(n: int, mesh: Mesh, axis: str) -> slice:
    """This rank's consecutive share of ``n`` items split evenly over the
    ranks of ``axis``."""
    k = mesh.axis_size(axis)
    if n % k:
        raise ValueError(f"{n} items (measurements, or the tiles of a tile_chunk group) do "
                         f"not split over the mesh's {k} {axis} ranks")
    m = n // k
    i = mesh.axis_index(axis)
    return slice(i * m, (i + 1) * m)


def _check_ddnet_window(win: int, config: ADMMConfig, dm_spec: DmSpec | None) -> None:
    """DDnet's demosaicker pads a frame up to a multiple of 4, but its
    half-resolution branch downsamples twice more, so a padded size of
    4 (mod 8) fails in both packages; refuse such a window up front."""
    if config.demosaic_method != "ddnet" and dm_spec is None:
        return
    padded = -(-win // 4) * 4
    if padded % 8:
        raise ValueError(
            f"DDnet needs tile windows whose size, padded to a multiple of 4, is a "
            f"multiple of 8: the window is {win} (tile + 2 * overlap), padded {padded}")


def two_stage_admm_tiled(
    y_bayer: np.ndarray | Tensor,
    phi_bayer: np.ndarray | Tensor,
    config: ADMMConfig,
    tile: int = 512,
    prior: Prior | None = None,
    params: Mapping[str, Tensor] | None = None,
    orig_bayer: np.ndarray | Tensor | None = None,
    demosaic_fn: Callable[[Tensor], Tensor] | None = None,
    x0_bayer: np.ndarray | Tensor | None = None,
    opt_state: Mapping | None = None,
    dm_spec: DmSpec | None = None,
    dm_variables: Mapping[str, Tensor] | None = None,
    dm_opt_state: Mapping | None = None,
    generator: torch.Generator | None = None,
    overlap: int = 0,
    tile_chunk: int | None = None,
    device: torch.device | str = "cuda",
    mesh: Mesh | None = None,
) -> ADMMResult:
    """Large-scene mode: reconstruct one oversized measurement ``y (H, W)``
    as ``tile x tile`` patches solved in lockstep, then stitch.

    The SCI x-update is pixel-separable, so tiling is exact for the data
    term; only the denoiser and demosaicker see tile borders. ``tile`` must
    be even and divide H and W. ``overlap`` (even, in pixels): each tile is
    solved on a ``tile + 2 * overlap`` window of real context (the scene is
    reflect-padded at its edges) and only its central core is stitched.

    All tiles share one adapted weight copy: each adaptation step takes the
    mean of the tiles' losses, the gradient the JAX package ``pmean``-s over
    its tile axis; ``dm_spec`` adapts one demosaicker the same way. With
    ``config.select_best`` every tile takes the same iterate, the one whose
    residual averaged over the tiles is least. ``tile_chunk`` solves the tiles
    in sequential groups of that size (it must divide the tile count), the
    weights, Adam states and noise generator carried from group to group;
    pooling and the pick then span one group. The returned weights and Adam
    states are the single shared copy after the last group; ``opt_state`` /
    ``dm_opt_state`` continue adaptation from an earlier measurement.

    ``x0_bayer``: the full-size warm start ``(B, H, W)`` (GAP-TV), cropped
    into tiles; without it each tile starts from the adjoint. The PSNR trace
    is the mean over tiles (zeros without ``orig_bayer``); ``resid_trace`` is
    ``(groups, T + 1)``.

    ``mesh``: the tiles of each group split evenly over the ranks of its
    ``data`` axis (the group size must divide by it), each rank solving its
    consecutive share (the JAX package places the tiles with ``P('data')``).
    Each rank divides its tiles' adaptation losses by the group's tile count
    and the gradients (the denoiser's and the in-scan demosaicker's) are
    summed over the ranks; the ``select_best`` residual is averaged over all
    the group's tiles; every rank draws the whole group's adaptation draws in
    tile order and keeps its own. So each tile sees what it sees in one
    process, and the stitched result, the weights and the Adam states come
    back the same on every rank. A mesh with more than one rank on its
    ``frame`` axis is refused (``NotImplementedError``): the JAX package
    places the tiles over ``data`` only."""
    check_supported(config, prior, demosaic_fn, dm_spec)
    if mesh is not None and mesh.axis_size("frame") > 1:
        raise NotImplementedError("two_stage_admm_tiled(mesh=) splits its tiles over the 'data' "
                                  "axis only; a mesh with a 'frame' axis of "
                                  f"{mesh.axis_size('frame')} ranks is not supported")
    y = as_f32(y_bayer, device)
    phi = as_f32(phi_bayer, device)
    check_inputs(y, phi)
    h, w = y.shape
    if tile % 2 or h % tile or w % tile:
        raise ValueError(f"tile {tile} must be even and divide the scene {h} x {w}")
    if overlap < 0 or overlap % 2:
        raise ValueError(f"overlap {overlap} must be even and >= 0 (the Bayer phase)")
    win = tile + 2 * overlap
    _check_ddnet_window(win, config, dm_spec)

    def crop(arr: Tensor) -> Tensor:
        # (C, H, W) -> (N, C, win, win)
        if overlap:
            arr = F.pad(arr, (overlap,) * 4, mode="reflect")
            t, grid = crop_overlapping(torch.movedim(arr, 0, -1), tile, overlap)
        else:
            t, grid = crop_patches(torch.movedim(arr, 0, -1), tile)
        return torch.movedim(t, -1, 1).contiguous(), grid

    y_t, grid = crop(y[None])
    y_t = y_t[:, 0]
    phi_t, _ = crop(phi)
    orig = as_f32(orig_bayer, device) if orig_bayer is not None else None
    orig_t = crop(orig)[0] if orig is not None else None
    x0_t = crop(as_f32(x0_bayer, device))[0] if x0_bayer is not None else None
    n_tiles = y_t.shape[0]
    chunk = n_tiles if tile_chunk is None else int(tile_chunk)
    if not 1 <= chunk <= n_tiles or n_tiles % chunk:
        raise ValueError(f"tile_chunk {tile_chunk} must divide the tile count {n_tiles}")
    pooled = ((config.adapt is not None and prior is not None) or dm_spec is not None
              or config.select_best)
    shard, mine = None, slice(0, chunk)
    if mesh is not None:
        mine = shard_slice(chunk, mesh, "data")
        shard = ItemShard(mine.start, chunk, lambda ts: all_reduce_tensors(ts, mesh, "data"))

    with full_f32(), torch.no_grad():
        st = SolveState(config, prior, params, device, opt_state, dm_spec, dm_variables,
                    dm_opt_state, generator)
        thetas, xhats, traces, resids = [], [], [], []
        for c0 in range(0, n_tiles, chunk):
            sl = slice(c0 + mine.start, c0 + mine.stop)
            y_c, phi_c = y_t[sl], phi_t[sl]
            x0_c = (physics.adjoint(bayer.pack(y_c), bayer.pack(phi_c), physics.PACKED_FRAME_AXIS)
                    if x0_t is None else bayer.pack(x0_t[sl]))
            theta, xhat, trace, r = run_admm(
                config, prior, st.net, y_c, phi_c, x0_c,
                None if orig_t is None else orig_t[sl], st.generator, demosaic_fn, st.dm,
                st.opt, pooled, shard)
            if mesh is not None:
                theta, xhat, trace = (gather(v, mesh, "data") for v in (theta, xhat, trace))
            thetas.append(theta)
            xhats.append(xhat)
            traces.append(trace)
            resids.append(r)
        theta, xhat, trace = (torch.cat(v) for v in (thetas, xhats, traces))
        x_bayer_t = bayer.unpack(theta)  # (N, B, win, win)
        if overlap:
            # keep only the cores: the borders the denoiser saw lie in the halo
            core = slice(overlap, overlap + tile)
            x_bayer_t = x_bayer_t[:, :, core, core]
            xhat = xhat[:, :, core, core, :]
        x_bayer = torch.movedim(stitch_patches(torch.movedim(x_bayer_t, 1, -1), grid), -1, 0)
        nb = phi.shape[0]
        xr = torch.movedim(xhat, 1, -2).reshape(n_tiles, tile, tile, nb * 3)
        x_rgb = torch.movedim(stitch_patches(xr, grid).reshape(h, w, nb, 3), 2, 0)
        p, s = frame_metrics(orig, x_bayer)
        trace = trace.mean(dim=0) if orig is not None else torch.zeros_like(trace[0])
    variables, opt_out, dm_vars, dm_opt = st.states()
    resid_trace = torch.stack(resids) if resids[0] is not None else None
    return ADMMResult(x_rgb, x_bayer, p, s, trace, variables, opt_out, dm_vars, dm_opt,
                      resid_trace)
