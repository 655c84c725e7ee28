"""Port solvers vs the JAX package on the CPU: GAP-TV, two-stage ADMM (TV,
FFDNet and FastDVDnet branches) and the end-to-end paths with online
adaptation.

Both packages get the same numpy scene and the same numpy weights (FFDNet:
Flax init, bridged; FastDVDnet: the trained ``weights/fastdvd.npz``, bridged).
Bar: per-frame PSNR within 0.1 dB (the repo's parity budget) and max
|dx_bayer| <= 1e-3.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.adapt.online import AdaptConfig as TAdaptConfig
from adaptivepnp_sci_torch.data.synthetic import make_scene as tmake_scene
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet as TFastDVDnet
from adaptivepnp_sci_torch.models.ffdnet import FFDNet as TFFDNet
from adaptivepnp_sci_torch.solvers import end_to_end as tend
from adaptivepnp_sci_torch.solvers import gap_tv as tgap
from adaptivepnp_sci_torch.solvers import two_stage_admm as tadmm
from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior as tfastdvd_prior
from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior as tffdnet_prior
from adaptivepnp_sci_tpu.adapt.online import AdaptConfig
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_tpu.models.ffdnet import FFDNet
from adaptivepnp_sci_tpu.solvers import ADMMConfig, GapTVConfig, gap_tv, two_stage_admm
from adaptivepnp_sci_tpu.solvers.end_to_end import reconstruct_single_dispatch
from adaptivepnp_sci_tpu.solvers.priors import fastdvd_prior, ffdnet_prior
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz

SIGMA = (25 / 255, 12 / 255, 6 / 255)
ITERS = (15, 6, 4)
ADAPT = dict(lr=2e-6, update_per_iter=2, interval_iter=15, initial_iter=1)

# the FastDVDnet slice: the Bosphorus row of the scene table
FASTDVD_SIGMA = (12 / 255, 6 / 255)
FASTDVD_ITERS = (24, 12)
FASTDVD_ADAPT = dict(lr=2e-7, update_per_iter=2, interval_iter=12, initial_iter=1)
FASTDVD_WEIGHTS = Path(__file__).resolve().parent.parent / "weights" / "fastdvd.npz"


def assert_parity(port, ref, db=0.1, dx=1e-3):
    """Per-frame PSNR within ``db`` and max |x_bayer difference| <= ``dx``;
    returns the two measured gaps."""
    p_gap = float(np.abs(port.psnr_per_frame.numpy() - np.asarray(ref.psnr_per_frame)).max())
    x_gap = float(np.abs(port.x_bayer.numpy() - np.asarray(ref.x_bayer)).max())
    assert np.all(np.isfinite(port.x_bayer.numpy()))
    assert p_gap <= db and x_gap <= dx, (p_gap, x_gap)
    return p_gap, x_gap


def ffdnet_pair(nc, nb, seed=0):
    """Flax FFDNet + its numpy variables, and the port's prior + bridged params."""
    model = FFDNet(in_nc=3, out_nc=3, nc=nc, nb=nb)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)),
                           jnp.float32(0.1))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params = tconvert.ffdnet_from_flax(variables)
    return (ffdnet_prior(model), variables), (tffdnet_prior(TFFDNet(nc=nc, nb=nb)), params)


def fastdvd_pair(noise: bool = False):
    """The JAX FastDVDnet prior + trained variables, and the port's prior +
    bridged state dict; the adaptation noise off in both unless asked for."""
    variables = load_variables_npz(str(FASTDVD_WEIGHTS))
    jprior, tprior = fastdvd_prior(FastDVDnet()), tfastdvd_prior(TFastDVDnet())
    if not noise:
        jprior = jprior._replace(adapt_noise_std=0.0)
        tprior = tprior._replace(adapt_noise_std=0.0)
    return (jprior, variables), (tprior, tconvert.fastdvdnet_from_flax(variables))


def assert_fastdvd_weights(got_sd, ref_variables, variables, lr, steps):
    """Adapted weights within ``steps * lr`` of JAX's everywhere (a fresh
    Adam moves a weight by about lr per step whatever its gradient) and within
    5 % of lr for 99 % of them; BatchNorm statistics bitwise unchanged."""
    got = tconvert.fastdvdnet_to_flax(got_sd)
    n_far = n_all = moved = 0
    for path, want in jax.tree_util.tree_leaves_with_path(ref_variables["params"]):
        mine, before = got["params"], variables["params"]
        for p in path:
            mine, before = mine[p.key], before[p.key]
        diff = np.abs(mine - np.asarray(want))
        assert diff.max() <= steps * lr + 1e-8
        n_far += int((diff > 0.05 * lr).sum())
        n_all += diff.size
        moved += int((mine != before).sum())
    assert moved > 0.5 * n_all and n_far <= 0.01 * n_all, (moved, n_far, n_all)
    for path, want in jax.tree_util.tree_leaves_with_path(variables["batch_stats"]):
        mine = got["batch_stats"]
        for p in path:
            mine = mine[p.key]
        np.testing.assert_array_equal(mine, want)


@pytest.mark.parametrize("style", ["smooth", "leaves"])
def test_make_scene_bitwise_equal(style):
    a = tmake_scene(b=8, h=32, w=32, seed=3, style=style)
    b = make_scene(b=8, h=32, w=32, seed=3, style=style)
    for f in ("meas", "mask", "orig_bayer", "orig_rgb"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_gap_tv_matches_jax():
    sc = make_scene(b=8, h=32, w=32, seed=0)
    ref = gap_tv(jnp.asarray(sc.meas), jnp.asarray(sc.mask), GapTVConfig(iters=10),
                 orig_bayer=jnp.asarray(sc.orig_bayer))
    got = tgap.gap_tv(sc.meas, sc.mask, tgap.GapTVConfig(iters=10),
                      orig_bayer=sc.orig_bayer, device="cpu")
    assert_parity(got, ref)
    np.testing.assert_allclose(got.psnr_trace.numpy(), np.asarray(ref.psnr_trace), atol=0.1)
    np.testing.assert_allclose(got.ssim_per_frame.numpy(), np.asarray(ref.ssim_per_frame),
                               atol=1e-3)


def test_two_stage_admm_tv_matches_jax():
    sc = make_scene(b=8, h=32, w=32, seed=1)
    cfg = dict(sigma=(0.0,), iters=(12,), denoiser="tv")
    ref = two_stage_admm(jnp.asarray(sc.meas), jnp.asarray(sc.mask), ADMMConfig(**cfg),
                         orig_bayer=jnp.asarray(sc.orig_bayer))
    got = tadmm.two_stage_admm(sc.meas, sc.mask, tadmm.ADMMConfig(**cfg),
                               orig_bayer=sc.orig_bayer, device="cpu")
    assert_parity(got, ref)


@pytest.mark.parametrize("demosaic_method", ["malvar", "bilinear"])
def test_two_stage_admm_ffdnet_matches_jax(demosaic_method):
    """FFDNet branch from a GAP-TV warm start, with one adaptation trigger."""
    sc = make_scene(b=8, h=32, w=32, seed=2)
    (jprior, variables), (tprior, params) = ffdnet_pair(nc=8, nb=3)
    x0 = np.array(gap_tv(jnp.asarray(sc.meas), jnp.asarray(sc.mask),
                          GapTVConfig(iters=10)).x_bayer)
    kw = dict(sigma=(25 / 255, 12 / 255), iters=(4, 2), demosaic_method=demosaic_method)
    ref = two_stage_admm(jnp.asarray(sc.meas), jnp.asarray(sc.mask),
                         ADMMConfig(**kw, adapt=AdaptConfig(lr=2e-6, interval_iter=3)),
                         jprior, variables, jnp.asarray(x0),
                         orig_bayer=jnp.asarray(sc.orig_bayer))
    got = tadmm.two_stage_admm(sc.meas, sc.mask,
                               tadmm.ADMMConfig(**kw, adapt=TAdaptConfig(lr=2e-6, interval_iter=3)),
                               tprior, params, x0, orig_bayer=sc.orig_bayer, device="cpu")
    assert_parity(got, ref)
    np.testing.assert_allclose(got.x_rgb.numpy(), np.asarray(ref.x_rgb), atol=1e-3)


def test_reconstruct_single_dispatch_matches_jax():
    """The flagship schedule with adaptation at k = 15, at 64x64x8 with FFDNet
    nc = 16, nb = 4."""
    sc = make_scene(b=8, h=64, w=64, seed=42)
    (jprior, variables), (tprior, params) = ffdnet_pair(nc=16, nb=4)
    ref = reconstruct_single_dispatch(
        jnp.asarray(sc.meas), jnp.asarray(sc.mask), GapTVConfig(iters=40),
        ADMMConfig(sigma=SIGMA, iters=ITERS, adapt=AdaptConfig(**ADAPT)),
        jprior, variables, orig=jnp.asarray(sc.orig_bayer))
    got = tend.reconstruct_single_dispatch(
        sc.meas, sc.mask, tgap.GapTVConfig(iters=40),
        tadmm.ADMMConfig(sigma=SIGMA, iters=ITERS, adapt=TAdaptConfig(**ADAPT)),
        tprior, params, orig=sc.orig_bayer, device="cpu")
    assert_parity(got, ref)
    np.testing.assert_allclose(got.ssim_per_frame.numpy(), np.asarray(ref.ssim_per_frame),
                               atol=1e-3)
    assert got.psnr_trace.shape == (25,)
    adapted = tconvert.ffdnet_to_flax(got.variables)["params"]
    for name, p in ref.variables["params"].items():
        np.testing.assert_allclose(adapted[name]["kernel"], np.asarray(p["kernel"]),
                                   atol=5e-6)
    # the caller's parameters are untouched, the returned ones adapted
    assert not all(torch.equal(got.variables[k], params[k]) for k in params)
    for k, v in tconvert.ffdnet_from_flax(variables).items():
        assert torch.equal(params[k], v)


def test_two_stage_admm_fastdvd_matches_jax():
    """FastDVDnet branch (rho 0.55, 'bayer1' adaptation at k = 3) from a
    GAP-TV warm start at 32x32x8, noise off."""
    sc = make_scene(b=8, h=32, w=32, seed=2)
    (jprior, variables), (tprior, params) = fastdvd_pair()
    x0 = np.array(gap_tv(jnp.asarray(sc.meas), jnp.asarray(sc.mask),
                          GapTVConfig(iters=10)).x_bayer)
    kw = dict(sigma=FASTDVD_SIGMA, iters=(4, 2), denoiser="fastdvd")
    adapt = dict(lr=2e-7, update_per_iter=2, interval_iter=3)
    ref = two_stage_admm(jnp.asarray(sc.meas), jnp.asarray(sc.mask),
                         ADMMConfig(**kw, adapt=AdaptConfig(**adapt)),
                         jprior, variables, jnp.asarray(x0),
                         orig_bayer=jnp.asarray(sc.orig_bayer))
    cfg = tadmm.ADMMConfig(**kw, adapt=TAdaptConfig(**adapt))
    assert cfg.rho == 0.55 and cfg.alpha == 1.0 and cfg.tau == 100.0
    got = tadmm.two_stage_admm(sc.meas, sc.mask, cfg, tprior, params, x0,
                               orig_bayer=sc.orig_bayer, device="cpu")
    assert_parity(got, ref)
    np.testing.assert_allclose(got.x_rgb.numpy(), np.asarray(ref.x_rgb), atol=1e-3)
    assert_fastdvd_weights(got.variables, ref.variables, variables, 2e-7, 2)


def test_reconstruct_single_dispatch_fastdvd_matches_jax():
    """The FastDVDnet slice's schedule at 64x64x8 with the trained weights:
    40 GAP-TV iterations, sigma (12, 6)/255 x (24, 12), adaptation at k = 12
    and 24 (2 Adam steps at lr 2e-7), noise off on both sides."""
    sc = make_scene(b=8, h=64, w=64, seed=42)
    (jprior, variables), (tprior, params) = fastdvd_pair()
    kw = dict(sigma=FASTDVD_SIGMA, iters=FASTDVD_ITERS, denoiser="fastdvd")
    ref = reconstruct_single_dispatch(
        jnp.asarray(sc.meas), jnp.asarray(sc.mask), GapTVConfig(iters=40),
        ADMMConfig(**kw, adapt=AdaptConfig(**FASTDVD_ADAPT)),
        jprior, variables, orig=jnp.asarray(sc.orig_bayer))
    tcfg = tadmm.ADMMConfig(**kw, adapt=TAdaptConfig(**FASTDVD_ADAPT))
    assert np.nonzero(tadmm.make_schedule(tcfg.sigma, tcfg.iters, tcfg.adapt)[1])[0].tolist() \
        == [12, 24]
    got = tend.reconstruct_single_dispatch(
        sc.meas, sc.mask, tgap.GapTVConfig(iters=40), tcfg,
        tprior, params, orig=sc.orig_bayer, device="cpu")
    assert_parity(got, ref)
    np.testing.assert_allclose(got.ssim_per_frame.numpy(), np.asarray(ref.ssim_per_frame),
                               atol=1e-3)
    assert got.psnr_trace.shape == (36,)
    # two triggers of two steps each
    assert_fastdvd_weights(got.variables, ref.variables, variables, 2e-7, 4)
    for k, v in tconvert.fastdvdnet_from_flax(variables).items():
        assert torch.equal(params[k], v)  # the caller's parameters are untouched


def test_fastdvd_noise_is_drawn_from_the_generator():
    """With the adaptation noise on, the solver draws it from the generator
    it is given: the same seed gives the same result, no generator means seed
    0, another seed another result."""
    sc = tmake_scene(b=8, h=16, w=16, seed=0)
    _, (tprior, params) = fastdvd_pair(noise=True)
    cfg = tadmm.ADMMConfig(sigma=(12 / 255,), iters=(3,), denoiser="fastdvd",
                           adapt=TAdaptConfig(lr=1e-4, update_per_iter=1, interval_iter=2))

    def run(generator):
        return tadmm.two_stage_admm(sc.meas, sc.mask, cfg, tprior, params, device="cpu",
                                    generator=generator)

    a, b = run(torch.Generator().manual_seed(0)), run(None)
    c = run(torch.Generator().manual_seed(1))
    assert torch.equal(a.x_bayer, b.x_bayer)
    assert all(torch.equal(a.variables[k], b.variables[k]) for k in params)
    assert not torch.equal(a.x_bayer, c.x_bayer)
    assert any(not torch.equal(a.variables[k], params[k]) for k in params)


def test_unported_options_raise():
    sc = tmake_scene(b=8, h=16, w=16, seed=0)
    for kw in ({"denoiser": "gap_deep"},):
        cfg = tadmm.ADMMConfig(sigma=(0.1,), iters=(1,), **{"denoiser": "tv", **kw})
        with pytest.raises(NotImplementedError):
            tadmm.two_stage_admm(sc.meas, sc.mask, cfg, device="cpu")
    # the photograph styles are ported; an unknown style is refused
    assert tmake_scene(b=2, h=16, w=16, style="photo").meas.shape == (16, 16)
    with pytest.raises(ValueError):
        tmake_scene(b=2, h=16, w=16, style="marble")
    # the guard, relaxation, closed form and aliasing modes are ported
    for kw in ({"select_best": True}, {"select_best": True, "select_best_holdout": 0.05},
               {"denoiser_relax": 0.5}, {"faithful_aliasing": True}):
        cfg = tadmm.ADMMConfig(sigma=(0.1,), iters=(1,), **{"denoiser": "tv", **kw})
        assert tadmm.two_stage_admm(sc.meas, sc.mask, cfg, device="cpu").x_bayer.shape == (8, 16, 16)
    # FastDVDnet is ported: without a prior it is a usage error; its input
    # corruption is ported too, and an unknown corruption mode is refused
    fast = tadmm.ADMMConfig(sigma=(0.1,), iters=(1,), denoiser="fastdvd")
    with pytest.raises(ValueError):
        tadmm.two_stage_admm(sc.meas, sc.mask, fast, device="cpu")
    masked = tfastdvd_prior(TFastDVDnet(), adapt_mask=("q", 0.1))
    with pytest.raises(ValueError):
        tadmm.two_stage_admm(
            sc.meas, sc.mask,
            tadmm.ADMMConfig(sigma=(0.1,), iters=(1,), denoiser="fastdvd", adapt=TAdaptConfig()),
            masked, device="cpu")


@pytest.mark.slow
def test_flagship_512_parity_with_jax():
    """The bench.py inputs at full width: 512x512x8, seed 42, FFDNet nc = 96,
    nb = 12, the same numpy weights in both packages, both on the CPU."""
    sc = make_scene(b=8, h=512, w=512, seed=42)
    (jprior, variables), (tprior, params) = ffdnet_pair(nc=96, nb=12)
    ref = reconstruct_single_dispatch(
        jnp.asarray(sc.meas), jnp.asarray(sc.mask), GapTVConfig(iters=40),
        ADMMConfig(sigma=SIGMA, iters=ITERS, adapt=AdaptConfig(**ADAPT)),
        jprior, variables, orig=jnp.asarray(sc.orig_bayer))
    got = tend.reconstruct_single_dispatch(
        sc.meas, sc.mask, tgap.GapTVConfig(iters=40),
        tadmm.ADMMConfig(sigma=SIGMA, iters=ITERS, adapt=TAdaptConfig(**ADAPT)),
        tprior, params, orig=sc.orig_bayer, device="cpu")
    assert_parity(got, ref)
