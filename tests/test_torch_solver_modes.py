"""Port solver modes vs the JAX package on the CPU: the ``select_best`` guard
(raw and held out), ``denoiser_relax``, the closed-form demosaic,
``faithful_aliasing``, the option checks, the scene tables, and a
deep-demosaicking row of the table end to end (the DDnet demosaicker in the
loop: ``tests/test_torch_dm_update.py``).

Both packages get the same numpy scene and weights (FFDNet: Flax init,
bridged; FastDVDnet and DDnet: the trained ``weights/*.npz``, bridged). The
held-out guard's mask comes from a PRNG whose stream the port does not
reproduce, so the port is given JAX's mask (``holdout_mask`` patched).
Bar: per-frame PSNR within 0.1 dB (the repo's parity budget) and max
|dx_bayer| <= 1e-3; under the guard, the same chosen iterate.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.adapt.online import AdaptConfig as TAdaptConfig
from adaptivepnp_sci_torch.configs import scenes as tscenes
from adaptivepnp_sci_torch.data.synthetic import make_scene as tmake_scene
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.ddnet import DDnet as TDDnet
from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet as TFastDVDnet
from adaptivepnp_sci_torch.solvers import end_to_end as tend
from adaptivepnp_sci_torch.solvers import gap_tv as tgap
from adaptivepnp_sci_torch.solvers import two_stage_admm as tadmm
from adaptivepnp_sci_torch.solvers.priors import ddnet_demosaic as tddnet_demosaic
from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior as tfastdvd_prior
from adaptivepnp_sci_tpu.adapt.online import AdaptConfig
from adaptivepnp_sci_tpu.configs import scenes
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models.ddnet import DDnet
from adaptivepnp_sci_tpu.ops import bayer, metrics, physics
from adaptivepnp_sci_tpu.solvers import ADMMConfig, GapTVConfig, gap_tv, two_stage_admm
from adaptivepnp_sci_tpu.solvers.end_to_end import reconstruct_single_dispatch
from adaptivepnp_sci_tpu.solvers.priors import ddnet_demosaic
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz
from test_torch_solvers import assert_parity, fastdvd_pair, ffdnet_pair

DDNET_WEIGHTS = Path(__file__).resolve().parent.parent / "weights" / "ddnet.npz"
SIGMA = (25 / 255, 12 / 255)
ITERS = (4, 2)


@pytest.fixture(scope="module")
def scene():
    """A 32x32x8 scene and a 10-iteration GAP-TV warm start of it."""
    sc = make_scene(b=8, h=32, w=32, seed=2)
    x0 = np.array(gap_tv(jnp.asarray(sc.meas), jnp.asarray(sc.mask),
                         GapTVConfig(iters=10)).x_bayer)
    return sc, x0


@pytest.fixture(scope="module")
def ffdnet():
    return ffdnet_pair(nc=8, nb=3)


@pytest.fixture(scope="module")
def ddnet_vars():
    return load_variables_npz(str(DDNET_WEIGHTS))


def jax_mask(seed, frac, shape, device):
    """The JAX package's held-out pixels, as a port tensor."""
    hold = jax.random.bernoulli(jax.random.PRNGKey(seed), frac, shape)
    return torch.from_numpy(np.asarray(hold, np.float32)).to(device)


def solve_both(sc, x0, pair, kw, adapt=None, jax_extra=None, port_extra=None):
    """JAX ``two_stage_admm`` and the port's on the same inputs and config."""
    (jprior, variables), (tprior, params) = pair
    ref = two_stage_admm(jnp.asarray(sc.meas), jnp.asarray(sc.mask),
                         ADMMConfig(**kw, adapt=adapt and AdaptConfig(**adapt)),
                         jprior, variables, jnp.asarray(x0),
                         orig_bayer=jnp.asarray(sc.orig_bayer), **(jax_extra or {}))
    got = tadmm.two_stage_admm(sc.meas, sc.mask,
                               tadmm.ADMMConfig(**kw, adapt=adapt and TAdaptConfig(**adapt)),
                               tprior, params, x0, orig_bayer=sc.orig_bayer, device="cpu",
                               **(port_extra or {}))
    return ref, got


def jax_pick(ref, sc, x0) -> int:
    """The candidate JAX's guard returned, from its own outputs: 0 for the warm
    start, k + 1 for iterate k (the iterate whose PSNR, in JAX's trace, is
    that of the returned estimate)."""
    orig = jnp.asarray(sc.orig_bayer)
    cands = np.concatenate([[float(metrics.psnr(orig, jnp.asarray(x0)))],
                            np.asarray(ref.psnr_trace)])
    gaps = np.abs(cands - float(metrics.psnr(orig, ref.x_bayer)))
    pick = int(np.argmin(gaps))
    assert gaps[pick] < 1e-4, gaps
    return pick


def assert_same_pick(got, ref, sc, x0):
    """The port picks the candidate JAX picks; the message carries the gap
    between the best and the second-best residual."""
    r = got.resid_trace.numpy()
    order = np.argsort(r, kind="stable")
    gap = float(r[order[1]] - r[order[0]])
    assert int(order[0]) == jax_pick(ref, sc, x0), (r, gap)
    return int(order[0]), gap


@pytest.mark.parametrize("holdout", [0.0, 0.05])
def test_select_best_matches_jax(scene, monkeypatch, holdout):
    """The guard on the FastDVDnet branch, raw and held out (JAX's mask), with
    a trigger at k = 3: the same chosen iterate and the same result."""
    sc, x0 = scene
    monkeypatch.setattr(tadmm, "holdout_mask", jax_mask)
    kw = dict(sigma=(12 / 255, 6 / 255), iters=ITERS, denoiser="fastdvd", select_best=True,
              select_best_holdout=holdout, select_best_seed=3, select_best_warm_iters=10)
    ref, got = solve_both(sc, x0, fastdvd_pair(), kw,
                          dict(lr=2e-7, update_per_iter=2, interval_iter=3))
    assert got.resid_trace.shape == (7,)
    assert_same_pick(got, ref, sc, x0)
    assert_parity(got, ref)
    np.testing.assert_allclose(got.x_rgb.numpy(), np.asarray(ref.x_rgb), atol=1e-3)


@pytest.mark.parametrize("holdout", [0.0, 0.05])
def test_tv_select_best_matches_jax(monkeypatch, holdout):
    sc = make_scene(b=8, h=32, w=32, seed=1)
    monkeypatch.setattr(tadmm, "holdout_mask", jax_mask)
    kw = dict(sigma=(0.0,), iters=(12,), denoiser="tv", select_best=True,
              select_best_holdout=holdout, select_best_warm_iters=5)
    ref = two_stage_admm(jnp.asarray(sc.meas), jnp.asarray(sc.mask), ADMMConfig(**kw),
                         orig_bayer=jnp.asarray(sc.orig_bayer))
    got = tadmm.two_stage_admm(sc.meas, sc.mask, tadmm.ADMMConfig(**kw),
                               orig_bayer=sc.orig_bayer, device="cpu")
    x0 = np.asarray(bayer.unpack(physics.adjoint(bayer.pack(jnp.asarray(sc.meas)),
                                                 bayer.pack(jnp.asarray(sc.mask)))))
    assert_same_pick(got, ref, sc, x0)
    assert_parity(got, ref)


@pytest.mark.parametrize("relax", [0.5, (0.5, 1.0)])
def test_denoiser_relax_matches_jax(scene, ffdnet, relax):
    sc, x0 = scene
    ref, got = solve_both(sc, x0, ffdnet, dict(sigma=SIGMA, iters=ITERS, denoiser_relax=relax),
                          dict(lr=2e-6, interval_iter=3))
    assert_parity(got, ref)
    np.testing.assert_allclose(got.x_rgb.numpy(), np.asarray(ref.x_rgb), atol=1e-3)


def test_closed_form_demosaic_matches_jax(scene, ffdnet):
    """rho 0.55 and tau 10; Malvar at k = 0, the clipped closed form after."""
    sc, x0 = scene
    cfg = tadmm.ADMMConfig(sigma=SIGMA, iters=ITERS, closed_form_demosaic=True)
    assert (cfg.rho, cfg.tau) == (0.55, 10.0)
    ref, got = solve_both(sc, x0, ffdnet, dict(sigma=SIGMA, iters=ITERS, closed_form_demosaic=True),
                          dict(lr=2e-6, interval_iter=3))
    assert_parity(got, ref)
    np.testing.assert_allclose(got.x_rgb.numpy(), np.asarray(ref.x_rgb), atol=1e-3)


def test_faithful_aliasing_matches_jax(scene, ffdnet):
    sc, x0 = scene
    kw = dict(sigma=SIGMA, iters=ITERS)
    ref, got = solve_both(sc, x0, ffdnet, {**kw, "faithful_aliasing": True})
    assert_parity(got, ref)
    plain = tadmm.two_stage_admm(sc.meas, sc.mask, tadmm.ADMMConfig(**kw), ffdnet[1][0],
                                 ffdnet[1][1], x0, device="cpu")
    assert not torch.equal(plain.x_bayer, got.x_bayer)  # the mode changes the result


def test_holdout_mask_is_seeded_and_device_free():
    a = tadmm.holdout_mask(0, 0.05, (64, 64), "cpu")
    assert a.dtype == torch.float32 and set(a.unique().tolist()) == {0.0, 1.0}
    assert torch.equal(a, tadmm.holdout_mask(0, 0.05, (64, 64), "cpu"))
    assert not torch.equal(a, tadmm.holdout_mask(1, 0.05, (64, 64), "cpu"))
    assert 0.03 < float(a.mean()) < 0.07


@pytest.mark.parametrize("case", ["dm_spec_closed_form", "dm_spec_tv", "relax_stages",
                                  "ddnet_without_demosaicker", "fastdvd_without_prior"])
def test_invalid_combinations_raise_value_error(case):
    sc = tmake_scene(b=8, h=16, w=16, seed=0)
    base = dict(sigma=(0.1, 0.05), iters=(1, 1))
    spec = tadmm.make_dm_spec(TDDnet())
    prior = tfastdvd_prior(TFastDVDnet())
    kw, extra = {
        "dm_spec_closed_form": (dict(denoiser="fastdvd", closed_form_demosaic=True),
                                dict(prior=prior, dm_spec=spec)),
        "dm_spec_tv": (dict(denoiser="tv"), dict(dm_spec=spec)),
        "relax_stages": (dict(denoiser="fastdvd", denoiser_relax=(0.5,)), dict(prior=prior)),
        "ddnet_without_demosaicker": (dict(denoiser="fastdvd", demosaic_method="ddnet"),
                                      dict(prior=prior)),
        "fastdvd_without_prior": (dict(denoiser="fastdvd"), {}),
    }[case]
    with pytest.raises(ValueError):
        tadmm.two_stage_admm(sc.meas, sc.mask, tadmm.ADMMConfig(**base, **kw), device="cpu",
                             **extra)


@pytest.mark.parametrize("case", ["gap_deep", "adapt_mask", "adapt_crop"])
def test_still_unported_options_raise(case):
    """Options not ported raise ``NotImplementedError``; the adaptation crop
    and input corruption, ported since, keep the JAX package's ``ValueError``
    for an odd crop and an unknown corruption mode."""
    sc = tmake_scene(b=8, h=16, w=16, seed=0)
    adapt = TAdaptConfig(interval_iter=2)
    prior = tfastdvd_prior(TFastDVDnet())
    kw, p = {
        "gap_deep": (dict(denoiser="gap_deep"), prior),
        "adapt_mask": (dict(adapt=adapt), tfastdvd_prior(TFastDVDnet(), adapt_mask=("q", 0.1))),
        "adapt_crop": (dict(adapt=dataclasses.replace(adapt, crop=7)), prior),
    }[case]
    error = NotImplementedError if case == "gap_deep" else ValueError
    cfg = tadmm.ADMMConfig(sigma=(0.1,), iters=(3,), **{"denoiser": "fastdvd", **kw})
    with pytest.raises(error):
        tadmm.two_stage_admm(sc.meas, sc.mask, cfg, p, device="cpu")
    with pytest.raises(error):
        tend.reconstruct_single_dispatch(sc.meas, sc.mask, tgap.GapTVConfig(iters=1), cfg, p,
                                         None, device="cpu")


@pytest.mark.parametrize("case", ["menon2007", "carried_adapt_opt"])
def test_lifted_options_match_jax(scene, ffdnet, case):
    """The options the multi-measurement slice ported, once refused: Menon
    2007 demosaicking, and a carried Adam state
    (``fresh_opt_per_trigger=False``) through two triggers, on the FFDNet
    branch; the carried Adam end to end too."""
    sc, x0 = scene
    adapt = dict(lr=2e-6, update_per_iter=1, interval_iter=2)
    kw = dict(sigma=SIGMA, iters=ITERS)
    if case == "menon2007":
        kw["demosaic_method"] = "menon2007"
    else:
        adapt["fresh_opt_per_trigger"] = False
    ref, got = solve_both(sc, x0, ffdnet, kw, adapt)
    assert_parity(got, ref, db=1e-3, dx=1e-4)
    np.testing.assert_allclose(got.x_rgb.numpy(), np.asarray(ref.x_rgb), atol=1e-3)
    assert (got.opt_state is None) == (case == "menon2007")
    if case == "menon2007":
        return
    (jprior, variables), (tprior, params) = ffdnet
    e2e = reconstruct_single_dispatch(
        jnp.asarray(sc.meas), jnp.asarray(sc.mask), GapTVConfig(iters=5),
        ADMMConfig(**kw, adapt=AdaptConfig(**adapt)), jprior, variables,
        orig=jnp.asarray(sc.orig_bayer))
    tgot = tend.reconstruct_single_dispatch(
        sc.meas, sc.mask, tgap.GapTVConfig(iters=5),
        tadmm.ADMMConfig(**kw, adapt=TAdaptConfig(**adapt)), tprior, params,
        orig=sc.orig_bayer, device="cpu")
    assert_parity(tgot, e2e, db=1e-3, dx=1e-4)


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("denoiser", ["ffdnet", "fastdvd"])
@pytest.mark.parametrize("name", scenes.SCENE_NAMES)
def test_scene_tables_match_jax(name, denoiser, deep):
    table, ttable = ((scenes.FFDNET_SCENES, tscenes.FFDNET_SCENES) if denoiser == "ffdnet"
                     else (scenes.FASTDVD_SCENES, tscenes.FASTDVD_SCENES))
    assert dataclasses.asdict(ttable[name][deep]) == dataclasses.asdict(table[name][deep])
    want, got = scenes.admm_config_for(name, denoiser, deep), tscenes.admm_config_for(name, denoiser, deep)
    for f in dataclasses.fields(got):
        # the kernel switch is JAX's use_pallas under the port's name
        mine = getattr(got, f.name)
        theirs = getattr(want, "use_pallas" if f.name == "use_kernels" else f.name)
        if f.name == "adapt":
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        else:
            assert mine == theirs, f.name
    assert (got.rho, got.tau, got.alpha) == (want.rho, want.tau, want.alpha)
    assert (tscenes.WARM_START_ITERS, tscenes.GUARD_HOLDOUT, tscenes.GUARDED_ROWS) == \
        (scenes.WARM_START_ITERS, scenes.GUARD_HOLDOUT, scenes.GUARDED_ROWS)


def deep_row(h, iters, interval):
    """The Bosphorus deep-demosaicking FastDVDnet row, its schedule cut to
    ``iters`` and its trigger moved to ``interval``, for both packages."""
    def cut(cfg, adapt_cls):
        return dataclasses.replace(
            cfg, iters=iters, adapt=adapt_cls(**{**dataclasses.asdict(cfg.adapt),
                                                 "interval_iter": interval}))

    want = cut(scenes.admm_config_for("Bosphorus", "fastdvd", True), AdaptConfig)
    got = cut(tscenes.admm_config_for("Bosphorus", "fastdvd", True), TAdaptConfig)
    assert got.select_best and got.select_best_holdout == 0.05 and got.demosaic_method == "ddnet"
    return want, got


def run_row_both(monkeypatch, ddnet_vars, h, iters, interval):
    """The row end to end (GAP-TV 40, the guarded ADMM with DDnet and
    FastDVDnet, noise off) in both packages on ``make_scene(8, h, h, 42)``."""
    monkeypatch.setattr(tadmm, "holdout_mask", jax_mask)
    sc = make_scene(b=8, h=h, w=h, seed=42)
    (jprior, variables), (tprior, params) = fastdvd_pair()
    want_cfg, got_cfg = deep_row(h, iters, interval)
    ref = reconstruct_single_dispatch(
        jnp.asarray(sc.meas), jnp.asarray(sc.mask), GapTVConfig(iters=40), want_cfg, jprior,
        variables, orig=jnp.asarray(sc.orig_bayer),
        demosaic_fn=ddnet_demosaic(DDnet(), ddnet_vars))
    got = tend.reconstruct_single_dispatch(
        sc.meas, sc.mask, tgap.GapTVConfig(iters=40), got_cfg, tprior, params,
        orig=sc.orig_bayer, device="cpu",
        demosaic_fn=tddnet_demosaic(TDDnet(), tconvert.ddnet_from_flax(ddnet_vars)))
    x0 = np.array(gap_tv(jnp.asarray(sc.meas), jnp.asarray(sc.mask),
                         GapTVConfig(iters=40)).x_bayer)
    pick, gap = assert_same_pick(got, ref, sc, x0)
    p_gap, x_gap = assert_parity(got, ref)
    return pick, gap, p_gap, x_gap


def test_deep_demosaicking_row_matches_jax(monkeypatch, ddnet_vars):
    """The slice end to end at 32x32x8: sigma (8, 6)/255 x (4, 2), trigger at
    k = 3, the held-out guard."""
    run_row_both(monkeypatch, ddnet_vars, 32, (4, 2), 3)


@pytest.mark.slow
def test_deep_demosaicking_row_256_parity_with_jax(monkeypatch, ddnet_vars):
    """The Bosphorus deep-demosaicking row as the scene table builds it, at
    256x256x8 in float32: sigma (8, 6)/255 x (24, 12), the trigger at k = 25,
    the held-out guard; DDnet and FastDVDnet with their trained weights."""
    pick, gap, p_gap, x_gap = run_row_both(monkeypatch, ddnet_vars, 256, (24, 12), 25)
    print(f"pick {pick}, residual gap {gap:.3e}, dPSNR {p_gap:.2e} dB, max |dx| {x_gap:.2e}")
