"""Port ``pipelines`` vs the JAX package on the CPU: ``run_reconstruction``
(the carried weights and Adam state with ``reuse_model``, a fresh start per
measurement without it, the inline warm start, tiles with overlap, DDnet
adapted once per measurement and in the scan, the adaptation crop),
``run_warm_start`` (GAP-TV and GAP with a deep prior), the selection
functions, and the adapted state on disk.

Both packages get the same numpy scene (16x16, B = 4, two measurements) and
weights (FFDNet nc 8, nb 3 from Flax's init, bridged; DDnet
``weights/ddnet.npz``). Random draws are injected: JAX's hold-out mask
(``holdout_mask`` patched) and JAX's crop offsets (``crop_offsets`` patched,
from the ``PRNGKey(t)`` JAX gives measurement ``t``). Each JAX run happens
once per module.
Bar: per-frame PSNR within 1e-3 dB and max |dx_bayer| <= 1e-4 in float32;
adapted weights within 5 % of lr of JAX's; the same picks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch import pipelines as tpipe
from adaptivepnp_sci_torch.adapt import online as tonline
from adaptivepnp_sci_torch.data.mat_io import SceneData as TSceneData
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.ddnet import DDnet as TDDnet
from adaptivepnp_sci_torch.solvers import two_stage_admm as tadmm
from adaptivepnp_sci_tpu import pipelines as jpipe
from adaptivepnp_sci_tpu.adapt.online import AdaptConfig
from adaptivepnp_sci_tpu.data.mat_io import SceneData
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models.ddnet import DDnet
from adaptivepnp_sci_tpu.solvers import ADMMConfig, GapTVConfig, gap_tv
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz
from test_torch_solver_modes import jax_mask
from test_torch_solvers import ffdnet_pair

LR = 1e-4
ADAPT = dict(lr=LR, update_per_iter=1, interval_iter=2, initial_iter=0)
KW = dict(sigma=(25 / 255,), iters=(4,))
CROP = 8
DB, DX = 1e-3, 1e-4

#: name -> (adapt overrides, config overrides, run_reconstruction kwargs);
#: ``warm``: the GAP-TV warm start passed in (else computed inline)
CASES = {
    "reuse_carried_crop": (dict(fresh_opt_per_trigger=False, crop=CROP), {},
                           dict(reuse_model=True)),
    "no_reuse": ({}, {}, dict(reuse_model=False, warm=True)),
    "tile_overlap": ({}, {}, dict(tile=8, tile_overlap=4, tile_chunk=2, warm=True)),
    "dm_once": ({}, dict(demosaic_method="ddnet"), dict(dm_update=True, warm=True)),
    "dm_in_scan": ({}, dict(demosaic_method="ddnet"),
                   dict(dm_update=True, dm_in_scan=True, warm=True)),
}


def jax_crop_draws(n_meas, triggers, h, w, c):
    """The crop offsets JAX draws: measurement t's key is ``PRNGKey(t)``,
    split twice per trigger (no adaptation noise with FFDNet)."""
    out = []
    for t in range(n_meas):
        key = jax.random.PRNGKey(t)
        for _ in range(triggers):
            key, sub = jax.random.split(key)
            oy = int(jax.random.randint(sub, (), 0, (h - c) // 2 + 1)) * 2
            key, sub = jax.random.split(key)
            ox = int(jax.random.randint(sub, (), 0, (w - c) // 2 + 1)) * 2
            out.append((oy, ox))
    return out


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(4)
    s = make_scene(b=4, h=16, w=16, seed=2, n_meas=2)
    meas = np.transpose(s.meas, (2, 0, 1)).astype(np.float32)
    jscene = SceneData("synth", meas, s.mask, s.orig_bayer)
    tscene = TSceneData("synth", meas, s.mask, s.orig_bayer)
    warm = np.stack([np.asarray(gap_tv(jnp.asarray(meas[t]), jnp.asarray(s.mask),
                                       GapTVConfig(iters=10)).x_bayer) for t in range(2)])
    dd_vars = load_variables_npz("weights/ddnet.npz")
    return jscene, tscene, warm, ffdnet_pair(nc=8, nb=3), dd_vars


def _configs(adapt_over, cfg_over):
    jcfg = ADMMConfig(**KW, adapt=AdaptConfig(**ADAPT, **adapt_over), **cfg_over)
    tcfg = tadmm.ADMMConfig(**KW, adapt=tonline.AdaptConfig(**ADAPT, **adapt_over), **cfg_over)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_runs(setup):
    jscene, _, warm, ((jprior, variables), _), dd_vars = setup
    out = {}
    for name, (adapt_over, cfg_over, kw) in CASES.items():
        kw = dict(kw)
        jcfg, _ = _configs(adapt_over, cfg_over)
        if kw.pop("warm", False):
            kw["warm_start"] = warm
        if kw.get("dm_update"):
            kw.update(dm_model=DDnet(), dm_variables=dd_vars, dm_lr=1e-5)
        out[name] = jpipe.run_reconstruction(jscene, jprior, variables, config=jcfg, **kw)
    return out


def assert_outputs_close(got, ref):
    dp = float(np.abs(got.psnr - ref.psnr).max())
    dx = float(np.abs(got.x_bayer - ref.x_bayer).max())
    print(f"parity: dPSNR {dp:.2e} dB, max |dx_bayer| {dx:.2e}")
    assert got.x_bayer.shape == ref.x_bayer.shape and np.isfinite(got.x_bayer).all()
    assert dp <= DB and dx <= DX, (dp, dx)
    np.testing.assert_allclose(got.x_rgb, ref.x_rgb, atol=10 * DX)
    np.testing.assert_allclose(got.psnr_all_iter, ref.psnr_all_iter, atol=DB)
    assert len(got.seconds_per_meas) == len(ref.seconds_per_meas)


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_reconstruction_matches_jax(setup, jax_runs, name, monkeypatch):
    _, tscene, warm, (_, (tprior, params)), dd_vars = setup
    adapt_over, cfg_over, kw = CASES[name]
    kw = dict(kw)
    _, tcfg = _configs(adapt_over, cfg_over)
    if kw.pop("warm", False):
        kw["warm_start"] = warm
    if kw.get("dm_update"):
        kw.update(dm_model=TDDnet(), dm_variables=tconvert.ddnet_from_flax(dd_vars), dm_lr=1e-5)
    draws = jax_crop_draws(2, 1, 16, 16, CROP)

    def crop_offsets(generator, h, w, c):
        assert (h, w, c) == (16, 16, CROP) and generator is not None
        return draws.pop(0)

    monkeypatch.setattr(tonline, "crop_offsets", crop_offsets)
    got = tpipe.run_reconstruction(tscene, tprior, params, config=tcfg, device="cpu", **kw)
    ref = jax_runs[name]
    assert_outputs_close(got, ref)
    if "crop" in adapt_over:
        assert draws == []  # one crop per trigger, one trigger per measurement
    # the weights that come back: adapted and carried, or (no reuse) the last
    # measurement's own; within 5 % of lr of JAX's
    mine = tconvert.ffdnet_to_flax(got.variables)["params"]
    for lname, p in ref.variables["params"].items():
        for leaf in ("kernel", "bias"):
            diff = np.abs(mine[lname][leaf] - np.asarray(p[leaf])).max()
            assert diff <= 0.05 * LR, (lname, leaf, diff / LR)
    if kw.get("dm_update"):
        dd = tconvert.ddnet_to_flax(got.dm_variables)["params"]
        far = [np.mean(np.abs(a - np.asarray(b)) > 0.05 * 1e-5) for a, b in zip(
            jax.tree_util.tree_leaves(dd), jax.tree_util.tree_leaves(ref.dm_variables["params"]))]
        assert max(far) <= 0.01, max(far)
    else:
        assert got.dm_variables is None and ref.dm_variables is None


def test_run_warm_start_matches_jax(setup):
    jscene, tscene, _, ((jprior, variables), (tprior, params)), _ = setup
    for kw in (dict(iters=6), dict(iters=4, denoiser="ffdnet", sigma=(25 / 255, 12 / 255))):
        ref = jpipe.run_warm_start(jscene, prior=jprior, variables=variables, **kw)
        got = tpipe.run_warm_start(tscene, prior=tprior, variables=params, device="cpu", **kw)
        assert got.x_rgb is None and got.variables is None
        assert float(np.abs(got.psnr - ref.psnr).max()) <= DB
        np.testing.assert_allclose(got.x_bayer, ref.x_bayer, atol=DX)
        np.testing.assert_allclose(got.psnr_all_iter, ref.psnr_all_iter, atol=DB)
    with pytest.raises(ValueError, match="prior"):
        tpipe.run_warm_start(tscene, denoiser="ffdnet", device="cpu")


def test_selection_makes_jax_picks(setup, monkeypatch):
    """``select_demosaicker`` and ``select_prior_variables`` rank by the same
    held-out residuals as JAX (its mask injected) and make its picks."""
    monkeypatch.setattr(tadmm, "holdout_mask", jax_mask)
    jscene, tscene, warm, ((jprior, variables), (tprior, params)), dd_vars = setup
    jcfg, tcfg = _configs({}, {})
    x0 = warm[0]
    ref = jpipe.probe_demosaic_residuals(jscene.meas[0], jscene.mask, x0, jprior, variables,
                                         DDnet(), dd_vars, jcfg, jcfg)
    got = tpipe.probe_demosaic_residuals(tscene.meas[0], tscene.mask, x0, tprior, params,
                                         TDDnet(), tconvert.ddnet_from_flax(dd_vars), tcfg, tcfg,
                                         device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got[0] != got[1]
    pick = tpipe.select_demosaicker(tscene, tprior, params, TDDnet(),
                                    tconvert.ddnet_from_flax(dd_vars), warm_start=warm,
                                    config_malvar=tcfg, config_ddnet=tcfg, device="cpu")
    assert pick == ("malvar" if ref[0] <= ref[1] else "ddnet")

    bad = jax.tree_util.tree_map(lambda p: p * 50.0 + 3.0, variables)
    cands = [dict(config=jcfg, prior=jprior, variables=v) for v in (variables, bad)]
    ref = jpipe.holdout_cv_residuals(jscene.meas[0], jscene.mask, x0, cands)
    tcands = [dict(config=tcfg, prior=tprior, variables=tconvert.ffdnet_from_flax(v))
              for v in (variables, bad)]
    got = tpipe.holdout_cv_residuals(tscene.meas[0], tscene.mask, x0, tcands, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    pick = tpipe.select_prior_variables(
        tscene, tprior, {"good": params, "bad": tconvert.ffdnet_from_flax(bad)}, config=tcfg,
        warm_start=warm, device="cpu")
    assert pick == ["good", "bad"][int(np.argmin(ref))] == "good"


def test_ddnet_row_without_demosaicker_is_refused(setup):
    """JAX falls back to Malvar silently; the port refuses."""
    _, tscene, warm, (_, (tprior, params)), _ = setup
    _, tcfg = _configs({}, dict(demosaic_method="ddnet"))
    with pytest.raises(ValueError, match="demosaic_fn"):
        tpipe.run_reconstruction(tscene, tprior, params, config=tcfg, warm_start=warm,
                                 device="cpu")


def test_crop_refusals_match_jax(setup):
    _, tscene, warm, (_, (tprior, params)), _ = setup
    for crop, msg in ((7, "even"), (18, "exceeds")):
        _, tcfg = _configs(dict(crop=crop), {})
        with pytest.raises(ValueError, match=msg):
            tpipe.run_reconstruction(tscene, tprior, params, config=tcfg, warm_start=warm,
                                     device="cpu")


def test_adapted_state_roundtrip(setup, tmp_path):
    _, tscene, warm, (_, (tprior, params)), _ = setup
    _, tcfg = _configs(dict(fresh_opt_per_trigger=False), {})
    res = tadmm.two_stage_admm(tscene.meas[0], tscene.mask, tcfg, tprior, params, warm[0],
                               device="cpu")
    path = str(tmp_path / "adapted.pt")
    tpipe.save_adapted_state(path, res.variables, res.opt_state)
    variables, opt_state = tpipe.load_adapted_state(path, params)
    assert variables.keys() == res.variables.keys()
    for k, v in res.variables.items():
        assert torch.equal(variables[k], v)
    assert opt_state["param_groups"] == res.opt_state["param_groups"]
    for i, st in res.opt_state["state"].items():
        for k, v in st.items():
            assert torch.equal(opt_state["state"][i][k], v)
    # the loaded state continues adaptation exactly as the in-memory one
    a = tadmm.two_stage_admm(tscene.meas[1], tscene.mask, tcfg, tprior, res.variables, warm[1],
                             device="cpu", opt_state=res.opt_state)
    b = tadmm.two_stage_admm(tscene.meas[1], tscene.mask, tcfg, tprior, variables, warm[1],
                             device="cpu", opt_state=opt_state)
    assert torch.equal(a.x_bayer, b.x_bayer)
    tpipe.save_adapted_state(path, params)
    assert tpipe.load_adapted_state(path)[1] is None
    with pytest.raises(ValueError, match="names"):
        tpipe.load_adapted_state(path, {"other": torch.zeros(1)})
