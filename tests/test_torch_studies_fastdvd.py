"""The FastDVDnet tools among the A/B, sweep and decomposition ports against
the JAX library calls that their scripts make, on the CPU at 32x32x8 with
the schedules cut: ``decompose_fastdvd_floor``, ``bench_fastdvd_bf16``,
``sweep_fidelity``, ``ab_cv_guard``, ``ab_weight_select`` and
``sweep_fastdvd_relax``, each through its row function.

Both packages get the same numpy scenes and ``weights/fastdvd.npz`` /
``weights/fastdvd_smooth.npz`` (bridged); every port configuration goes to
JAX field by field (``test_torch_studies.to_jax``). JAX's held-out mask and
part A's cube are injected; FastDVDnet's adaptation noise is off on both
sides (each package draws it from its own generator). The guard, weight
and relax rows run with fixed weights, the two adaptive rows with one
trigger.

Bars (FastDVDnet in bf16 on both sides, as the tools run it): max
|dx_bayer| 1e-2 and per-frame PSNR within 5e-2 dB; part A's three chained
denoiser applies max |dx| 1e-2; the held-out residuals within 1e-2
relative; the same guard picks, selections and best r. The bf16 model's
own bar is max 1e-2 on one apply (``tests/test_torch_fastdvdnet.py``: the
port folds BatchNorm into one float32 scale and shift, Flax rounds to bf16
after every op), and the loop carries it on. Found: part A 2.9e-3, part C
6.3e-3; the two adaptive rows 3.5e-2 / 2.7e-2 dB, 6.2e-3 / 4.5e-3 in x
(the adaptation's gradient is a bf16 backward); the guard rows <= 8.9e-4
dB, 4.1e-3; the residuals 3.7e-3 relative; the relax arms 1.8e-4 dB.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch import ab_cv_guard as tcvg
from adaptivepnp_sci_torch import ab_weight_select as twsel
from adaptivepnp_sci_torch import bench_fastdvd_bf16 as tbench
from adaptivepnp_sci_torch import decompose_flagship_floor as tdec
from adaptivepnp_sci_torch import studies
from adaptivepnp_sci_torch import sweep_fastdvd_relax as trelax
from adaptivepnp_sci_torch import sweep_fidelity as tfid
from adaptivepnp_sci_torch.configs.scenes import FASTDVD_SCENES, admm_config_for
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet as TFastDVDnet
from adaptivepnp_sci_torch.run_all_scenes import _make_scene_data
from adaptivepnp_sci_torch.solvers import priors as tpriors
from adaptivepnp_sci_torch.solvers import two_stage_admm as tadmm
from adaptivepnp_sci_tpu import pipelines as jpipe
from adaptivepnp_sci_tpu.data.mat_io import SceneData
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_tpu.ops import metrics
from adaptivepnp_sci_tpu.solvers import GapTVConfig, gap_tv
from adaptivepnp_sci_tpu.solvers.end_to_end import reconstruct_single_dispatch
from adaptivepnp_sci_tpu.solvers.priors import fastdvd_prior
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz
from test_torch_solver_modes import jax_mask
from test_torch_studies import jin, to_jax
from test_torch_weight_tools import ROOT

jadmm = importlib.import_module("adaptivepnp_sci_tpu.solvers.two_stage_admm")
DB, DX, RESID_RTOL = 5e-2, 1e-2, 1e-2
FIXED = studies.fastdvd_config(adapt=None, iters=(2, 1))
#: one trigger, at k = 2
ADAPT = studies.fastdvd_config(iters=(2, 1), adapt=dataclasses.replace(
    studies.FASTDVD_ADAPT, interval_iter=2))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def quiet(prior):
    return prior._replace(adapt_noise_std=0.0)


@pytest.fixture(scope="module")
def weights():
    nat = load_variables_npz(str(ROOT / "weights" / "fastdvd.npz"))
    smooth = load_variables_npz(str(ROOT / "weights" / "fastdvd_smooth.npz"))
    return {"natural": (nat, tconvert.fastdvdnet_from_flax(nat)),
            "smooth": (smooth, tconvert.fastdvdnet_from_flax(smooth))}


@pytest.fixture(scope="module")
def suite_priors():
    """The six-scene run's mode: bf16 DenBlocks without recomputation."""
    return (quiet(fastdvd_prior(FastDVDnet(dtype=jnp.bfloat16, remat=False))),
            quiet(tpriors.fastdvd_prior(TFastDVDnet(dtype=torch.bfloat16, remat=False))))


@pytest.fixture(scope="module")
def scene():
    return make_scene(b=8, h=32, w=32, seed=42)


def close(got, ref, db=DB, dx=DX):
    p = float(np.abs(np.asarray(got.psnr_per_frame) - np.asarray(ref.psnr_per_frame)).max())
    x = float(np.abs(np.asarray(got.x_bayer) - np.asarray(ref.x_bayer)).max())
    print(f"{p:.3e} dB, max |dx| {x:.3e}")
    assert p <= db and x <= dx, (p, x)


def test_decompose_fastdvd_matches_jax(scene, weights, suite_priors, monkeypatch):
    (v, params), (jprior, tprior) = weights["natural"], suite_priors
    cube = jax.random.uniform(jax.random.PRNGKey(0), (8, 32, 32, 3), jnp.float32)
    monkeypatch.setattr(tdec, "draw_cube", lambda shape: torch.from_numpy(np.array(cube)))
    d = tdec.decompose(scene, tprior, params, FIXED, None, "cpu", n=0)
    assert d["iters"] == 3 and "D" not in d
    sigmas = jnp.asarray([12 / 255] * 2 + [6 / 255], jnp.float32)
    want_a, _ = jax.lax.scan(lambda c, s: (jprior.apply(v, c, s), None), cube, sigmas)
    dx = float(np.abs(d["A_out"].numpy() - np.asarray(want_a)).max())
    print(f"A: max |dx| {dx:.3e}")
    assert dx <= DX
    y, phi, _ = jin(scene)
    identity = jprior._replace(apply=lambda v, x, s: x)
    for key, pr in (("B", identity), ("C", jprior)):
        want = reconstruct_single_dispatch(y, phi, GapTVConfig(iters=40), to_jax(FIXED), pr, v)
        dx = float(np.abs(d[f"{key}_out"].numpy() - np.asarray(want.x_bayer)).max())
        print(f"{key}: max |dx| {dx:.3e}")
        assert dx <= DX


def test_adaptive_rows_match_jax(scene, weights, monkeypatch):
    """``bench_fastdvd_bf16``'s bf16 row and a ``sweep_fidelity`` row (a
    per-stage relax with the strong adaptation), one trigger each."""
    v, params = weights["natural"]
    build = tpriors.fastdvd_prior
    monkeypatch.setattr(tpriors, "fastdvd_prior", lambda *a, **k: quiet(build(*a, **k)))
    y, phi, orig = jin(scene)
    jprior = quiet(fastdvd_prior(FastDVDnet(dtype=jnp.bfloat16)))
    _, got = tbench.fastdvd_row(scene, TFastDVDnet(dtype=torch.bfloat16), params, ADAPT,
                                "cpu", n=0)
    close(got, reconstruct_single_dispatch(y, phi, GapTVConfig(iters=40), to_jax(ADAPT), jprior,
                                           v, orig=orig))
    strong = dataclasses.replace(tfid.STRONG_ADAPT, interval_iter=2)
    _, got = tfid.fidelity_row(scene, quiet(build(TFastDVDnet(dtype=torch.bfloat16))), params,
                               (0.7, 1.0), strong, "cpu", iters=(2, 1))
    cfg = studies.fastdvd_config(adapt=strong, iters=(2, 1), denoiser_relax=(0.7, 1.0))
    close(got, reconstruct_single_dispatch(y, phi, GapTVConfig(iters=40), to_jax(cfg), jprior,
                                           v, orig=orig))
    labels = [r[0] for r in tfid.runs({"shipped": 0, "crop96": 0})]
    assert len(labels) == 7 and labels[0] == "shipped: baseline (ref adapt, relax=1)"


def test_ab_cv_guard_row_matches_jax(weights, suite_priors, monkeypatch):
    monkeypatch.setattr(tadmm, "holdout_mask", jax_mask)
    (v, params), (jprior, tprior) = weights["natural"], suite_priors
    seed, style = tcvg.PAIRS[0]
    sc = make_scene(b=8, h=32, w=32, seed=seed, style=style)
    warm_db, arms = tcvg.guard_row(sc, tprior, params, FIXED, "cpu")
    y, phi, orig = jin(sc)
    warm = gap_tv(y, phi, GapTVConfig(iters=40))
    assert abs(warm_db - float(metrics.psnr(orig, warm.x_bayer))) <= DB
    for (tag, guard, hf), (got_tag, p, _, got) in zip(tcvg.GUARDS, arms):
        cfg = dataclasses.replace(FIXED, select_best=guard, select_best_holdout=hf)
        ref = jadmm.two_stage_admm(y, phi, to_jax(cfg), jprior, v, warm.x_bayer,
                                   orig_bayer=orig)
        assert got_tag == tag and p == float(got.psnr_per_frame.mean())
        close(got, ref)


def test_ab_weight_select_row_matches_jax(weights, suite_priors, monkeypatch):
    monkeypatch.setattr(tadmm, "holdout_mask", jax_mask)
    jprior, tprior = suite_priors
    sched, seed = twsel.STYLES["smooth"]
    sc = make_scene(b=8, h=32, w=32, seed=seed, style="smooth")
    row = FASTDVD_SCENES[sched][False]
    cfg = tadmm.ADMMConfig(sigma=row.sigma, iters=studies.cut_iters(row.iters, 2),
                           denoiser="fastdvd", select_best=True)
    resids, pick, psnrs, oracle, agree, _ = twsel.select_row(
        sc, tprior, {k: weights[k][1] for k in twsel.WEIGHTS}, cfg, "cpu")
    y, phi, orig = jin(sc)
    x0 = gap_tv(y, phi, GapTVConfig(iters=40)).x_bayer
    want_r = jpipe.holdout_cv_residuals(
        y, phi, x0, [dict(config=to_jax(cfg), prior=jprior, variables=weights[k][0])
                     for k in twsel.WEIGHTS])
    want_p = [float(jadmm.two_stage_admm(y, phi, to_jax(cfg), jprior, weights[k][0], x0,
                                         orig_bayer=orig).psnr_per_frame.mean())
              for k in twsel.WEIGHTS]
    print(f"residuals {resids} / {want_r}, dB {psnrs} / {want_p}")
    np.testing.assert_allclose(resids, want_r, rtol=RESID_RTOL)
    np.testing.assert_allclose(psnrs, want_p, atol=DB)
    assert pick == twsel.WEIGHTS[int(want_r[1] < want_r[0])]
    assert oracle == twsel.WEIGHTS[int(want_p[1] > want_p[0])]
    assert agree == (want_p[twsel.WEIGHTS.index(pick)] >= max(want_p) - 0.01)


def test_sweep_fastdvd_relax_row_matches_jax(weights, suite_priors, monkeypatch):
    """Two relax arms and the best r with the held-out guard, through the
    pipelines of both packages, on the Bosphorus stand-in with fixed weights."""
    monkeypatch.setattr(tadmm, "holdout_mask", jax_mask)
    (v, params), (jprior, tprior) = weights["natural"], suite_priors
    _, tsc = _make_scene_data("Bosphorus", 8, 32, 32, 1)
    jsc = SceneData(name=tsc.name, meas=tsc.meas, mask=tsc.mask, orig_bayer=tsc.orig_bayer,
                    orig_real=tsc.orig_real)
    cfg = admm_config_for("Bosphorus", "fastdvd", False, False)
    cfg = dataclasses.replace(cfg, iters=studies.cut_iters(cfg.iters, 2))
    warm_db, results, best_r, guarded, _ = trelax.relax_row(tsc, tprior, params, cfg, "cpu",
                                                            relaxes=(1.0, 0.5))
    warm = jpipe.run_warm_start(jsc)
    assert abs(warm_db - float(warm.psnr.mean())) <= DB

    def jax_db(c):
        out = jpipe.run_reconstruction(jsc, jprior, v, denoiser="fastdvd",
                                       warm_start=warm.x_bayer, config=to_jax(c))
        return float(out.psnr.mean())

    want = {r: jax_db(dataclasses.replace(cfg, denoiser_relax=r, select_best=False))
            for r in (1.0, 0.5)}
    print(f"relax {results} / {want}")
    assert max(abs(results[r] - want[r]) for r in want) <= DB
    assert best_r == max(want, key=want.get)
    want_g = jax_db(dataclasses.replace(cfg, denoiser_relax=best_r, select_best=True))
    assert abs(guarded - want_g) <= DB
