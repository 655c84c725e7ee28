"""The FFDNet tools among the A/B, sweep and decomposition ports against the
JAX library calls that their scripts make, on the CPU at 32x32x8 with the
schedules cut (``ab_ffdnet_precision`` is held in
``tests/test_torch_precision.py``, the FastDVDnet tools in
``tests/test_torch_studies_fastdvd.py``).

Both packages get the same numpy scene, FFDNet weights from Flax's init at
nc 16, nb 4 (bridged) and ``weights/ddnet.npz``; every port configuration
goes to JAX field by field (:func:`to_jax`: ``use_kernels`` is JAX's
``use_pallas``), so the JAX side runs what the tool builds. JAX's draws are
injected: the held-out mask (``two_stage_admm.holdout_mask``), part A's
cube (``decompose_flagship_floor.draw_cube``) and the power iteration's
start and the noise (``eval_weights.draw_normal``). FFDNet draws nothing
in its adaptation.

Bars, float32: per-frame PSNR within 1e-3 dB and max |dx_bayer| 1e-4 (the
earlier slices' solver bar); the held-out residuals within 1e-4 relative,
the same picks; sigma_max and the teacher-student distance within 1e-5
relative; the FLOPs that ``FlopCounterMode`` counts within 1 % of XLA's
cost analysis once its padded taps are taken out (XLA counts only the taps
that fall inside the image). With DDnet in bf16 (``ab_demosaic_select``)
the PSNR bar is 1e-2 dB and max |dx| 1e-2 (bf16 roundings).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch import ab_ddnet_precision as tddp
from adaptivepnp_sci_torch import ab_demosaic_select as tdms
from adaptivepnp_sci_torch import ab_kernels_adapt as tkad
from adaptivepnp_sci_torch import bench_2048_adaptive as t2048
from adaptivepnp_sci_torch import decompose_flagship_floor as tdec
from adaptivepnp_sci_torch import diag_teacher_sigma as tdiag
from adaptivepnp_sci_torch import eval_teacher_inloop as tinl
from adaptivepnp_sci_torch import eval_weights as tew
from adaptivepnp_sci_torch import studies
from adaptivepnp_sci_torch.configs.scenes import FFDNET_SCENES
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.ddnet import DDnet as TDDnet
from adaptivepnp_sci_torch.models.ffdnet import FFDNet as TFFDNet
from adaptivepnp_sci_torch.solvers import two_stage_admm as tadmm
from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior as tffdnet_prior
from adaptivepnp_sci_tpu import pipelines as jpipe
from adaptivepnp_sci_tpu.adapt.online import AdaptConfig
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models.ddnet import DDnet
from adaptivepnp_sci_tpu.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_tpu.models.ffdnet import FFDNet
from adaptivepnp_sci_tpu.solvers import ADMMConfig, GapTVConfig, gap_tv
from adaptivepnp_sci_tpu.solvers.end_to_end import reconstruct_single_dispatch
from adaptivepnp_sci_tpu.solvers.priors import ddnet_demosaic, ffdnet_prior
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz
from test_torch_solver_modes import jax_mask
from test_torch_weight_tools import ROOT, Jitted, jax_normal, load_script

jadmm = importlib.import_module("adaptivepnp_sci_tpu.solvers.two_stage_admm")
DB, DX, RESID_RTOL, REL = 1e-3, 1e-4, 1e-4, 1e-5
BF16_DB, BF16_DX = 1e-2, 1e-2
NC, NB = 16, 4
#: the flagship's schedule cut to 7 iterations, adaptation at k = 3 and 6
ITERS = (3, 2, 2)
FLAG = studies.flagship_config(iters=ITERS, adapt=dataclasses.replace(
    studies.FLAGSHIP_ADAPT, interval_iter=3))
FIXED = studies.flagship_config(adapt=None, iters=ITERS)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def to_jax(cfg):
    """A port ``ADMMConfig`` / ``GapTVConfig`` as JAX's, field by field."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["use_pallas"] = d.pop("use_kernels")
    if "adapt" not in d:
        return GapTVConfig(**d)
    if d["adapt"] is not None:
        d["adapt"] = AdaptConfig(**dataclasses.asdict(d["adapt"]))
    return ADMMConfig(**d)


@pytest.fixture(scope="module")
def setup():
    scene = make_scene(b=8, h=32, w=32, seed=42)
    model = FFDNet(nc=NC, nb=NB)
    v = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.float32(0.1)))
    return scene, ffdnet_prior(model), v, tffdnet_prior(TFFDNet(nc=NC, nb=NB)), \
        tconvert.ffdnet_from_flax(v)


@pytest.fixture(scope="module")
def ddnet_vars():
    return load_variables_npz(str(ROOT / "weights" / "ddnet.npz"))


def jin(scene):
    return jnp.asarray(scene.meas), jnp.asarray(scene.mask), jnp.asarray(scene.orig_bayer)


def jrecon(scene, cfg, prior, variables, wcfg=studies.WARM, **kw):
    y, phi, orig = jin(scene)
    return reconstruct_single_dispatch(y, phi, to_jax(wcfg), to_jax(cfg), prior, variables,
                                       orig=orig, **kw)


def close(got, ref, db=DB, dx=DX):
    """Per-frame PSNR within ``db``, max |dx_bayer| within ``dx``."""
    p = float(np.abs(got.psnr_per_frame.numpy() - np.asarray(ref.psnr_per_frame)).max())
    x = float(np.abs(got.x_bayer.numpy() - np.asarray(ref.x_bayer)).max())
    print(f"{p:.3e} dB, max |dx| {x:.3e}")
    assert p <= db and x <= dx, (p, x)
    return p, x


def x_close(got, ref, dx=DX):
    x = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    print(f"max |dx| {x:.3e}")
    assert x <= dx, x
    return x


def test_ab_kernels_adapt_rows_match_jax(setup, tmp_path, capsys):
    scene, jprior, v, tprior, params = setup
    assert tkad.kernel_arms("cpu") == (False,)
    [(_, got)] = tkad.gap_tv_row(scene, "cpu", n=0)
    y, phi, orig = jin(scene)
    close(got, gap_tv(y, phi, GapTVConfig(iters=40, use_pallas=False), orig_bayer=orig))
    for cfg in (FIXED, FLAG):
        [(_, got)] = tkad.admm_row(scene, cfg, tprior, params, "cpu", n=0)
        close(got, jrecon(scene, dataclasses.replace(cfg, use_kernels=False), jprior, v,
                          dataclasses.replace(studies.WARM, use_kernels=False)))
    carried, fresh = tkad.adam_row(scene, FLAG, tprior, params, "cpu", n=0)
    for (_, got), f in ((carried, False), (fresh, True)):
        close(got, jrecon(scene, studies.with_adapt(FLAG, fresh_opt_per_trigger=f), jprior, v))
    # the table: only the plain column on the CPU, a file only when asked for
    out = tmp_path / "ab.md"
    rows = tkad.main(params, str(out), 16, "cpu", TFFDNet(nc=NC, nb=NB), FIXED, FLAG,
                     fastdvd_weights=str(tmp_path / "absent.npz"), n=0)
    assert [r[:2] for r in rows] == [("1. GAP-TV (40 it)", "plain"),
                                     ("2. ADMM+FFDNet fixed", "plain"),
                                     ("4. flagship adaptive", "plain"),
                                     ("flagship FFDNet", "carried"), ("flagship FFDNet", "fresh")]
    text = out.read_text()
    assert text.count("n/a (CPU)") == 6 and len(text.splitlines()) == 16
    assert text.startswith("# A/B results (CPU, 16x16x8") and text in capsys.readouterr().out


def test_decompose_flagship_matches_jax(setup, monkeypatch):
    scene, jprior, v, tprior, params = setup
    cube = jax.random.uniform(jax.random.PRNGKey(0), (8, 32, 32, 3), jnp.float32)
    monkeypatch.setattr(tdec, "draw_cube", lambda shape: torch.from_numpy(np.array(cube)))
    d = tdec.decompose(scene, tprior, params, FIXED, FLAG, "cpu", n=0)
    assert d["iters"] == 7 and all(d[k] > 0 for k in "ABCD")
    sigmas = jnp.concatenate([jnp.full(n, s, jnp.float32) for s, n in zip(FIXED.sigma, ITERS)])
    want_a, _ = jax.lax.scan(lambda c, s: (jprior.apply(v, c, s), None), cube, sigmas)
    x_close(d["A_out"], want_a)
    identity = jprior._replace(apply=lambda v, x, s: x)
    for key, pr, cfg in (("B", identity, FIXED), ("C", jprior, FIXED), ("D", jprior, FLAG)):
        x_close(d[f"{key}_out"], jrecon(scene, cfg, pr, v).x_bayer)
    # one apply's FLOPs against XLA's cost analysis, its padded taps taken out
    net = TFFDNet(nc=NC, nb=NB)
    net.load_state_dict(params)
    gflop, gbytes = tdec.apply_cost(net.eval(), torch.from_numpy(np.array(cube)), 12 / 255)
    ca = jax.jit(lambda v, x: jprior.apply(v, x, jnp.float32(12 / 255))).lower(
        v, cube).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    inside = ((3 * 16 - 2) / (3 * 16)) ** 2  # 16 x 16 after space-to-depth
    assert abs(gflop * inside - ca["flops"] / 1e9) <= 1e-2 * ca["flops"] / 1e9
    convs = [(13, NC)] + [(NC, NC)] * (NB - 2) + [(NC, 12)]
    assert gbytes * 1e9 == sum(4 * (8 * 16 * 16 * (ci + co) + 9 * ci * co + co)
                               for ci, co in convs)


def test_ab_ddnet_precision_row_matches_jax(setup, ddnet_vars):
    scene, jprior, v, tprior, params = setup
    cfg = studies.flagship_config(adapt=None, iters=(2, 1, 1), demosaic_method="ddnet")
    _, got = tddp.ddnet_row(scene, tprior, params, TDDnet(),
                            tconvert.ddnet_from_flax(ddnet_vars), cfg, "cpu", n=0)
    close(got, jrecon(scene, cfg, jprior, v, demosaic_fn=ddnet_demosaic(DDnet(), ddnet_vars)))


def test_ab_demosaic_select_row_matches_jax(setup, ddnet_vars, monkeypatch):
    monkeypatch.setattr(tadmm, "holdout_mask", jax_mask)
    _, jprior, v, tprior, params = setup
    style, seed = tdms.SCENES["Jockey"]
    scene = make_scene(b=8, h=32, w=32, seed=seed, style=style)
    row, row_dd = FFDNET_SCENES["Jockey"][False], FFDNET_SCENES["Jockey"][True]
    cm = tadmm.ADMMConfig(sigma=row.sigma, iters=studies.cut_iters(row.iters, 2))
    cd = tadmm.ADMMConfig(sigma=row_dd.sigma, iters=studies.cut_iters(row_dd.iters, 2))
    got = tdms.demosaic_row(scene, tprior, params, TDDnet(dtype=torch.bfloat16),
                            tconvert.ddnet_from_flax(ddnet_vars), cm, cd, "cpu")
    y, phi, orig = jin(scene)
    x0 = gap_tv(y, phi, GapTVConfig(iters=40)).x_bayer
    dd = DDnet(dtype=jnp.bfloat16)
    r_m, r_d = jpipe.probe_demosaic_residuals(y, phi, x0, jprior, v, dd, ddnet_vars,
                                              to_jax(cm), to_jax(cd))
    full_m = jadmm.two_stage_admm(y, phi, to_jax(cm), jprior, v, x0, orig_bayer=orig)
    full_d = jadmm.two_stage_admm(y, phi, to_jax(dataclasses.replace(cd, demosaic_method="ddnet")),
                                  jprior, v, x0, orig_bayer=orig,
                                  demosaic_fn=ddnet_demosaic(dd, ddnet_vars))
    p_m, p_d = float(full_m.psnr_per_frame.mean()), float(full_d.psnr_per_frame.mean())
    print(f"residuals {got[:2]} / {(r_m, r_d)}, dB {got[3:5]} / {(p_m, p_d)}")
    np.testing.assert_allclose(got[:2], (r_m, r_d), rtol=RESID_RTOL)
    assert got[2] == ("malvar" if r_m <= r_d else "ddnet")
    assert abs(got[3] - p_m) <= DB and abs(got[4] - p_d) <= BF16_DB
    assert got[5] == ("malvar" if p_m >= p_d else "ddnet")


def test_bench_2048_tiled_row_matches_jax(setup):
    scene, jprior, v, tprior, params = setup
    assert [t2048.parse_combo(c) for c in ("4:", "4:256", "16:128", ":")] == \
        [(4, None), (4, 256), (16, 128), (None, None)]
    y, phi, orig = jin(scene)
    x0 = gap_tv(y, phi, GapTVConfig(iters=40)).x_bayer
    t_in = studies.on_device(scene, "cpu")
    _, got = t2048.tiled_row(*t_in, torch.from_numpy(np.array(x0)), tprior, params, FLAG, 16, 2,
                             "cpu")
    close(got, jadmm.two_stage_admm_tiled(y, phi, to_jax(FLAG), tile=16, prior=jprior,
                                          variables=v, orig_bayer=orig, x0_bayer=x0,
                                          tile_chunk=2))


def test_diag_teacher_sigma_matches_jax(setup, monkeypatch):
    """The teacher's and the student's sigma_max and their distance against
    the JAX script's computation (its ``FrameWise``, ``eval_weights``'
    ``sigma_max_eval``), on two 16x16 clips, JAX's draws injected."""
    _, _, v, _, params = setup
    clips = np.random.default_rng(7).random((2, 5, 16, 16, 3), dtype=np.float32)
    student = load_variables_npz(str(ROOT / "weights" / "fastdvd.npz"))
    monkeypatch.setattr(tew, "draw_normal", jax_normal)
    t_smax, [(_, s_smax, dist)] = tdiag.diagnose(
        tdiag.FrameWise(nc=NC, nb=NB), params, {"s": tconvert.state_dict_from_flax(student)},
        torch.from_numpy(clips))
    ffd, key, xc = FFDNet(nc=NC, nb=NB), jax.random.PRNGKey(0), jnp.asarray(clips)

    class FrameWise:
        @staticmethod
        @jax.jit
        def apply(variables, x, sigma):
            n, f, h, w, c = x.shape
            s = jnp.repeat(jnp.broadcast_to(sigma, (n,)), f)
            return ffd.apply(variables, x.reshape(n * f, h, w, c), s).reshape(n, f, h, w, c)

    sigma_max_eval = load_script("eval_weights").sigma_max_eval
    want_t = sigma_max_eval(FrameWise, v, xc, key)
    want_s = sigma_max_eval(Jitted(FastDVDnet()), student, xc, key)
    sig = jnp.full((2,), 20 / 255)
    noisy = xc + (20 / 255) * jax.random.normal(key, xc.shape)
    t_out = FrameWise.apply(v, noisy, sig)[:, 2]
    s_out = jax.jit(FastDVDnet().apply)(student, noisy, sig)
    want_d = float(jnp.sqrt(jnp.mean((t_out - s_out) ** 2)))
    print(f"teacher {t_smax:.6f} / {want_t:.6f}, student {s_smax:.6f} / {want_s:.6f}, "
          f"rms {dist:.7f} / {want_d:.7f}")
    for got, want in ((t_smax, want_t), (s_smax, want_s), (dist, want_d)):
        assert abs(got - want) <= REL * abs(want)


def test_eval_teacher_inloop_row_matches_jax(setup):
    scene, jprior, v, tprior, params = setup
    cfg = studies.fastdvd_config(iters=(3, 2), adapt=dataclasses.replace(
        studies.FASTDVD_ADAPT, interval_iter=2))
    warm_db, final_db, got = tinl.inloop_row(scene, tprior, params, cfg, "cpu")
    y, phi, orig = jin(scene)
    warm = gap_tv(y, phi, GapTVConfig(iters=40), orig_bayer=orig)
    ref = jadmm.two_stage_admm(y, phi, to_jax(cfg), jprior, v, warm.x_bayer, orig_bayer=orig)
    assert abs(warm_db - float(warm.psnr_per_frame.mean())) <= DB
    assert abs(final_db - float(ref.psnr_per_frame.mean())) <= DB
    close(got, ref)
