"""The port's six-scene reproduction run (``adaptivepnp_sci_torch.run_all_scenes``)
against the JAX script ``scripts/run_all_scenes.py`` on the CPU, at B = 4,
32x32, two measurements a scene, in three cases:

- ``ffd``: float32 FFDNet with Malvar, on the photograph stand-ins Beauty
  and Runner, with ``random_init``;
- ``fastdvd-dd``: the runner as shipped, bf16 FastDVDnet and DDnet under the
  held-out guard, on Beauty with ``random_init``. The guard keeps the warm
  start on both sides, so the iterates are held through their PSNR traces;
- ``fastdvd-dd-f32``: the same row in float32 on the trained
  ``weights/fastdvd.npz`` and ``weights/ddnet.npz``, on Beauty and on Runner
  (the longest schedule, 40/15 iterations), where the guard keeps ADMM
  iterates: the iterates themselves are held to JAX's.

``random_init`` is the JAX script's Flax initialisation, carried into the
port through ``models/convert`` (the port's ``_build_models`` is replaced by
one that returns JAX's variables). Random draws are the JAX package's: the
guard's held-out pixels (``two_stage_admm.holdout_mask``); the FastDVDnet
adaptation noise is off on both sides (its draws come from each package's
own generator).

Bars: the same row fields (scene, mode, style, sigma and iteration
strings); warm-start and final PSNR within 1e-4 dB on the float32 rows and
1e-3 dB on the bf16 rows; the PSNR of every traced iterate within 1e-4 dB in
float32 (found 1.1e-5) and 1e-2 dB in bf16 (found 4.5e-3: the port folds
BatchNorm into one float32 scale and shift where Flax rounds to bf16 after
every op, ``tests/test_torch_fastdvdnet.py``), the float32 result within
1e-5 in x (found 2.4e-7); the same guard picks, with an iterate kept in
float32; the same keys in every ``.mat`` file; the repository's
``SCENES.md`` byte for byte as before.
"""

import importlib.util
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from adaptivepnp_sci_torch import run_all_scenes as trun
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.ddnet import DDnet as TDDnet
from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet as TFastDVDnet
from adaptivepnp_sci_torch.solvers import two_stage_admm as tadmm
from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior as tfastdvd_prior
from adaptivepnp_sci_tpu import cli as jcli
from adaptivepnp_sci_tpu.models import ddnet as jddnet
from test_torch_solver_modes import jax_mask

ROOT = Path(__file__).resolve().parent.parent
B = 4
SIZE = dict(b=B, h=32, w=32, n_meas=2)
#: case -> (mode, scenes, random_init, bf16, final-dB bar, trace-dB bar)
CASES = {
    "ffd": ("ffd", ["Beauty", "Runner"], True, False, 1e-4, None),
    "fastdvd-dd": ("fastdvd-dd", ["Beauty"], True, True, 1e-3, 1e-2),
    "fastdvd-dd-f32": ("fastdvd-dd", ["Beauty", "Runner"], False, False, 1e-4, 1e-4),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Small tensors gain nothing from many threads, and the other test
    workers share the cores: two intra-op threads while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_denoiser(build, bf16):
    """JAX's denoiser builder with FastDVDnet's adaptation noise off, and in
    float32 when ``bf16`` is False."""
    def wrapped(denoiser, *a, **kw):
        if not bf16:
            kw["bf16"] = False
        model, prior, variables = build(denoiser, *a, **kw)
        if denoiser == "fastdvd":
            prior = prior._replace(adapt_noise_std=0.0)
        return model, prior, variables
    return wrapped


def _jax_ddnet_variables():
    """The JAX script's ``random_init`` DDnet variables."""
    dd = jddnet.DDnet(dtype=jnp.bfloat16)
    return jax.tree_util.tree_map(
        np.asarray, dd.init(jax.random.PRNGKey(1), jnp.zeros((1, 5, 64, 64, 3))))


def _port_models(port_build, bf16):
    """The port's model builder with FastDVDnet's adaptation noise off: with
    ``random_init`` on the JAX script's variables; in float32 when ``bf16``
    is False."""
    def build_models(modes, random_init, *rest):
        priors, dd, dd_vars = port_build(modes, random_init, *rest)
        for d, (prior, sd) in list(priors.items()):
            if random_init:
                _, _, jvars = jcli._build_denoiser(d, None, random_init=True,
                                                   bf16=(d == "fastdvd"))
                jvars = jax.tree_util.tree_map(np.asarray, jvars)
                sd = (tconvert.ffdnet_from_flax if d == "ffdnet"
                      else tconvert.fastdvdnet_from_flax)(jvars)
            if d == "fastdvd" and not bf16:
                prior = tfastdvd_prior(TFastDVDnet())
            priors[d] = (prior._replace(adapt_noise_std=0.0), sd)
        if dd is not None and random_init:
            dd_vars = tconvert.ddnet_from_flax(_jax_ddnet_variables())
        if dd is not None and not bf16:
            dd = TDDnet()
        return priors, dd, dd_vars
    return build_models


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        mp.chdir(ROOT)  # the script's weight paths are relative to the repository
        spec = importlib.util.spec_from_file_location("run_all_scenes",
                                                      "scripts/run_all_scenes.py")
        jrun = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jrun)
        mp.setattr(tadmm, "holdout_mask", jax_mask)
        jbuild, jdd, port_build = jcli._build_denoiser, jddnet.DDnet, trun._build_models
        scenes_md = (ROOT / "SCENES.md").read_bytes()
        out = {}
        for case, (mode, scenes, random_init, bf16, _, _) in CASES.items():
            mp.setattr(jcli, "_build_denoiser", _jax_denoiser(jbuild, bf16))
            # the JAX script builds DDnet in bf16: float32 for the float32 case
            mp.setattr(jddnet, "DDnet", jdd if bf16 else lambda dtype=None: jdd())
            mp.setattr(trun, "_build_models", _port_models(port_build, bf16))
            for side, main in (("jax", jrun.main), ("torch", trun.main)):
                d = tmp_path_factory.mktemp(f"{side}-{case}")
                kw = {} if side == "jax" else {"device": "cpu"}
                t0 = time.perf_counter()
                rows = main(str(d), mode, **SIZE, scenes=scenes, random_init=random_init, **kw)
                print(f"{side} {case}: {time.perf_counter() - t0:.1f} s")
                out[side, case] = (d, rows)
        out["scenes_md_unchanged"] = (ROOT / "SCENES.md").read_bytes() == scenes_md
        yield out
    finally:
        mp.undo()


def _mat(path):
    return sio.loadmat(str(path))


@pytest.mark.parametrize("case", list(CASES))
def test_rows_match_the_jax_script(runs, case):
    (_, jrows), (_, trows) = runs["jax", case], runs["torch", case]
    mode, scenes, _, _, bar, _ = CASES[case]
    assert [r[:5] for r in trows] == [r[:5] for r in jrows]
    assert [r[0] for r in trows] == scenes and {r[1] for r in trows} == {mode}
    for t, j in zip(trows, jrows):
        dwarm, dfinal = abs(t[5] - j[5]), abs(t[6] - j[6])
        print(f"{t[0]} {case}: warm {dwarm:.2e} dB, final {dfinal:.2e} dB "
              f"(port {t[6]:.4f}, JAX {j[6]:.4f}), SSIM {abs(t[7] - j[7]):.2e}")
        assert dwarm <= bar and dfinal <= bar
        assert np.isfinite(t[7]) and t[8] > 0 and t[9] > 0


@pytest.mark.parametrize("case", ["fastdvd-dd", "fastdvd-dd-f32"])
def test_iterates_match_the_jax_script(runs, case):
    """The guarded rows' ADMM iterates: every traced PSNR, the picks, and in
    float32 the result itself."""
    (jdir, _), (tdir, _) = runs["jax", case], runs["torch", case]
    mode, scenes, _, bf16, _, trace_bar = CASES[case]
    for name in scenes:
        res = {side: _mat(d / f"{name}8_online_{mode}.mat") for side, d in
               (("jax", jdir), ("torch", tdir))}
        trace = {side: np.atleast_2d(r["psnr_all_iter"]) for side, r in res.items()}
        assert trace["torch"].shape == trace["jax"].shape
        dtrace = float(np.abs(trace["torch"] - trace["jax"]).max())
        picks = {side: trun.guard_picks(str(d), name, mode, B) for side, d in
                 (("jax", jdir), ("torch", tdir))}
        dx = float(np.abs(res["torch"]["v_recon_bayer"] - res["jax"]["v_recon_bayer"]).max())
        print(f"{name} {case}: trace {dtrace:.2e} dB, picks {picks}, max |dx| {dx:.2e}")
        assert dtrace <= trace_bar
        assert picks["torch"] == picks["jax"]
        if not bf16:
            assert any(picks["jax"]), "the guard kept no iterate: nothing past the warm start"
            assert dx <= 1e-5


def test_result_files_match(runs):
    for case in CASES:
        (jdir, _), (tdir, _) = runs["jax", case], runs["torch", case]
        jfiles = sorted(p.name for p in jdir.glob("*.mat"))
        assert sorted(p.name for p in tdir.glob("*.mat")) == jfiles
        assert len(jfiles) == 2 * len(CASES[case][1])
        for f in jfiles:
            keys = {k for k in _mat(jdir / f) if not k.startswith("__")}
            assert {k for k in _mat(tdir / f) if not k.startswith("__")} == keys


def test_repository_scenes_md_untouched(runs):
    (tdir, _) = runs["torch", "fastdvd-dd"]
    assert runs["scenes_md_unchanged"]
    table = (tdir / trun.TABLE_NAME).read_text()
    assert "| Beauty | fastdvd-dd |" in table and "SCENES.md" not in table.split("\n")[0]
