"""``adaptivepnp_sci_torch.run_benchmark_suite`` against
``scripts/run_benchmark_suite.py`` and the JAX library calls it makes, on
the CPU.

First both drivers run with their solvers, scene maker and weight readers
replaced by recorders (the JAX script is loaded from ``scripts/`` as it
is): each row's calls must agree field by field, the port's configurations
carried to JAX's by ``test_torch_studies.to_jax``, with the scenes' arguments,
the models' types, widths and dtypes, the weight files, the tile and the
timed calls. Then rows 1, 2, 3b, 4, 5a, 5b and 6 are solved at 32x32x8 with
every stage cut to 2 iterations and the adaptation every 2, both packages on
the same numpy scenes and weights (the FFDNet variables of ``bench.py``'s
fallback, ``weights/fastdvd_smooth.npz``, ``weights/ddnet.npz``), JAX's
adaptation noise injected into the FastDVDnet row through
``adapt.online.trigger_draws`` (FFDNet draws nothing). Bars: per-frame
PSNR within 1e-3 dB and max |dx_bayer| 1e-4 (float32); the bf16 rows (3b,
FastDVDnet; 5a, DDnet) 5e-2 dB and 1e-2 (``test_torch_studies_fastdvd``'s).
"""

import contextlib
import importlib
import io
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptivepnp_sci_torch.adapt.online as tonline
from adaptivepnp_sci_torch import run_benchmark_suite as tsuite
from adaptivepnp_sci_torch import studies
from adaptivepnp_sci_torch.bench import INIT0
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models.ddnet import DDnet
from adaptivepnp_sci_tpu.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_tpu.models.ffdnet import ffdnet_color
from adaptivepnp_sci_tpu.solvers import gap_tv
from adaptivepnp_sci_tpu.solvers.end_to_end import reconstruct_single_dispatch
from adaptivepnp_sci_tpu.solvers.priors import ddnet_demosaic, fastdvd_prior, ffdnet_prior
from adaptivepnp_sci_tpu.solvers.two_stage_admm import (
    two_stage_admm_batched,
    two_stage_admm_tiled,
)
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz
from test_torch_studies import to_jax
from test_torch_weight_tools import ROOT, load_script

SIZE, CUT, INTERVAL = 32, 2, 2
DB, DX, BF16_DB, BF16_DX = 1e-3, 1e-4, 5e-2, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dtype(d):
    return None if d is None else str(np.dtype(d) if not isinstance(d, torch.dtype)
                                      else d).removeprefix("torch.")


def _model(m):
    """A model's type, widths and dtypes."""
    return (type(m).__name__, *(getattr(m, k, None) for k in ("nc", "nb", "remat")),
            _dtype(getattr(m, "dtype", None)))


class Recorder:
    """Stand-ins for one package's solvers, scene maker and weight readers
    that record each call (the scene by the index it was made with)."""

    def __init__(self, torch_side: bool):
        self.torch_side, self.scenes, self.calls, self.timed = torch_side, [], [], []

    def _arr(self, a):
        return torch.as_tensor(np.asarray(a)) if self.torch_side else jnp.asarray(a)

    def _scene(self, y):
        return self.scenes[int(np.asarray(y).reshape(-1)[0]) - 1]

    def _result(self):
        z = self._arr(np.zeros((8, 4, 4), np.float32))
        return SimpleNamespace(x_bayer=z, psnr_per_frame=z[:, 0, 0], ssim_per_frame=z[:, 0, 0])

    def _weights(self, variables):
        return "ffdnet" if "model.0.weight" in variables or "params" in variables \
            else sorted(variables)[0]

    def _cfg(self, cfg):
        return to_jax(cfg) if self.torch_side else cfg

    def make_scene(self, **kw):
        self.scenes.append(kw)
        n = kw.get("n_meas", 1)
        meas = np.full((4, 4) if n == 1 else (4, 4, n), len(self.scenes), np.float32)
        return SimpleNamespace(meas=meas, mask=np.ones((8, 4, 4), np.float32),
                               orig_bayer=np.zeros((8, 4, 4) if n == 1 else (n, 8, 4, 4),
                                                   np.float32))

    def gap_tv(self, y, phi, cfg, orig_bayer=None, **kw):
        self.calls.append(("gap_tv", self._scene(y), self._cfg(cfg)))
        return self._result()

    def single(self, y, phi, wcfg, cfg, prior, variables, orig=None, demosaic_fn=None, **kw):
        self.calls.append(("single", self._scene(y), self._cfg(wcfg), self._cfg(cfg),
                           _model(prior.model), self._weights(variables), demosaic_fn))
        return self._result()

    def batched(self, y, phi, cfg, prior=None, variables=None, params=None, x0_batch=None,
                **kw):
        self.calls.append(("batched", self._scene(y[0]), self._cfg(cfg), _model(prior.model),
                           self._weights(variables if params is None else params),
                           tuple(x0_batch.shape[:1])))
        return self._result()

    def tiled(self, y, phi, cfg, tile=512, prior=None, variables=None, params=None, **kw):
        self.calls.append(("tiled", self._scene(y), self._cfg(cfg), tile, _model(prior.model),
                           self._weights(variables if params is None else params)))
        return self._result()

    def ddnet_demosaic(self, model, variables):
        return ("ddnet", _model(model), self._weights(variables))

    def load(self, path):
        return {os.path.basename(path): self._arr(np.zeros((), np.float32))}

    def unique_calls(self):
        seen = []
        for c in self.calls:
            if c not in seen:
                seen.append(c)
        return seen


def test_suite_rows_are_the_scripts(monkeypatch, tmp_path):
    mod = importlib.import_module  # a package's attribute may be a function of the module's name
    tsyn, tgap, tend, tadmm, tpriors, ttrainer, jsyn, jsolvers, jend, jadmm, jpriors, \
        jtrainer, jconvert = (mod(f"adaptivepnp_sci_{m}") for m in (
            "torch.data.synthetic", "torch.solvers.gap_tv", "torch.solvers.end_to_end",
            "torch.solvers.two_stage_admm", "torch.solvers.priors", "torch.train.trainer",
            "tpu.data.synthetic", "tpu.solvers", "tpu.solvers.end_to_end",
            "tpu.solvers.two_stage_admm", "tpu.solvers.priors", "tpu.train.trainer",
            "tpu.models.convert"))

    monkeypatch.chdir(ROOT)  # the script reads weights/ relative to the working directory
    script = load_script("run_benchmark_suite")
    sides = {}
    for name, mods in (("jax", (jsyn, jsolvers, jend, jadmm, jpriors, jtrainer)),
                       ("torch", (tsyn, tgap, tend, tadmm, tpriors, ttrainer))):
        rec = sides[name] = Recorder(name == "torch")
        syn, gap, end, admm, pri, trainer = mods
        monkeypatch.setattr(syn, "make_scene", rec.make_scene)
        monkeypatch.setattr(gap, "gap_tv", rec.gap_tv)
        monkeypatch.setattr(end, "reconstruct_single_dispatch", rec.single)
        monkeypatch.setattr(admm, "two_stage_admm_batched", rec.batched)
        monkeypatch.setattr(admm, "two_stage_admm_tiled", rec.tiled)
        monkeypatch.setattr(pri, "ddnet_demosaic", rec.ddnet_demosaic)
        for prior in ("ffdnet_prior", "fastdvd_prior"):
            monkeypatch.setattr(pri, prior, lambda model, **kw: SimpleNamespace(model=model))
        monkeypatch.setattr(trainer, "load_checkpoint_variables", rec.load)
    monkeypatch.setattr(jconvert, "load_ffdnet", lambda path: {"params": jnp.zeros(())})
    jax_timed = script.timed
    monkeypatch.setattr(script, "timed", lambda fn, n=2: (sides["jax"].timed.append(n),
                                                           jax_timed(fn, n))[1])
    port_timed = studies.timed
    monkeypatch.setattr(studies, "timed", lambda fn, n, d: (sides["torch"].timed.append(n),
                                                            port_timed(fn, n, d))[1])
    with contextlib.redirect_stdout(io.StringIO()):
        script.main(str(tmp_path / "jax.md"))
        rows = tsuite.main(str(tmp_path / "torch.md"), 512, "cpu")
    jside, tside = sides["jax"], sides["torch"]
    assert [r[1] for r in rows] == [ln.split(" | ")[0].removeprefix("| ") for ln in
                                    (tmp_path / "jax.md").read_text().splitlines()
                                    if ln.startswith("| ") and not ln.startswith("| config")]
    assert tside.timed == jside.timed == [tsuite.ROW_N[k] for k in tsuite.ROWS]
    assert tside.unique_calls() == jside.unique_calls()
    # every row's scene: its make_scene arguments as the script writes them
    single = [c for c in tside.unique_calls() if c[0] != "gap_tv"]
    keys = [k for k in tsuite.ROWS if k != "1"]
    assert [c[1] for c in single] == [tsuite.row_scene(k, 512) for k in keys]
    assert [c[0] for c in single] == ["single"] * 10 + ["batched", "tiled"]
    assert single[1][5] == single[2][5] == "fastdvd_smooth.npz"
    assert single[1][4] == ("FastDVDnet", None, None, False, "bfloat16")
    assert single[8][6] == ("ddnet", ("DDnet", None, None, None, "bfloat16"), "ddnet.npz")
    assert single[11][3] == 512 and single[10][5] == (tsuite.N_BATCHED,)


@pytest.fixture(scope="module")
def shared():
    return load_variables_npz(str(INIT0)), tsuite.suite_configs(CUT, INTERVAL)


def jax_noise(monkeypatch):
    """The port's trigger draws replaced by JAX's: the input noise of
    trigger i from the i-th split of ``PRNGKey(0)``, as the JAX solver
    carries its key through the triggers."""
    key = [jax.random.PRNGKey(0)]

    def draws(prior, cfg, generator, shape):
        key[0], sub = jax.random.split(key[0])
        noise = torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32)))
        return tonline.TriggerDraws(noise, None, None)

    monkeypatch.setattr(tonline, "trigger_draws", draws)


@pytest.mark.parametrize("key", ["1", "2", "3b", "4", "5a", "5b", "6"])
def test_suite_row_matches_jax(key, shared, monkeypatch):
    v, cfgs = shared
    if key == "3b":
        jax_noise(monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()):
        [(_, _, t, psnr, ssim, got)] = tsuite.run_rows(SIZE, "cpu", cut=CUT, interval=INTERVAL,
                                                       n=0, rows=(key,))
    kw = tsuite.row_scene(key, SIZE)
    sc = make_scene(**kw)
    y, phi, orig = (jnp.asarray(a) for a in (sc.meas, sc.mask, sc.orig_bayer))
    wcfg, prior = to_jax(studies.WARM), ffdnet_prior(ffdnet_color())
    db, dx = (BF16_DB, BF16_DX) if key in ("3b", "5a") else (DB, DX)
    if key == "1":
        ref = gap_tv(y, phi, wcfg, orig_bayer=orig)
    elif key == "5b":
        y = jnp.transpose(y, (2, 0, 1))
        x0 = jnp.stack([gap_tv(y[i], phi, wcfg).x_bayer for i in range(tsuite.N_BATCHED)])
        ref = two_stage_admm_batched(y, phi, to_jax(cfgs[key]), prior=prior, variables=v,
                                     x0_batch=x0, orig_batch=orig)
    elif key == "6":
        x0 = gap_tv(y, phi, wcfg).x_bayer
        ref = two_stage_admm_tiled(y, phi, to_jax(cfgs[key]), tile=SIZE, prior=prior,
                                   variables=v, orig_bayer=orig, x0_bayer=x0)
    else:
        extra = {}
        if key == "3b":
            prior = fastdvd_prior(FastDVDnet(dtype=jnp.bfloat16, remat=False))
            v = load_variables_npz(tsuite.fastdvd_weights())
        elif key == "5a":
            extra["demosaic_fn"] = ddnet_demosaic(DDnet(dtype=jnp.bfloat16), load_variables_npz(
                str(ROOT / "weights" / "ddnet.npz")))
        ref = reconstruct_single_dispatch(y, phi, wcfg, to_jax(cfgs[key]), prior, v, orig=orig,
                                          **extra)
    p = float(np.abs(got.psnr_per_frame.numpy() - np.asarray(ref.psnr_per_frame)).max())
    x = float(np.abs(got.x_bayer.numpy() - np.asarray(ref.x_bayer)).max())
    print(f"row {key}: {p:.3e} dB, max |dx| {x:.3e}")
    assert p <= db and x <= dx, (p, x)
    assert psnr == pytest.approx(float(np.mean(got.psnr_per_frame.numpy())))
