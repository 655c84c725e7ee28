"""Runner's ``fastdvd-dd`` row of the six-scene run at 128x128x8, two
measurements, in float32: the port against the JAX script
``scripts/run_all_scenes.py`` on the CPU, at a larger size than
``tests/test_torch_scenes_run.py``'s 32x32x4 (marked slow: ~7 min on 8 cores).

On the card the port's row reads 27.59 dB in float32 and 27.60 in bf16 at
512^2 against ``SCENES.md``'s 25.25 (the JAX package on a TPU, in bf16,
with its own random draws). Two pairs of runs here:

* the same draws on both sides (the guard's held-out pixels JAX's, injected
  through ``two_stage_admm.holdout_mask``; FastDVDnet's adaptation noise
  off): the final and traced PSNR within 1e-4 dB of JAX's, the picks the
  same, the result within 1e-4 in x;
* each package's own draws (its own held-out pixels, the adaptation noise
  on, from JAX's keys and from the port's ``torch.Generator``): printed, with
  the picks. How far these part is how far the row depends on the draws,
  which the port cannot take from a TPU run.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import scipy.io as sio

from adaptivepnp_sci_torch import run_all_scenes as trun
from adaptivepnp_sci_torch.solvers import two_stage_admm as tadmm
from adaptivepnp_sci_tpu import cli as jcli
from adaptivepnp_sci_tpu.models import ddnet as jddnet
from test_torch_scenes_run import _jax_denoiser, _port_models
from test_torch_solver_modes import jax_mask

ROOT = Path(__file__).resolve().parent.parent
SIZE = dict(b=8, h=128, w=128, n_meas=2)
SCENE, MODE = "Runner", "fastdvd-dd"
DB, DX = 1e-4, 1e-4


def _jax_f32(build):
    """JAX's denoiser builder in float32, its adaptation noise on."""
    def wrapped(denoiser, *a, **kw):
        return build(denoiser, *a, **dict(kw, bf16=False))
    return wrapped


def _read(d):
    res = sio.loadmat(str(d / f"{SCENE}8_online_{MODE}.mat"))
    return (np.atleast_2d(res["psnr_all_iter"]), res["v_recon_bayer"],
            trun.guard_picks(str(d), SCENE, MODE, SIZE["b"]))


@pytest.mark.slow
def test_runner_row_at_128_matches_jax(tmp_path):
    mp = pytest.MonkeyPatch()
    runs = {}
    try:
        mp.chdir(ROOT)  # the script's weight paths are relative to the repository
        spec = importlib.util.spec_from_file_location("run_all_scenes",
                                                      "scripts/run_all_scenes.py")
        jrun = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jrun)
        jbuild, jdd, port_build = jcli._build_denoiser, jddnet.DDnet, trun._build_models
        mp.setattr(jddnet, "DDnet", lambda dtype=None: jdd())  # float32
        for draws in ("own", "same"):
            if draws == "same":
                mp.setattr(tadmm, "holdout_mask", jax_mask)
                mp.setattr(jcli, "_build_denoiser", _jax_denoiser(jbuild, False))
                mp.setattr(trun, "_build_models", _port_models(port_build, False))
            else:
                mp.setattr(jcli, "_build_denoiser", _jax_f32(jbuild))
            for side, main in (("jax", jrun.main), ("torch", trun.main)):
                d = tmp_path / f"{side}-{draws}"
                kw = {} if side == "jax" else {"device": "cpu", "bf16": False}
                (row,) = main(str(d), MODE, **SIZE, scenes=[SCENE], **kw)
                runs[side, draws] = (row, *_read(d))
    finally:
        mp.undo()

    for draws in ("own", "same"):
        (jrow, jtrace, jx, jpicks), (trow, ttrace, tx, tpicks) = (
            runs["jax", draws], runs["torch", draws])
        print(f"{draws} draws: warm {jrow[5]:.4f} / {trow[5]:.4f} dB, final JAX {jrow[6]:.4f} "
              f"(picks {jpicks}), port {trow[6]:.4f} (picks {tpicks}); trace "
              f"{float(np.abs(ttrace - jtrace).max()):.2e} dB, max |dx| "
              f"{float(np.abs(tx - jx).max()):.2e}")
        assert abs(trow[5] - jrow[5]) <= DB and np.isfinite(trow[6])
    (jrow, jtrace, jx, jpicks), (trow, ttrace, tx, tpicks) = runs["jax", "same"], runs[
        "torch", "same"]
    assert abs(trow[6] - jrow[6]) <= DB and float(np.abs(ttrace - jtrace).max()) <= DB
    assert tpicks == jpicks and float(np.abs(tx - jx).max()) <= DX
