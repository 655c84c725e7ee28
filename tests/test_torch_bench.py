"""The port's timing drivers against the JAX package on the CPU:
``adaptivepnp_sci_torch.bench`` (root ``bench.py``) and
``adaptivepnp_sci_torch.bench_batched`` (``scripts/bench_batched.py``),
with the FFDNet variables ``bench.py`` falls back to
(``weights/ffdnet_color_init0.npz`` of the port); the benchmark suite is in
``tests/test_torch_bench_suite.py``.

Both packages get the same numpy scenes at 32x32x8 and the same weights;
the schedules are the drivers' own. FFDNet draws nothing in its adaptation,
so no draw is injected. Bars: the file bit for bit Flax's init; one apply
max |dx| 1e-5 (``tests/test_torch_ffdnet.py``'s); a solve's per-frame PSNR
within 1e-3 dB and max |dx_bayer| 1e-4 (the earlier slices' float32 bar).
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch import bench as tbench
from adaptivepnp_sci_torch import bench_batched as tbatched
from adaptivepnp_sci_torch.models.ffdnet import FFDNet as TFFDNet
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models.ffdnet import ffdnet_color
from adaptivepnp_sci_tpu.ops import metrics
from adaptivepnp_sci_tpu.solvers import GapTVConfig, gap_tv
from adaptivepnp_sci_tpu.solvers.end_to_end import reconstruct_single_dispatch
from adaptivepnp_sci_tpu.solvers.priors import ffdnet_prior
from adaptivepnp_sci_tpu.solvers.two_stage_admm import two_stage_admm_batched
from adaptivepnp_sci_tpu.train.trainer import save_variables_npz
from test_torch_studies import to_jax

DB, DX = 1e-3, 1e-4
SIZE = 32
#: the keys of the JSON line of the JAX ``bench.py`` (the flagship mode's)
KEYS = ["metric", "value", "unit", "vs_baseline", "seconds_per_snapshot", "psnr_db", "ssim",
        "psnr_db_natural", "ssim_natural", "device"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def init0():
    """``bench.py``'s fallback variables, drawn by Flax."""
    return jax.tree_util.tree_map(np.asarray, ffdnet_color().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.float32(0.1)))


def close(got, ref):
    p = float(np.abs(got.psnr_per_frame.numpy() - np.asarray(ref.psnr_per_frame)).max())
    x = float(np.abs(got.x_bayer.numpy() - np.asarray(ref.x_bayer)).max())
    print(f"{p:.3e} dB, max |dx| {x:.3e}")
    assert p <= DB and x <= DX, (p, x)


def test_init0_file_is_flax_prngkey0_init(init0, rng):
    flat = {"/".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(init0)[0]}
    with np.load(tbench.INIT0) as z:
        assert sorted(z.files) == sorted(flat) and len(flat) == 24
        for k, v in flat.items():
            assert z[k].dtype == v.dtype and np.array_equal(z[k], v), k
    assert sum(v.size for v in flat.values()) == 852108
    # the loader's state dict in the port's FFDNet-color, one apply against Flax
    net = TFFDNet(nc=96, nb=12)
    net.load_state_dict(tbench.bench_ffdnet_weights())
    x = rng.random((1, 32, 32, 3), dtype=np.float32)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x), torch.tensor(0.1))
    want = ffdnet_color().apply(init0, jnp.asarray(x), jnp.float32(0.1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_weights_loader_takes_a_given_file(tmp_path, init0, capsys):
    default = tbench.bench_ffdnet_weights()
    absent = tbench.bench_ffdnet_weights(str(tmp_path / "absent.pth"))
    assert "absent.pth does not exist" in capsys.readouterr().err
    assert all(torch.equal(absent[k], v) for k, v in default.items())
    scaled = jax.tree_util.tree_map(lambda a: a * 2, init0)
    path = str(tmp_path / "other.npz")
    save_variables_npz(path, scaled)
    other = tbench.bench_ffdnet_weights(path)
    assert all(torch.equal(other[k], 2 * v) for k, v in default.items())


@pytest.mark.parametrize("mode", tbench.MODES)
def test_bench_mode_matches_jax(mode, init0):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line, res = tbench.main(mode, "cpu", SIZE, n=0)
    printed = json.loads(buf.getvalue().strip().splitlines()[-1])
    want_keys = KEYS if mode == "flagship" else [k for k in KEYS if "natural" not in k]
    assert list(printed) == list(line) == want_keys
    assert printed["device"] == "cpu" and printed["metric"] == tbench.METRIC
    assert line["vs_baseline"] == pytest.approx(line["value"] / 0.8)
    cfg = to_jax(tbench.admm_config(mode))
    prior = ffdnet_prior(ffdnet_color())
    for style in ("smooth", "leaves") if mode == "flagship" else ("smooth",):
        sc = make_scene(b=8, h=SIZE, w=SIZE, seed=42, style=None if style == "smooth" else style)
        ref = reconstruct_single_dispatch(jnp.asarray(sc.meas), jnp.asarray(sc.mask),
                                          GapTVConfig(iters=40), cfg, prior, init0,
                                          orig=jnp.asarray(sc.orig_bayer))
        close(res[style], ref)
    assert line["psnr_db"] == pytest.approx(float(np.mean(res["smooth"].psnr_per_frame.numpy())))


def test_bench_batched_matches_jax(init0, capsys):
    rows = tbatched.main(batches=(1, 2), size=SIZE, device="cpu", n=0)
    out = capsys.readouterr().out
    assert "batch  1:" in out and "batch  2:" in out and "FAILED" not in out
    prior = ffdnet_prior(ffdnet_color())
    cfg = to_jax(tbatched.studies.flagship_config(adapt=None))
    for t, _, _, psnr, peak, x in rows:
        sc = make_scene(b=8, h=SIZE, w=SIZE, seed=43, n_meas=t)
        meas = sc.meas[..., None] if sc.meas.ndim == 2 else sc.meas
        y, phi = jnp.asarray(meas.transpose(2, 0, 1)), jnp.asarray(sc.mask)
        orig = jnp.asarray(sc.orig_bayer if sc.orig_bayer.ndim == 4 else sc.orig_bayer[None])
        x0 = jax.vmap(lambda yy: gap_tv(yy, phi, GapTVConfig(iters=40)).x_bayer)(y)
        ref = two_stage_admm_batched(y, phi, cfg, prior=prior, variables=init0,
                                     x0_batch=x0).x_bayer
        want = float(jnp.mean(jax.vmap(metrics.psnr_per_frame)(ref, orig)))
        dx = float(np.abs(x.numpy() - np.asarray(ref)).max())
        print(f"t = {t}: {abs(psnr - want):.3e} dB, max |dx| {dx:.3e}")
        assert x.shape == (t, 8, SIZE, SIZE) and peak is None
        assert abs(psnr - want) <= DB and dx <= DX


@pytest.mark.slow
def test_bench_jax_readings(init0):
    """``chip_smoke.py``'s ``BENCH_JAX_DB``: JAX's mean per-frame PSNR of
    ``bench.py``'s calls at ``BENCH_JAX_SIZE`` on the CPU (the card's
    ``bench`` phase holds the port's readings to them). Run with ``-s`` to
    print the readings."""
    import importlib.util

    from test_torch_weight_tools import ROOT

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    size, prior = smoke.BENCH_JAX_SIZE, ffdnet_prior(ffdnet_color())
    for key, want in smoke.BENCH_JAX_DB.items():
        mode, _, natural = key.partition("_")
        sc = make_scene(b=8, h=size, w=size, seed=42, style="leaves" if natural else None)
        res = reconstruct_single_dispatch(jnp.asarray(sc.meas), jnp.asarray(sc.mask),
                                          GapTVConfig(iters=40), to_jax(tbench.admm_config(mode)),
                                          prior, init0, orig=jnp.asarray(sc.orig_bayer))
        got = float(np.asarray(res.psnr_per_frame, np.float64).mean())
        print(f"{key}: {got!r}")
        assert abs(got - want) <= 1e-5, (key, got, want)
