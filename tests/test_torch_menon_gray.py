"""Port ``ops/menon2007.py`` and ``solvers/gray.py`` vs the JAX package on
the CPU: Menon 2007 on the doctest CFAs of ``tests/test_menon.py`` and on a
scene (with and without its refining step, and the BGGR pattern), inside the
two-stage solver (``demosaic_method="menon2007"``), and the grayscale GAP
solver with TV (plain and accelerated) and with an FFDNet-gray prior.

Bar: Menon to 2e-7 of the doctest values; the solvers per-frame PSNR within
1e-3 dB and max |dx| <= 1e-4 of JAX's in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.data.synthetic import _smooth_video as t_smooth_video
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.ffdnet import FFDNet as TFFDNet
from adaptivepnp_sci_torch.models.ffdnet import ffdnet_gray as tffdnet_gray
from adaptivepnp_sci_torch.ops.menon2007 import menon2007 as tmenon
from adaptivepnp_sci_torch.solvers import gray as tgray
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models.ffdnet import FFDNet, ffdnet_gray
from adaptivepnp_sci_tpu.ops.menon2007 import menon2007
from adaptivepnp_sci_tpu.solvers.gray import GrayConfig, gap_denoise_gray
from test_menon import _CFA_BGGR, _CFA_RGGB, _EXPECTED_BGGR, _EXPECTED_RGGB

DB, DX = 1e-3, 1e-4


def test_menon_doctest_cfas():
    got = tmenon(torch.from_numpy(_CFA_RGGB)[None])[0].numpy()
    np.testing.assert_allclose(got, _EXPECTED_RGGB, atol=2e-7)
    got = tmenon(torch.from_numpy(_CFA_BGGR)[None], pattern="BGGR")[0]
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _EXPECTED_BGGR, atol=2e-7)


@pytest.mark.parametrize("pattern,refine", [("RGGB", True), ("RGGB", False), ("BGGR", True)])
def test_menon_matches_jax_on_a_scene(pattern, refine):
    sc = make_scene(b=4, h=32, w=32, seed=3)
    want = np.asarray(menon2007(jnp.asarray(sc.orig_bayer), pattern=pattern,
                                refining_step=refine))
    got = tmenon(torch.from_numpy(sc.orig_bayer), pattern=pattern, refining_step=refine)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.fixture(scope="module")
def gray_scene():
    """The JAX gray tests' scene, from the port's copy of the video maker."""
    rng = np.random.default_rng(11)
    video = t_smooth_video(8, 32, 32, rng).mean(-1)
    mask = (rng.random((8, 32, 32)) > 0.5).astype(np.float32)
    return (video * mask).sum(0), mask, video


def gray_gaps(got, ref):
    p = float(np.abs(got.psnr_per_frame.numpy() - np.asarray(ref.psnr_per_frame)).max())
    x = float(np.abs(got.x.numpy() - np.asarray(ref.x)).max())
    print(f"parity: dPSNR {p:.2e} dB, max |dx| {x:.2e}")
    assert p <= DB and x <= DX, (p, x)
    np.testing.assert_allclose(got.psnr_trace.numpy(), np.asarray(ref.psnr_trace), atol=DB)


@pytest.mark.parametrize("accelerate", [False, True])
def test_gray_tv_matches_jax(gray_scene, accelerate):
    y, mask, video = gray_scene
    cfg = dict(sigma=(0.0,), iters=(20,), accelerate=accelerate)
    ref = gap_denoise_gray(y, mask, GrayConfig(**cfg), orig=video)
    got = tgray.gap_denoise_gray(y, mask, tgray.GrayConfig(**cfg), orig=video, device="cpu")
    gray_gaps(got, ref)
    adj = (mask * y[None]) / np.maximum(mask.sum(0), 1)
    assert float(got.psnr_per_frame.mean()) > -10 * np.log10(((adj - video) ** 2).mean()) + 3


def test_gray_ffdnet_matches_jax(gray_scene):
    """An FFDNet-gray prior (in_nc = 1) through the denoise_fn hook."""
    y, mask, video = gray_scene
    model = FFDNet(in_nc=1, out_nc=1, nc=8, nb=3)
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 1)), jnp.float32(0.1)))
    net = TFFDNet(in_nc=1, out_nc=1, nc=8, nb=3)
    net.load_state_dict(tconvert.ffdnet_from_flax(variables))
    cfg = dict(sigma=(25 / 255, 6 / 255), iters=(3, 2), denoiser="ffdnet")
    ref = gap_denoise_gray(y, mask, GrayConfig(**cfg), denoise_fn=model.apply,
                           variables=variables, orig=video)
    got = tgray.gap_denoise_gray(y, mask, tgray.GrayConfig(**cfg),
                                 denoise_fn=lambda m, f, s: m(f, s), variables=net,
                                 orig=video, device="cpu")
    gray_gaps(got, ref)
    full = tffdnet_gray()
    want = ffdnet_gray()
    assert (full.in_nc, full.out_nc, full.nc, full.nb) == (want.in_nc, want.out_nc, want.nc,
                                                            want.nb)
    with pytest.raises(ValueError):
        tgray.gap_denoise_gray(y, mask, dataclasses.replace(tgray.GrayConfig(), denoiser="ffdnet"),
                               device="cpu")


def test_menon_inside_the_solver_matches_jax():
    """``demosaic_method="menon2007"`` in the two-stage solver (FFDNet, from a
    GAP-TV warm start), as ``tests/test_solvers.py`` drives it in JAX."""
    from adaptivepnp_sci_torch.solvers import two_stage_admm as tadmm
    from adaptivepnp_sci_tpu.solvers import ADMMConfig, GapTVConfig, gap_tv, two_stage_admm
    from test_torch_solvers import assert_parity, ffdnet_pair

    sc = make_scene(b=4, h=32, w=32, seed=7)
    (jprior, variables), (tprior, params) = ffdnet_pair(nc=16, nb=4)
    x0 = np.array(gap_tv(jnp.asarray(sc.meas), jnp.asarray(sc.mask), GapTVConfig(iters=10)).x_bayer)
    kw = dict(sigma=(25 / 255, 12 / 255), iters=(2, 2), demosaic_method="menon2007")
    ref = two_stage_admm(jnp.asarray(sc.meas), jnp.asarray(sc.mask), ADMMConfig(**kw), jprior,
                         variables, jnp.asarray(x0), orig_bayer=jnp.asarray(sc.orig_bayer))
    got = tadmm.two_stage_admm(sc.meas, sc.mask, tadmm.ADMMConfig(**kw), tprior, params, x0,
                               sc.orig_bayer, device="cpu")
    assert_parity(got, ref, db=DB, dx=DX)
    np.testing.assert_allclose(got.x_rgb.numpy(), np.asarray(ref.x_rgb), atol=10 * DX)
