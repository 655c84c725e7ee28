"""Port ops vs the JAX package: Bayer layout, SCI physics, the plain
versions of the two kernels, demosaicking and metrics.

The same numpy inputs go through both packages on the CPU. Elementwise ops
hold rtol 1e-5 / atol 1e-6 (float32, sums taken in another order).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.ops import bayer as tbayer
from adaptivepnp_sci_torch.ops import cuda_kernels
from adaptivepnp_sci_torch.ops import demosaic as tdemosaic
from adaptivepnp_sci_torch.ops import metrics as tmetrics
from adaptivepnp_sci_torch.ops import physics as tphysics
from adaptivepnp_sci_torch.ops import tv as ttv
from adaptivepnp_sci_tpu.ops import bayer, demosaic, metrics, pallas_kernels, physics, tv

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


def _xdata(rng, b=8, c=4, h=16, w=128):
    theta = rng.random((b, c, h, w), dtype=np.float32)
    bdual = (rng.random((b, c, h, w), dtype=np.float32) - 0.5) * 0.2
    phi = (rng.random((b, c, h, w)) > 0.5).astype(np.float32)
    y = (rng.random((b, c, h, w), dtype=np.float32) * phi).sum(0)
    phis = phi.sum(0)
    phis[phis == 0] = 1
    return theta, bdual, y, phi, phis


# ----------------------------------------------------------------- bayer


def test_bayer_layout_matches_jax(rng):
    x = rng.random((3, 8, 12), dtype=np.float32)
    rgb = rng.random((2, 8, 12, 3), dtype=np.float32)
    np.testing.assert_array_equal(tbayer.pack(_t(x)), bayer.pack(jnp.asarray(x)))
    planes = rng.random((3, 4, 4, 6), dtype=np.float32)
    np.testing.assert_array_equal(tbayer.unpack(_t(planes)), bayer.unpack(jnp.asarray(planes)))
    np.testing.assert_array_equal(tbayer.cfa_masks((6, 10), "GBRG"),
                                  bayer.cfa_masks((6, 10), "GBRG"))
    _close(tbayer.mosaic(_t(rgb)), bayer.mosaic(jnp.asarray(rgb)))
    _close(tbayer.rggb_subsample(_t(rgb)), bayer.rggb_subsample(jnp.asarray(rgb)))
    _close(tbayer.embed_rgb(_t(x)), bayer.embed_rgb(jnp.asarray(x)))


# --------------------------------------------------------------- physics


def test_physics_matches_jax(rng):
    theta, bdual, y, phi, phis = _xdata(rng, h=8, w=16)
    phi[:, :, 0, 0] = 0  # a pixel no frame samples: the zero-guard
    _close(tphysics.forward(_t(theta), _t(phi)), physics.forward(theta, phi))
    _close(tphysics.adjoint(_t(y), _t(phi)), physics.adjoint(y, phi))
    _close(tphysics.phi_sum(_t(phi)), physics.phi_sum(phi))
    _close(tphysics.measurement_loss(_t(theta), _t(phi), _t(y)),
           physics.measurement_loss(theta, phi, y))


@pytest.mark.parametrize("shape", [(8, 4, 16, 128), (4, 4, 128, 256)])
@pytest.mark.parametrize("mode", ["admm", "gap", "gap_lam"])
def test_x_update_plain_matches_jax_and_pallas(rng, shape, mode):
    """K1's plain version vs ``physics.*_x_update`` and the Pallas kernel in
    interpret mode, at the multi-tile grid shape too; the wrapper given CPU
    tensors returns the plain result."""
    theta, bdual, y, phi, phis = _xdata(rng, *shape)
    args = (theta, bdual, y, phi, phis)
    targs = tuple(map(_t, args))
    jargs = tuple(map(jnp.asarray, args))
    if mode == "admm":
        got = tphysics.admm_x_update(*targs, 0.55, 1.0)
        wrapped = cuda_kernels.admm_x_update(*targs, 0.55, 1.0)
        want = physics.admm_x_update(*jargs, 0.55, 1.0)
        fused = pallas_kernels.admm_x_update(*jargs, 0.55, 1.0, interpret=True)
    else:
        lam = 1.0 if mode == "gap" else 0.5
        got = tphysics.gap_x_update(*targs, lam, 0.01)
        wrapped = cuda_kernels.gap_x_update(*targs, lam, 0.01)
        want = physics.gap_x_update(*jargs, lam, 0.01)
        fused = (pallas_kernels.gap_x_update(*jargs, lam, 0.01, interpret=True)
                 if lam == 1.0 else want)  # the Pallas wrapper has no lam != 1 kernel
    _close(got, want)
    _close(got, fused)
    np.testing.assert_array_equal(wrapped, got)


# -------------------------------------------------------------------- tv


def test_tv_plain_matches_jax_and_pallas(rng):
    x = rng.random((2, 4, 24, 24), dtype=np.float32)
    got = ttv.tv_chambolle_multichannel(_t(x), 0.1, max_iter=5)
    want = tv.tv_chambolle_multichannel(jnp.asarray(x), 0.1, max_iter=5)
    fused = pallas_kernels.tv_chambolle_fused(jnp.asarray(x), 0.1, max_iter=5,
                                              interpret=True)
    _close(got, want)
    _close(got, fused)
    np.testing.assert_array_equal(cuda_kernels.tv_chambolle_fused(_t(x), 0.1), got)


@pytest.mark.parametrize("max_iter", [1, 2, 5, 12])
def test_tv_plain_early_stop_matches_jax(rng, max_iter):
    """Smooth planes stop early, each on its own; noisy ones run on."""
    yy, xx = np.mgrid[0:32, 0:40].astype(np.float32) / 32
    smooth = np.stack([np.sin(3 * xx + k) * np.cos(2 * yy) for k in range(3)])
    noisy = rng.random((3, 32, 40), dtype=np.float32)
    x = np.concatenate([smooth * 0.5 + 0.5, noisy]).astype(np.float32)
    got, iters = ttv.tv_chambolle_planes(_t(x), 0.1, 2e-4, max_iter)
    want = tv.tv_chambolle_multichannel(jnp.asarray(x), 0.1, 2e-4, max_iter)
    _close(got, want)
    assert iters.dtype == torch.int32 and iters.shape == (6,)
    assert int(iters.max()) <= max_iter and int(iters.min()) >= 1
    one = ttv.tv_chambolle_2d(_t(x[4]), 0.1, 2e-4, max_iter)
    _close(one, tv.tv_chambolle_2d(jnp.asarray(x[4]), 0.1, 2e-4, max_iter))


def test_tv_plain_matches_golden():
    g = np.load(Path(__file__).parent / "goldens" / "tv_chambolle_golden.npz")
    got = ttv.tv_chambolle_multichannel(_t(g["cube"]), 0.1, max_iter=5)
    _close(got, g["out"], rtol=0, atol=1e-5)


# ------------------------------------------------------ demosaic, metrics


@pytest.mark.parametrize("name", ["malvar2004", "bilinear"])
def test_demosaic_matches_jax(rng, name):
    cfa = rng.random((3, 16, 20), dtype=np.float32)
    got = getattr(tdemosaic, name)(_t(cfa))
    want = getattr(demosaic, name)(jnp.asarray(cfa))
    assert got.shape == (3, 16, 20, 3)
    _close(got, want)


def test_metrics_match_jax(rng):
    ref = rng.random((4, 24, 20), dtype=np.float32)
    img = np.clip(ref + 0.05 * rng.standard_normal(ref.shape), 0, 1).astype(np.float32)
    _close(tmetrics.psnr(_t(ref), _t(img)), metrics.psnr(ref, img))
    _close(tmetrics.psnr_per_frame(_t(ref), _t(img)), metrics.psnr_per_frame(ref, img))
    _close(tmetrics.ssim(_t(ref[0]), _t(img[0])), metrics.ssim(ref[0], img[0]))
    _close(tmetrics.ssim_per_frame(_t(ref), _t(img)), metrics.ssim_per_frame(ref, img))
    # identical frames: the 1e-12 MSE floor
    _close(tmetrics.psnr(_t(ref), _t(ref)), metrics.psnr(ref, ref))
