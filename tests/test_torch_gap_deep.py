"""Port ``solvers/gap_deep.py`` vs the JAX package on the CPU: the one-stage
GAP solver with the FFDNet prior (with the 'PPP' adaptation, fresh and with
the carried Adam) and with the FastDVDnet prior (trained weights, adaptation
noise off), λ ≠ 1 in the GAP x-update.

Both packages get the same numpy scene and weights, at the JAX tests' shapes
(32x32x4). Bar: per-frame PSNR within 1e-3 dB and max |dx_bayer| <= 1e-4
in float32; adapted weights within 5 % of lr of JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.adapt.online import AdaptConfig as TAdaptConfig
from adaptivepnp_sci_torch.solvers import gap_deep as tgap_deep
from adaptivepnp_sci_tpu.adapt.online import AdaptConfig
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.solvers import GapDeepConfig, gap_deep
from test_torch_drivers import assert_ffdnet_weights
from test_torch_solvers import assert_fastdvd_weights, fastdvd_pair, ffdnet_pair

DB, DX = 1e-3, 1e-4


@pytest.fixture(scope="module")
def scene():
    return make_scene(b=4, h=32, w=32, seed=11)


@pytest.fixture(scope="module")
def ffdnet():
    return ffdnet_pair(nc=16, nb=4)


def run_both(sc, pair, kw, adapt=None, opt_state=None):
    (jprior, variables), (tprior, params) = pair
    ref = gap_deep(jnp.asarray(sc.meas), jnp.asarray(sc.mask),
                   GapDeepConfig(**kw, adapt=adapt and AdaptConfig(**adapt)), jprior, variables,
                   orig_bayer=jnp.asarray(sc.orig_bayer))
    got = tgap_deep.gap_deep(sc.meas, sc.mask,
                             tgap_deep.GapDeepConfig(**kw, adapt=adapt and TAdaptConfig(**adapt)),
                             tprior, params, orig_bayer=sc.orig_bayer, device="cpu")
    p_gap = float(np.abs(got.psnr_per_frame.numpy() - np.asarray(ref.psnr_per_frame)).max())
    x_gap = float(np.abs(got.x_bayer.numpy() - np.asarray(ref.x_bayer)).max())
    print(f"parity: dPSNR {p_gap:.2e} dB, max |dx_bayer| {x_gap:.2e}")
    assert p_gap <= DB and x_gap <= DX, (p_gap, x_gap)
    np.testing.assert_allclose(got.x_rgb.numpy(), np.asarray(ref.x_rgb), atol=10 * DX)
    np.testing.assert_allclose(got.psnr_trace.numpy(), np.asarray(ref.psnr_trace), atol=DB)
    return ref, got


@pytest.mark.parametrize("fresh", [True, False])
def test_gap_deep_ffdnet_matches_jax(scene, ffdnet, fresh):
    """The 'PPP' branch: FFDNet adapting at k = 2 and 4 inside GAP, λ = 0.8,
    bilinear demosaicking; a fresh Adam per trigger, or one carried."""
    pair = ffdnet
    adapt = dict(lr=1e-4, update_per_iter=1, interval_iter=2, initial_iter=1,
                 fresh_opt_per_trigger=fresh)
    ref, got = run_both(scene, pair, dict(sigma=(25 / 255, 12 / 255), iters=(3, 2), lam=0.8,
                                          demosaic_method="bilinear"), adapt)
    assert_ffdnet_weights(got.variables, ref.variables, pair[0][1], 2)
    assert (got.opt_state is None) == fresh
    if not fresh:
        assert int(got.opt_state["state"][0]["step"]) == int(ref.opt_state[0].count) == 2


def test_gap_deep_fastdvd_matches_jax(scene):
    """The FastDVDnet branch with the trained weights, adapting at k = 2
    (one Adam step at lr 2e-7, the noise off)."""
    pair = fastdvd_pair()
    ref, got = run_both(scene, pair, dict(sigma=(12 / 255,), iters=(3,), denoiser="fastdvd"),
                        dict(lr=2e-7, update_per_iter=1, interval_iter=2, initial_iter=1))
    assert_fastdvd_weights(got.variables, ref.variables, pair[0][1], 2e-7, 1)


def test_gap_deep_refuses_other_denoisers(scene, ffdnet):
    with pytest.raises(ValueError):
        tgap_deep.gap_deep(scene.meas, scene.mask,
                           tgap_deep.GapDeepConfig(sigma=(0.1,), iters=(1,), denoiser="tv"),
                           None, None, device="cpu")
    params = ffdnet[1]
    res = tgap_deep.gap_deep(scene.meas, scene.mask,
                             tgap_deep.GapDeepConfig(sigma=(0.1,), iters=(2,)), *params,
                             device="cpu")
    for k, v in res.variables.items():  # no adaptation: the weights come back as they went
        assert torch.equal(v, params[1][k])
