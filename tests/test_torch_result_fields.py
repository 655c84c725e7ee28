"""The port's result tuples lay out their fields as the JAX package's do:
``ADMMResult`` and ``EndToEndResult`` begin with JAX's fields in JAX's
order, the port's extra ``resid_trace`` comes last, and a positional unpack
of a port result gives the same field as the same unpack of JAX's on the
same CPU solve (a carried-Adam solve, so ``opt_state`` is not None).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from adaptivepnp_sci_torch.adapt.online import AdaptConfig as TAdaptConfig
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.ffdnet import FFDNet as TFFDNet
from adaptivepnp_sci_torch.solvers import end_to_end as tend
from adaptivepnp_sci_torch.solvers import two_stage_admm as tadmm
from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig as TGapTVConfig
from adaptivepnp_sci_tpu.adapt.online import AdaptConfig
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.solvers import ADMMConfig, GapTVConfig
from adaptivepnp_sci_tpu.solvers import end_to_end as jend
from test_torch_solvers import ffdnet_pair

jadmm = importlib.import_module("adaptivepnp_sci_tpu.solvers.two_stage_admm")
ADAPT = dict(lr=1e-4, update_per_iter=1, interval_iter=2, initial_iter=0,
             fresh_opt_per_trigger=False)
KW = dict(sigma=(25 / 255,), iters=(4,))


@pytest.mark.parametrize("port, ref", [(tadmm.ADMMResult, jadmm.ADMMResult),
                                       (tend.EndToEndResult, jend.EndToEndResult)])
def test_fields_begin_with_jax_fields_in_order(port, ref):
    n = len(ref._fields)
    assert port._fields[:n] == ref._fields
    assert port._fields[n:] == ("resid_trace",)
    assert port._fields[6] == "opt_state"


def _check_unpack(got, ref, nc, nb):
    """Position by position, the port's field is JAX's (to float32 parity)."""
    g, r = tuple(got)[:len(ref)], tuple(ref)
    for i in range(5):  # x_rgb, x_bayer, psnr, ssim, psnr_trace
        np.testing.assert_allclose(g[i].numpy(), np.asarray(r[i]), atol=1e-3)
    # variables: the adapted FFDNet weights
    mine = tconvert.ffdnet_to_flax(g[5])["params"]
    for name, p in r[5]["params"].items():
        np.testing.assert_allclose(mine[name]["kernel"], np.asarray(p["kernel"]), atol=1e-5)
    # opt_state: the carried Adam, its step count and moments
    count, mu, _ = tconvert.adam_state_to_optax(g[6], TFFDNet(nc=nc, nb=nb),
                                                tconvert.ffdnet_to_flax)
    adam = r[6][0]
    assert count == int(adam.count) > 0
    for name, p in adam.mu.items():
        want = np.asarray(p["kernel"])
        np.testing.assert_allclose(mu[name]["kernel"], want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max() + 1e-30)
    for i in range(7, len(r)):  # dm_variables, dm_opt_state: unused here
        assert g[i] is None and r[i] is None


def test_positional_unpack_matches_jax():
    sc = make_scene(b=4, h=16, w=16, seed=4)
    (jprior, variables), (tprior, params) = ffdnet_pair(nc=8, nb=3)
    x0 = sc.orig_bayer * 0.9
    y, phi = jnp.asarray(sc.meas), jnp.asarray(sc.mask)
    ref = jadmm.two_stage_admm(y, phi, ADMMConfig(**KW, adapt=AdaptConfig(**ADAPT)), jprior,
                               variables, jnp.asarray(x0), jnp.asarray(sc.orig_bayer))
    got = tadmm.two_stage_admm(sc.meas, sc.mask,
                               tadmm.ADMMConfig(**KW, adapt=TAdaptConfig(**ADAPT)), tprior,
                               params, x0, sc.orig_bayer, device="cpu")
    assert got.opt_state is not None and got.resid_trace is None
    _check_unpack(got, ref, 8, 3)

    ref_e = jend.reconstruct_single_dispatch(
        y, phi, GapTVConfig(iters=5), ADMMConfig(**KW, adapt=AdaptConfig(**ADAPT)), jprior,
        variables, jnp.asarray(sc.orig_bayer))
    got_e = tend.reconstruct_single_dispatch(
        sc.meas, sc.mask, TGapTVConfig(iters=5),
        tadmm.ADMMConfig(**KW, adapt=TAdaptConfig(**ADAPT)), tprior, params,
        orig=sc.orig_bayer, device="cpu")
    assert got_e.opt_state is not None
    _check_unpack(got_e, ref_e, 8, 3)
