"""Port DDnet demosaicking inside the solver vs the JAX package on the CPU:
the fixed-weight demosaicker and its in-scan adaptation (``dm_update``, a
fresh or a carried Adam), on the scene and bars of
``tests/test_torch_solver_modes.py``."""

import jax
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.ddnet import DDnet as TDDnet
from adaptivepnp_sci_torch.solvers import two_stage_admm as tadmm
from adaptivepnp_sci_torch.solvers.priors import ddnet_demosaic as tddnet_demosaic
from adaptivepnp_sci_tpu.models.ddnet import DDnet
from adaptivepnp_sci_tpu.solvers.priors import ddnet_demosaic
from adaptivepnp_sci_tpu.solvers.two_stage_admm import make_dm_spec
from test_torch_solver_modes import ITERS, SIGMA, ddnet_vars, ffdnet, scene, solve_both  # noqa: F401
from test_torch_solvers import assert_parity


def test_ddnet_demosaicker_matches_jax(scene, ffdnet, ddnet_vars):
    """FFDNet with the fixed-weight DDnet demosaicker and a trigger at k = 3."""
    sc, x0 = scene
    kw = dict(sigma=SIGMA, iters=ITERS, demosaic_method="ddnet")
    ref, got = solve_both(
        sc, x0, ffdnet, kw, dict(lr=2e-6, interval_iter=3),
        jax_extra=dict(demosaic_fn=ddnet_demosaic(DDnet(), ddnet_vars)),
        port_extra=dict(demosaic_fn=tddnet_demosaic(TDDnet(), tconvert.ddnet_from_flax(ddnet_vars))))
    assert_parity(got, ref)
    np.testing.assert_allclose(got.x_rgb.numpy(), np.asarray(ref.x_rgb), atol=1e-3)
    assert got.dm_variables is None and got.resid_trace is None


@pytest.mark.parametrize("fresh_opt", [False, True])
def test_in_scan_dm_update_matches_jax(scene, ffdnet, ddnet_vars, fresh_opt):
    """One Adam step on DDnet per iteration (3 in all) at lr 1e-5: the result,
    and the refined demosaicker within 3 lr of JAX's everywhere and within
    5 % of lr for 99 % of its weights."""
    sc, x0 = scene
    lr = 1e-5
    params = tconvert.ddnet_from_flax(ddnet_vars)
    ref, got = solve_both(
        sc, x0, ffdnet, dict(sigma=SIGMA, iters=(2, 1)),
        jax_extra=dict(dm_spec=make_dm_spec(DDnet(), lr, fresh_opt=fresh_opt),
                       dm_variables=ddnet_vars),
        port_extra=dict(dm_spec=tadmm.make_dm_spec(TDDnet(), lr, fresh_opt=fresh_opt),
                        dm_variables=params))
    assert_parity(got, ref)
    want = tconvert.ddnet_from_flax(jax.tree_util.tree_map(np.asarray, ref.dm_variables))
    n_far = n_all = 0
    for k, w in want.items():
        diff = (got.dm_variables[k] - w).abs()
        assert float(diff.max()) <= 3 * lr + 1e-8, k
        n_far += int((diff > 0.05 * lr).sum())
        n_all += diff.numel()
    assert n_far <= 0.01 * n_all, (n_far, n_all)
    steps = {float(s["step"]) for s in got.dm_opt_state["state"].values()}
    assert steps == {1 if fresh_opt else 3}
    assert all(torch.equal(params[k], v) for k, v in tconvert.ddnet_from_flax(ddnet_vars).items())
