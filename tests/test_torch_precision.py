"""FFDNet's precision modes and the solvers' kernel switch against the JAX
package, on the CPU.

* ``FFDNet(dtype=, interior_dtype=)`` in each mode against JAX's FFDNet in
  the same mode at 1x32x32x3, from Flax-initialised weights of the colour
  width (nc 96, nb 12). Bars: float32 1e-6 absolute (2.6e-8 measured);
  mixed and bf16 max 3e-4 and mean 5e-5 absolute (1.0e-4 / 1.8e-5 and
  1.2e-4 / 1.8e-5 measured), against a mode effect of 2.4e-4 / 1.9e-4 (JAX's
  mode against its float32). Both packages round each bf16 convolution's
  float32 sum once and add the bias in bf16; their float32 sums run in other
  orders, so now and then a sum rounds to the neighbouring bf16 value, and
  ten layers carry that on. At nc 16, nb 4 the bf16 mode is bit for bit
  JAX's.
* The default mode is the float32 ``Sequential`` of the parent, bit for bit,
  and in the reduced modes the gradients reach float32 parameters.
* ``ab_ffdnet_precision.precision_row`` (the warm start and the flagship's
  two-stage solve, adaptation firing twice) at 32x32x8 with a narrow FFDNet
  (nc 16, nb 4) in the mixed and bf16 modes against JAX's
  ``reconstruct_single_dispatch`` with the same model: per-frame PSNR within
  1e-3 dB (5.4e-4 / 6.0e-4 measured), max |dx| 1e-2 and mean |dx| 1e-3
  (4.3e-3 / 4.9e-3 and 2.6e-4 / 3.4e-4 measured). That is the size of a
  bf16 rounding on [0, 1] values: inputs that differ by float32 rounding
  (5e-7 in the float32 mode) round now and then to neighbouring bf16
  values, and the loop carries that on; JAX's own mode against its float32
  moves x by 5.2e-3 / 5.7e-3 (mean 3.2e-4 / 4.3e-4) on the same run.
* ``use_kernels``: None and False give the same results bit for bit on the
  CPU (GAP-TV, the ADMM TV denoiser with the held-out guard, the FFDNet
  solve, ``gap_deep``); True is refused on CPU tensors with a ValueError.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch import ab_ffdnet_precision as tprec
from adaptivepnp_sci_torch import studies
from adaptivepnp_sci_torch.models import common as tcommon
from adaptivepnp_sci_torch.models.convert import ffdnet_from_flax
from adaptivepnp_sci_torch.models.ffdnet import FFDNet as TFFDNet
from adaptivepnp_sci_torch.ops import cuda_kernels
from adaptivepnp_sci_torch.solvers import gap_deep as tgd
from adaptivepnp_sci_torch.solvers import gap_tv as tgap
from adaptivepnp_sci_torch.solvers import two_stage_admm as tadmm
from adaptivepnp_sci_torch.solvers.end_to_end import reconstruct_single_dispatch as trecon
from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior as tffdnet_prior
from adaptivepnp_sci_tpu.adapt.online import AdaptConfig
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models.ffdnet import FFDNet
from adaptivepnp_sci_tpu.solvers import ADMMConfig, GapTVConfig
from adaptivepnp_sci_tpu.solvers.end_to_end import reconstruct_single_dispatch
from adaptivepnp_sci_tpu.solvers.priors import ffdnet_prior
from test_torch_solver_modes import jax_mask

MODES = {"fp32": ({}, {}), "mixed": ({"interior_dtype": jnp.bfloat16},
                                     {"interior_dtype": torch.bfloat16}),
         "bf16": ({"dtype": jnp.bfloat16}, {"dtype": torch.bfloat16})}
#: mode -> (max, mean) absolute bar of the 1x32x32x3 apply
APPLY_BAR = {"fp32": (1e-6, 1e-6), "mixed": (3e-4, 5e-5), "bf16": (3e-4, 5e-5)}
#: the solve's bars in the reduced modes: dB, max |dx|, mean |dx|
DB, DX, DX_MEAN = 1e-3, 1e-2, 1e-3
#: the flagship's schedule cut to 7 iterations, adaptation at k = 3 and 6
ITERS = (3, 2, 2)
INTERVAL = 3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def flax_variables(nc, nb, seed=0):
    v = FFDNet(nc=nc, nb=nb).init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)),
                                  jnp.float32(0.1))
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.fixture(scope="module")
def color_variables():
    return flax_variables(96, 12)


def port_net(variables, nc, nb, **kw):
    net = TFFDNet(nc=nc, nb=nb, **kw)
    net.load_state_dict(ffdnet_from_flax(variables))
    return net.eval()


@pytest.mark.parametrize("mode", list(MODES))
def test_ffdnet_mode_matches_jax(color_variables, mode):
    jkw, tkw = MODES[mode]
    x = np.random.default_rng(0).random((1, 32, 32, 3), dtype=np.float32)
    sigma = np.float32(25 / 255)
    want = np.asarray(FFDNet(nc=96, nb=12, **jkw).apply(color_variables, jnp.asarray(x),
                                                          jnp.float32(sigma)))
    net = port_net(color_variables, 96, 12, **tkw)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.tensor(sigma)).numpy()
    assert got.dtype == np.float32
    d = np.abs(got - want)
    print(f"{mode}: max {d.max():.3e}, mean {d.mean():.3e}")
    assert d.max() <= APPLY_BAR[mode][0] and d.mean() <= APPLY_BAR[mode][1]


def test_default_mode_is_the_float32_sequential(color_variables):
    """The default forward, and one with both types float32 by name, equal
    the parent's path (the Sequential on the padded, unshuffled input) bit
    for bit."""
    x = torch.from_numpy(np.random.default_rng(1).random((2, 17, 19, 3), dtype=np.float32))
    sigma = torch.tensor([0.05, 0.2])
    net = port_net(color_variables, 96, 12)
    named = port_net(color_variables, 96, 12, dtype=torch.float32,
                     interior_dtype=torch.float32)
    with torch.no_grad():
        v, _, _ = tcommon.replication_pad_to_even(x.permute(0, 3, 1, 2))
        v = tcommon.space_to_depth(v, 2)
        smap = sigma.reshape(-1, 1, 1, 1).expand(v.shape[0], 1, v.shape[2], v.shape[3])
        want = tcommon.depth_to_space(net.model(torch.cat([v, smap], 1)), 2)
        want = want[:, :, :17, :19].permute(0, 2, 3, 1)
        assert torch.equal(net(x, sigma), want)
        assert torch.equal(named(x, sigma), want)


@pytest.mark.parametrize("mode", ["mixed", "bf16"])
def test_reduced_modes_train_float32_parameters(mode):
    net = port_net(flax_variables(16, 4), 16, 4, **MODES[mode][1])
    x = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    net(x, torch.tensor(0.1)).square().mean().backward()
    for p in net.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0


@pytest.fixture(scope="module")
def scene():
    return make_scene(b=8, h=32, w=32, seed=42)


@pytest.mark.parametrize("mode", ["mixed", "bf16"])
def test_flagship_row_matches_jax(scene, mode):
    jkw, tkw = MODES[mode]
    variables = flax_variables(16, 4)
    adapt = dict(lr=2e-6, update_per_iter=2, interval_iter=INTERVAL, initial_iter=1)
    jcfg = ADMMConfig(sigma=studies.FLAGSHIP_SIGMA, iters=ITERS, denoiser="ffdnet",
                      adapt=AdaptConfig(**adapt))
    want = reconstruct_single_dispatch(
        jnp.asarray(scene.meas), jnp.asarray(scene.mask), GapTVConfig(iters=40), jcfg,
        ffdnet_prior(FFDNet(nc=16, nb=4, **jkw)), variables, orig=jnp.asarray(scene.orig_bayer))
    tcfg = studies.flagship_config(iters=ITERS, adapt=dataclasses.replace(
        studies.FLAGSHIP_ADAPT, interval_iter=INTERVAL))
    _, got = tprec.precision_row(scene, TFFDNet(nc=16, nb=4, **tkw), ffdnet_from_flax(variables),
                                 tcfg, "cpu", n=0)
    p_gap = float(np.abs(got.psnr_per_frame.numpy() - np.asarray(want.psnr_per_frame)).max())
    dx = np.abs(got.x_bayer.numpy() - np.asarray(want.x_bayer))
    print(f"{mode}: {p_gap:.3e} dB, max |dx| {dx.max():.3e}, mean {dx.mean():.3e}, "
          f"{float(want.psnr_per_frame.mean()):.4f} dB")
    assert p_gap <= DB and dx.max() <= DX and dx.mean() <= DX_MEAN


# ------------------------------------------------------------- use_kernels

@pytest.fixture(scope="module")
def small():
    sc = make_scene(b=4, h=16, w=16, seed=3)
    params = ffdnet_from_flax(flax_variables(8, 3))
    return sc, params


def _solves(sc, params, use):
    """Every solver the switch reaches, on the CPU, with ``use_kernels=use``."""
    prior = tffdnet_prior(TFFDNet(nc=8, nb=3))
    out = {"gap_tv": tgap.gap_tv(sc.meas, sc.mask, tgap.GapTVConfig(iters=5, use_kernels=use),
                                 orig_bayer=sc.orig_bayer, device="cpu")}
    tv = tadmm.ADMMConfig(sigma=(0.0,), iters=(4,), denoiser="tv", select_best=True,
                          select_best_holdout=0.05, select_best_warm_iters=5, use_kernels=use)
    out["admm_tv_guard"] = tadmm.two_stage_admm(sc.meas, sc.mask, tv, x0_bayer=None,
                                                orig_bayer=sc.orig_bayer, device="cpu")
    cfg = tadmm.ADMMConfig(sigma=(25 / 255, 12 / 255), iters=(2, 2), use_kernels=use)
    out["dispatch"] = trecon(sc.meas, sc.mask, tgap.GapTVConfig(iters=3, use_kernels=use), cfg,
                             prior, params, orig=sc.orig_bayer, device="cpu")
    gcfg = tgd.GapDeepConfig(sigma=(25 / 255,), iters=(3,), use_kernels=use)
    out["gap_deep"] = tgd.gap_deep(sc.meas, sc.mask, gcfg, prior, params,
                                   orig_bayer=sc.orig_bayer, device="cpu")
    return out


def test_use_kernels_none_and_false_agree_bit_for_bit(small, monkeypatch):
    monkeypatch.setattr(tadmm, "holdout_mask", jax_mask)
    sc, params = small
    auto, plain = _solves(sc, params, None), _solves(sc, params, False)
    for name in auto:
        assert torch.equal(auto[name].x_bayer, plain[name].x_bayer), name
        assert torch.equal(auto[name].psnr_trace, plain[name].psnr_trace), name


def test_use_kernels_true_refused_on_cpu(small):
    sc, params = small
    prior = tffdnet_prior(TFFDNet(nc=8, nb=3))
    with pytest.raises(ValueError, match="use_kernels=True"):
        tgap.gap_tv(sc.meas, sc.mask, tgap.GapTVConfig(iters=2, use_kernels=True), device="cpu")
    with pytest.raises(ValueError, match="use_kernels=True"):
        tadmm.two_stage_admm(sc.meas, sc.mask, tadmm.ADMMConfig(
            sigma=(25 / 255,), iters=(2,), use_kernels=True), prior, params, device="cpu")
    with pytest.raises(ValueError, match="use_kernels=True"):
        tgd.gap_deep(sc.meas, sc.mask, tgd.GapDeepConfig(sigma=(25 / 255,), iters=(2,),
                                                         use_kernels=True),
                     prior, params, device="cpu")
    planes = torch.rand(2, 4, 8, 8)
    with pytest.raises(ValueError, match="use_kernels=True"):
        cuda_kernels.tv_chambolle_fused(planes, use_kernels=True)
    assert torch.equal(cuda_kernels.tv_chambolle_fused(planes, use_kernels=False),
                       cuda_kernels.tv_chambolle_fused(planes))
