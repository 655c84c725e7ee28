"""The frame-sharded solve (``two_stage_admm``, ``gap_tv``,
``reconstruct_single_dispatch``, ``gap_deep`` and ``gap_denoise_gray`` with
``mesh=``), the split x-update and the adapting batched driver's ``mesh``.

Two gloo CPU processes run the ``frame_*`` and ``batched_adapt`` cases of
``adaptivepnp_sci_torch.multihost_validation`` once for this module, each
measurement's 8 frames split over a ``frame`` axis of 2 ranks (the batch over
a ``data`` axis of 2), while the test process computes the port's
one-process runs; each test holds both ranks against them and, where the JAX
package has the counterpart, against the JAX package on its 8-device virtual
mesh (``tests/conftest.py``).
"""

import importlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from adaptivepnp_sci_torch import multihost_validation as mv
from adaptivepnp_sci_torch.adapt import online as tonline
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.ops import cuda_kernels, physics as tphysics
from adaptivepnp_sci_tpu.adapt.online import AdaptConfig
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_tpu.models.ffdnet import FFDNet
from adaptivepnp_sci_tpu.ops import physics
from adaptivepnp_sci_tpu.parallel import make_mesh
from adaptivepnp_sci_tpu.parallel.sharded import fastdvd_prior_sharded
from adaptivepnp_sci_tpu.solvers import ADMMConfig
from adaptivepnp_sci_tpu.solvers.priors import ffdnet_prior
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz

jadmm = importlib.import_module("adaptivepnp_sci_tpu.solvers.two_stage_admm")
SIZES = mv.SIZES["cpu"]
NPROC = 2
CASES = mv.FRAME_CASES
#: a rank's arrays against the one-process run, in units of the larger of 1
#: and the array's largest magnitude: float32, the frame sums taken in the
#: same order (every rank sums all frames' terms), the PSNRs' squared errors
#: and the parameters' gradients summed in another
ONE_PROCESS = 1e-6
#: Adam moves a weight by about lr a step whatever its gradient, so where two
#: summation orders give a near-zero gradient opposite signs a weight parts by
#: 2 lr a step: each case's (lr, Adam steps) of the weights it adapts
ADAM_STEPS = {("frame_ffdnet", "variables"): (2e-6, 2), ("frame_dispatch", "variables"): (2e-6, 2),
              ("frame_fastdvd_adapt", "variables"): (2e-7, 4),
              ("frame_gap_deep", "variables"): (2e-6, 1),
              ("frame_loss_grad", "packed4_variables"): (2e-6, 2),
              ("frame_loss_grad", "bayer1_variables"): (2e-6, 2),
              ("frame_ddnet", "dm_variables"): (1e-6, 2)}
#: against the JAX package's frame-sharded solve (x_bayer, per-frame PSNR dB)
JAX_FRAME = (1e-5, 1e-4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results, and the one-process run of every case, computed
    here while the two workers run."""
    torch.set_num_threads(2)
    out = tmp_path_factory.mktemp("ranks")
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(mv.launch, NPROC, str(out), "cpu", "gloo", CASES, "cpu")
        oracles = {name: mv.run_case(name, None, "cpu", SIZES) for name in CASES
                   if name not in mv.REFUSALS | mv.MUST_FAIL}
        return ranks.result(), oracles


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def oracle(runs):
    return runs[1].__getitem__


def results(ranks, name):
    return [mv.outputs(r[name]) for r in ranks]


def scaled_gap(got, want):
    return float(np.abs(got.astype(np.float64) - want).max()) / max(1.0, float(np.abs(want).max()))


def test_every_rank_ran_every_case_on_the_plain_path(ranks):
    for r in ranks:
        assert set(r) == set(CASES)
        for case in r.values():
            assert all(int(v) == 0 for k, v in case.items() if k.startswith("launches__"))


def start_weights(name: str, key: str) -> np.ndarray:
    """The flat weights an adapting case starts from."""
    if key == "dm_variables":
        return mv._state_flat(tconvert.ddnet_from_flax(load_variables_npz(
            str(mv.WEIGHTS / "ddnet.npz"))))
    if name in ("frame_ffdnet", "frame_dispatch") or key.startswith("packed4"):
        return mv._state_flat(mv.small_ffdnet().state_dict())
    return mv._state_flat(mv._fastdvd_params())


@pytest.mark.parametrize("name", [c for c in CASES if c not in mv.REFUSALS | mv.MUST_FAIL])
def test_ranks_match_the_one_process_run(ranks, oracle, name):
    """Every array within 1e-6 (scaled) of the port's one-process run, the
    adapted weights within Adam's opposite-sign bound (:data:`ADAM_STEPS`)
    and moved, and both ranks alike."""
    want = oracle(name)
    a, b = results(ranks, name)
    assert set(a) == set(want)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
        if (name, key) in ADAM_STEPS:
            lr, steps = ADAM_STEPS[name, key]
            gap = float(np.abs(a[key] - want[key]).max())
            print(f"{name}/{key}: max |dw| {gap:.2e} (bound {2 * lr * steps:.1e})")
            assert gap <= 2 * lr * steps
            assert np.abs(a[key] - start_weights(name, key)).max() > 0  # adapted
            continue
        gap = scaled_gap(a[key], want[key])
        print(f"{name}/{key}: {gap:.2e}")
        assert gap <= ONE_PROCESS, (key, gap)


def test_refusals(ranks):
    """The tiled driver, a ``demosaic_fn`` and a prior without a frame form
    raise ``NotImplementedError`` naming the frame axis; DDnet on one frame a
    rank raises the halo's "too many shards"."""
    for got in results(ranks, "frame_refusals"):
        assert set(got) == {"tiled", "demosaic_fn", "prior", "too_many_shards"}
        assert all(bool(v) for v in got.values()), got


def test_adaptation_gradient_is_the_unsharded_one(ranks, oracle):
    """The adaptation loss's gradient in both loss modes, after
    ``Prior.reduce_grads``, is the one-process gradient (norm ratio 1 within
    1e-6); with the loss's frame sum reduced by ``all_reduce_sum``, whose
    backward sums every rank's upstream gradient, it comes out twice as
    large, and the comparison fails (a mutation check)."""
    want = oracle("frame_loss_grad")
    for got in results(ranks, "frame_loss_grad"):
        for mode, ratio in mv.grad_norm_ratios(got, want).items():
            assert abs(ratio - 1.0) <= 1e-6, (mode, ratio)
            np.testing.assert_allclose(got[mode], want[mode], rtol=0,
                                       atol=1e-5 * np.abs(want[mode]).max())
    for got in results(ranks, "frame_loss_grad_all_reduce_sum"):
        ratios = mv.grad_norm_ratios(got, want)
        assert all(abs(r - NPROC) <= 1e-3 for r in ratios.values()), ratios
        for mode in ("packed4", "bayer1"):
            gap = float(np.abs(got[f"{mode}_variables"] - want[f"{mode}_variables"]).max())
            print(f"{mode}: the doubled gradient's weights {gap:.2e} from one process' "
                  f"(Adam's step is blind to a gradient's scale beyond its epsilon)")
            with pytest.raises(AssertionError):
                np.testing.assert_allclose(got[f"{mode}_grads"], want[f"{mode}_grads"], rtol=0,
                                           atol=1e-5 * np.abs(want[f"{mode}_grads"]).max())


def test_frame_sharded_fastdvd_matches_jax(ranks):
    """``frame_fastdvd`` against the JAX package's solve with ``phi`` placed
    ``P('frame')`` on a ``data=2, frame=4`` mesh and its frame-sharded prior
    (``tests/test_parallel.py::test_solver_with_frame_sharded_inputs``), on
    ``weights/fastdvd.npz``: x_bayer within 1e-5, per-frame PSNR within 1e-4
    dB."""
    variables = load_variables_npz(str(mv.WEIGHTS / "fastdvd.npz"))
    mesh = make_mesh(data=2, frame=4)
    sc = make_scene(b=8, h=SIZES.side, w=SIZES.side, seed=mv.FRAME_SEED)
    phi = jax.device_put(jnp.asarray(sc.mask), NamedSharding(mesh, P("frame")))
    ref = jadmm.two_stage_admm(sc.meas, phi, ADMMConfig(sigma=(12 / 255,), iters=(3,),
                                                        denoiser="fastdvd"),
                               prior=fastdvd_prior_sharded(FastDVDnet(), mesh),
                               variables=variables, orig_bayer=sc.orig_bayer)
    for got in results(ranks, "frame_fastdvd"):
        dx = float(np.abs(got["x_bayer"] - np.asarray(ref.x_bayer)).max())
        db = float(np.abs(got["psnr"] - np.asarray(ref.psnr_per_frame)).max())
        print(f"frame_fastdvd vs JAX: max |dx| {dx:.2e}, {db:.2e} dB")
        assert dx <= JAX_FRAME[0] and db <= JAX_FRAME[1]


def test_adapting_batched_mesh_matches_jax(ranks):
    """The FFDNet run of ``batched_adapt`` (no draws: FFDNet adds no input
    noise) against the JAX batched driver with the batch placed ``P('data')``:
    x_bayer within 1e-5, per-frame PSNR within 1e-4 dB."""
    net = mv.small_ffdnet()
    variables = tconvert.ffdnet_to_flax(net.state_dict())
    sc = make_scene(b=4, h=SIZES.side, w=SIZES.side, seed=14, n_meas=4)
    y4 = jax.device_put(jnp.asarray(sc.meas.transpose(2, 0, 1)),
                        NamedSharding(make_mesh(data=4, frame=2), P("data")))
    ref = jadmm.two_stage_admm_batched(
        y4, jnp.asarray(sc.mask), ADMMConfig(sigma=(25 / 255,), iters=(3,),
                                             adapt=AdaptConfig(**mv.FRAME_ADAPT)),
        prior=ffdnet_prior(FFDNet(in_nc=3, out_nc=3, nc=8, nb=3)), variables=variables,
        orig_batch=jnp.asarray(sc.orig_bayer))
    for got in results(ranks, "batched_adapt"):
        dx = float(np.abs(got["ffdnet_x_bayer"] - np.asarray(ref.x_bayer)).max())
        db = float(np.abs(got["ffdnet_psnr"] - np.asarray(ref.psnr_per_frame)).max())
        print(f"batched_adapt vs JAX: max |dx| {dx:.2e}, {db:.2e} dB")
        assert dx <= 1e-5 and db <= 1e-4


class _Halves:
    """One process standing in for two frame ranks: ``gather`` puts the other
    rank's frames beside this one's."""

    def __init__(self, other, first: bool):
        self.other, self.first = other, first

    def gather(self, t, dim):
        return torch.cat([t, self.other] if self.first else [self.other, t], dim)


@pytest.mark.parametrize("form", ["admm", "gap", "gap_lam", "items_shared_phi"])
def test_split_x_update_is_the_fused_form_bit_for_bit(rng, form):
    """The split form over two emulated ranks of 4 frames each (the partial
    pass on each half, the terms of both gathered, the finish on each half)
    equals the one-process x-update bit for bit, and JAX's within 1e-6."""
    items = (2,) if form == "items_shared_phi" else ()
    theta, b = (torch.from_numpy(rng.random(items + (8, 4, 6, 6), dtype=np.float32))
                for _ in range(2))
    phi = torch.from_numpy((rng.random((8, 4, 6, 6)) > 0.5).astype(np.float32))
    y = torch.from_numpy(rng.random(items + (4, 6, 6), dtype=np.float32))
    phi_s = tphysics.phi_sum(phi)
    sign, rho, c, lam = {"admm": (-1.0, 0.55, 0.55, 1.0), "gap": (1.0, 1.0, 0.01, 1.0),
                         "gap_lam": (1.0, 1.0, 0.01, 0.5),
                         "items_shared_phi": (-1.0, 0.55, 0.55, 1.0)}[form]
    jargs = [jnp.asarray(t.numpy()) for t in (theta, b, y, phi, phi_s)]
    ref = None  # JAX's x-updates take no item axis
    if sign < 0:
        whole = tphysics.admm_x_update(theta, b, y, phi, phi_s, rho, c / rho)
        if not items:
            ref = physics.admm_x_update(*jargs, rho, c / rho)
    else:
        whole = tphysics.gap_x_update(theta, b, y, phi, phi_s, lam, c)
        ref = physics.gap_x_update(*jargs, lam, c)
    fa = tphysics.PACKED_FRAME_AXIS
    halves = [slice(0, 4), slice(4, 8)]
    terms = [tphysics.x_update_partial(theta[..., h, :, :, :], b[..., h, :, :, :], phi[h], sign,
                                       rho)[1] for h in halves]
    parts = []
    for i, h in enumerate(halves):
        frame = _Halves(terms[1 - i], first=i == 0)
        kernel = cuda_kernels.admm_x_update if sign < 0 else cuda_kernels.gap_x_update
        args = (rho, c / rho) if sign < 0 else (lam, c)
        parts.append(kernel(theta[..., h, :, :, :], b[..., h, :, :, :], y, phi[h], phi_s, *args,
                            frame=frame))
    assert torch.equal(torch.cat(parts, fa), whole)
    if ref is not None:
        np.testing.assert_allclose(whole.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_phi_sum_guards_after_the_frame_sum():
    """A pixel that only the second rank's frames sample: the reduced
    ``phi_sum`` is its real mask energy on both ranks; a guard on each rank's
    own sum would add 1 for the rank that never samples it."""
    phi = torch.zeros(8, 4, 2, 2)
    phi[5, 0, 0, 0] = 1.0  # sampled once, by the second rank's frames
    phi[:, 1] = 1.0
    want = tphysics.phi_sum(phi)
    for i, h in enumerate((slice(0, 4), slice(4, 8))):
        other = phi[slice(4, 8) if i == 0 else slice(0, 4)]
        got = tphysics.phi_sum(phi[h], gather=_Halves(other, first=i == 0).gather)
        assert torch.equal(got, want)
    per_rank = tphysics.phi_sum(phi[:4]) + tphysics.phi_sum(phi[4:])
    assert float(want[0, 0, 0]) == 1.0 and float(per_rank[0, 0, 0]) == 2.0
    assert float(want[2, 0, 0]) == 1.0  # never sampled: the guard's 1


@pytest.mark.parametrize("solver", ["two_stage_admm", "batched", "gap_deep", "dispatch"])
def test_default_generator_is_a_cpu_generator(monkeypatch, solver):
    """With ``generator=None`` each adapting solver draws from a CPU
    generator seeded with 0 (so the draws do not depend on the device the
    solve runs on): the same result as with that generator given, every
    trigger's draws made on the CPU."""
    from adaptivepnp_sci_torch import (ADMMConfig as TADMMConfig, AdaptConfig as TAdaptConfig,
                                       FastDVDnet as TFastDVDnet, GapDeepConfig, GapTVConfig,
                                       fastdvd_prior, gap_deep, reconstruct_single_dispatch,
                                       two_stage_admm, two_stage_admm_batched)

    devices = []
    draws = tonline.trigger_draws

    def spy(prior, cfg, generator, shape):
        devices.append(generator.device.type)
        return draws(prior, cfg, generator, shape)

    monkeypatch.setattr(tonline, "trigger_draws", spy)
    monkeypatch.setattr("adaptivepnp_sci_torch.solvers.two_stage_admm.trigger_draws", spy)
    sc = make_scene(b=4, h=16, w=16, seed=5, n_meas=2)
    params = mv._fastdvd_params()
    adapt = TAdaptConfig(**mv.FRAME_ADAPT)
    prior = fastdvd_prior(TFastDVDnet())
    cfg = TADMMConfig(sigma=(12 / 255,), iters=(3,), denoiser="fastdvd", adapt=adapt)
    y, orig = sc.meas[..., 0], sc.orig_bayer[0]
    run = {
        "two_stage_admm": lambda g: two_stage_admm(y, sc.mask, cfg, prior, params,
                                                   orig_bayer=orig, device="cpu", generator=g),
        "batched": lambda g: two_stage_admm_batched(np.moveaxis(sc.meas, -1, 0), sc.mask, cfg,
                                                    prior, params, device="cpu", generator=g),
        "gap_deep": lambda g: gap_deep(y, sc.mask, GapDeepConfig(sigma=(12 / 255,), iters=(3,),
                                                                 denoiser="fastdvd", adapt=adapt),
                                       prior, params, device="cpu", generator=g),
        "dispatch": lambda g: reconstruct_single_dispatch(
            y, sc.mask, GapTVConfig(iters=5), cfg, prior, params, device="cpu", generator=g),
    }[solver]
    default = run(None)
    assert devices and set(devices) == {"cpu"}
    given = run(torch.Generator().manual_seed(0))
    assert torch.equal(default.x_bayer, given.x_bayer)
