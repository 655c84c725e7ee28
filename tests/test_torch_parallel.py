"""The port's parallel paths (``adaptivepnp_sci_torch.parallel``, the tiled
and batched drivers' ``mesh``, ``TrainerConfig.mesh``) across two processes.

Two gloo CPU processes run every case of
``adaptivepnp_sci_torch.multihost_validation`` once for this module (a
``file://`` rendezvous in a temporary directory, one thread each) and write
their results; each test holds both ranks' results against the port's
one-process run of the same case and, where the JAX package has the
counterpart, against the JAX package on its 8-virtual-device mesh
(``tests/conftest.py``). The one-process FastDVDnet ``Trainer`` and solver
are held to JAX's by ``test_torch_trainer`` and ``test_torch_solvers``, so
their cases are held to the port's one-process run here.
"""

import importlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from adaptivepnp_sci_torch import multihost_validation as mv
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.parallel import make_mesh as tmake_mesh
from adaptivepnp_sci_torch.parallel.distributed import default_backend, global_mesh
from adaptivepnp_sci_torch.train import augment as taugment
from adaptivepnp_sci_torch.train import tasks as ttasks
from adaptivepnp_sci_torch.solvers.priors import window_indices
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_tpu.models.ffdnet import FFDNet
from adaptivepnp_sci_tpu.parallel import halo_windows, make_mesh
from adaptivepnp_sci_tpu.parallel.sharded import make_dp_train_step
from adaptivepnp_sci_tpu.solvers import ADMMConfig
from adaptivepnp_sci_tpu.adapt.online import AdaptConfig
from adaptivepnp_sci_tpu.solvers.priors import fastdvd_prior, ffdnet_prior
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz

jadmm = importlib.import_module("adaptivepnp_sci_tpu.solvers.two_stage_admm")
SIZES = mv.SIZES["cpu"]
NPROC = 2
#: the cases of the parallel paths; the frame-sharded solve's are
#: ``tests/test_torch_frame_sharded.py``'s
CASES = [c for c in mv.DEFAULT_CASES["cpu"] if c not in mv.FRAME_CASES]
#: the port's ranks against its one-process run: float32 differing only in
#: summation order across ranks (scaled by the larger of 1 and the array's
#: largest magnitude, as ``multihost_validation.compare``)
ONE_PROCESS = mv.TOLERANCES["default"]
#: per-frame PSNR against the JAX package's tiled and batched ``mesh`` runs
#: (the drivers' bar, ``test_torch_drivers``)
JAX_DB = 4e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results, and the one-process run of every case, computed
    here while the two workers run."""
    torch.set_num_threads(2)
    out = tmp_path_factory.mktemp("ranks")
    cases = CASES
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(mv.launch, NPROC, str(out), "cpu", "gloo", cases, "cpu")
        oracles = {name: mv.run_case(name, None, "cpu", SIZES) for name in cases}
        return ranks.result(), oracles


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def oracle(runs):
    return runs[1].__getitem__


def psnr64(x, orig):
    """Per-frame PSNR (peak 1) in float64."""
    mse = np.mean((x.astype(np.float64) - orig.astype(np.float64)) ** 2, axis=(-2, -1))
    return 10.0 * np.log10(1.0 / mse)


def results(ranks, name):
    return [mv.outputs(r[name]) for r in ranks]


def test_every_rank_ran_every_case_on_the_plain_path(ranks):
    for r in ranks:
        assert set(r) == set(CASES)
        for case in r.values():
            # CPU tensors: every kernel wrapper took its plain version
            assert all(int(v) == 0 for k, v in case.items() if k.startswith("launches__"))
            assert case["launches_by_shape"].size == 0


@pytest.mark.parametrize("name", ["halo", "prior", "prior_grad", "dp_step", "trainer", "solver",
                                  "solver_adapt", "tiled", "tiled_guard", "tiled_dm", "batched"])
def test_ranks_match_the_one_process_run(ranks, oracle, name):
    for got in results(ranks, name):
        worst = mv.compare(name, got, oracle(name))
        print(f"{name}: max scaled |d| {worst:.2e} (bar {ONE_PROCESS})")


def test_halo_windows_match_jax(ranks):
    rgb = np.random.default_rng(0).random((8, 4, 4, 3), dtype=np.float32)
    mesh = make_mesh(data=1, frame=NPROC)
    for window in (5, 3):
        ref = jax.shard_map(lambda x: halo_windows(x, "frame", window), mesh=mesh,  # noqa: B023
                            in_specs=P("frame"), out_specs=P("frame"), check_vma=False)(
            jax.device_put(jnp.asarray(rgb), NamedSharding(mesh, P("frame"))))
        for got in results(ranks, "halo"):
            np.testing.assert_array_equal(got[f"win{window}"], np.asarray(ref))
            np.testing.assert_array_equal(got[f"win{window}"],
                                          rgb[window_indices(8, window).numpy()])
    # the backward routes each halo's gradient to the frames it came from:
    # d/d rgb of sum(windows * w) gathers w back over the windows
    wts = np.random.default_rng(1).random((8, 5, 4, 4, 3), dtype=np.float32)
    want = np.zeros_like(rgb)
    np.add.at(want, window_indices(8, 5).numpy(), wts)
    for got in results(ranks, "halo"):
        np.testing.assert_allclose(got["grad"], want, rtol=1e-6)


def test_too_many_shards_raises_like_jax(ranks):
    for got in results(ranks, "too_many_shards"):
        assert int(got["raised"]) == 1 and bool(got["too_many_shards"])
    # JAX's refusal: 5-frame windows of 8 frames over 8 shards
    mesh = make_mesh(data=1, frame=8)
    with pytest.raises(ValueError, match="too many shards"):
        jax.shard_map(lambda x: halo_windows(x, "frame", 5), mesh=mesh, in_specs=P("frame"),
                      out_specs=P("frame"), check_vma=False)(jnp.zeros((8, 4, 4, 3)))
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        tmake_mesh(data=2, frame=2)


def test_sharded_prior_forms_match_jax(ranks):
    """Both forms, and B_local = 1 with B = 2 (the shared-triplet form only:
    the per-window one needs two frames a rank), against JAX's unsharded
    prior on ``weights/fastdvd.npz``; bar 2e-5 absolute, FastDVDnet's parity
    bar (PR 2)."""
    variables = load_variables_npz(str(mv.WEIGHTS / "fastdvd.npz"))
    jprior = fastdvd_prior(FastDVDnet())
    for b in (8, 2):
        rgb = np.random.default_rng(2 + b).random((b, SIZES.side, SIZES.side, 3),
                                                  dtype=np.float32)
        ref = np.asarray(jprior.apply(variables, jnp.asarray(rgb), jnp.float32(0.1)))
        for got in results(ranks, "prior"):
            forms = ("shared", "window") if b // NPROC >= 2 else ("shared",)
            assert {f"fp32_{f}_b{b}" for f in forms} <= set(got)
            for form in forms:
                np.testing.assert_allclose(got[f"fp32_{form}_b{b}"], ref, rtol=0, atol=2e-5)


def test_sharded_prior_gradient_is_the_unsharded_one(ranks, oracle):
    """Each rank steps with the gradient of the unsharded prior: not the
    rank's share of it, and not ``world`` times it."""
    want = oracle("prior_grad")["grads"]
    for got in results(ranks, "prior_grad"):
        ratio = np.linalg.norm(got["grads"]) / np.linalg.norm(want)
        assert abs(ratio - 1.0) < 1e-6, ratio
        np.testing.assert_allclose(got["grads"], want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_dp_step_matches_single_device(ranks, oracle):
    """The loss within 1e-6 of the one-process step's and of the JAX DP
    step's (same initial weights), the parameters rtol 1e-5 (JAX's bars)."""
    want = oracle("dp_step")
    net = mv.small_ffdnet()
    variables = tconvert.ffdnet_to_flax(net.state_dict())
    model = FFDNet(in_nc=3, out_nc=3, nc=8, nb=3)
    optimizer = optax.adam(1e-3)
    rng = np.random.default_rng(1)
    noisy = jnp.asarray(rng.random((16, 8, 8, 3), dtype=np.float32))
    clean = jnp.asarray(rng.random((16, 8, 8, 3), dtype=np.float32))
    sigma = jnp.full((16,), 0.1, jnp.float32)
    step, place = make_dp_train_step(model, optimizer, make_mesh(data=4, frame=2))
    _, _, jloss = step(*place(variables, optimizer.init(variables), noisy, clean, sigma))
    for got in results(ranks, "dp_step"):
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-6
        assert abs(float(got["loss"]) - float(jloss)) <= 1e-6
        np.testing.assert_allclose(got["params"], want["params"], rtol=1e-5, atol=1e-7)


def test_dp_trainer_matches_one_process_trainer(ranks, oracle):
    """Two FastDVDnet steps (lr 1e-6) at 2 x 2 clips of 16^2 against one
    process at 4: losses rtol 1e-6, parameters 1e-5, BatchNorm's running
    statistics 1e-5 of the largest (train mode over the global batch on
    both)."""
    want = oracle("trainer")
    for got in results(ranks, "trainer"):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        np.testing.assert_allclose(got["params"], want["params"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["stats"], want["stats"], rtol=0,
                                   atol=1e-5 * np.abs(want["stats"]).max())
        init = mv._fastdvd_params()
        start = mv._flat([init[k] for k in sorted(init)
                          if k.endswith(("weight", "bias")) and "running" not in k])
        assert np.abs(got["params"] - start).max() > 0  # the steps moved the weights


#: each per-sample draw of the training tasks, for ``n`` samples
SHARDED_DRAWS = {
    "modes": lambda g, n: taugment.draw_modes(g, n),
    "offsets": lambda g, n: taugment.draw_offsets(g, n),
    "sigma": lambda g, n: taugment.random_sigma(g, n, 5 / 255, 55 / 255),
    "noise": lambda g, n: taugment.draw_noise(g, (n, 4, 4, 3)),
    "fraction": lambda g, n: ttasks.draw_fraction(g, n),
    "coin": lambda g, n: ttasks.draw_coin(g, n),
    "probe": lambda g, n: ttasks.draw_probe(g, (n, 2, 4, 4, 3)),
}


@pytest.mark.parametrize("kind", list(SHARDED_DRAWS))
def test_sharded_generator_draws_the_global_batch(kind):
    """A ``ShardedGenerator`` for each of 2 ranks (one seed) draws, bit for
    bit, its rows of what one process draws for the global batch of 6, and
    leaves its generator where the one process leaves its own; a plain
    generator draws for its 3 samples alone."""
    draw = SHARDED_DRAWS[kind]
    whole = torch.Generator().manual_seed(5)
    want = draw(whole, 6)
    got = []
    for rank in range(2):
        g = torch.Generator().manual_seed(5)
        got.append(draw(taugment.ShardedGenerator(g, rank, 2), 3))
        assert torch.equal(g.get_state(), whole.get_state())
    assert torch.equal(torch.cat(got), want)
    alone = draw(torch.Generator().manual_seed(5), 3)
    assert torch.equal(alone, draw(taugment.ShardedGenerator(torch.Generator().manual_seed(5),
                                                             0, 1), 3))


@pytest.mark.parametrize("name", ["tiled", "tiled_guard", "tiled_dm"])
def test_tiled_mesh_same_picks_and_psnr(ranks, oracle, name):
    """Tiles over two ranks: the same guard picks and per-frame PSNR within
    1e-6 dB of the one-process run (computed in float64 from the stitched
    frames: a float32 PSNR near 31 dB has a 1.9e-6 dB step), the same
    result and weights on both ranks."""
    want = oracle(name)
    a, b = results(ranks, name)
    np.testing.assert_array_equal(a["variables"], b["variables"])
    np.testing.assert_array_equal(a["x_bayer"], b["x_bayer"])
    orig = make_scene(b=8, h=SIZES.tiled, w=SIZES.tiled, seed=mv.TILED_SEEDS[name]).orig_bayer
    for got in (a, b):
        gap = float(np.abs(psnr64(got["x_bayer"], orig) - psnr64(want["x_bayer"], orig)).max())
        print(f"{name}: {gap:.2e} dB")
        assert gap <= 1e-6
        if "resid_trace" in want:
            np.testing.assert_array_equal(got["resid_trace"].reshape(-1, want[
                "resid_trace"].shape[-1]).argmin(-1), want["resid_trace"].reshape(
                -1, want["resid_trace"].shape[-1]).argmin(-1))


def test_tiled_mesh_matches_jax_mesh(ranks):
    """FFDNet tiles over two ranks against the JAX package's tiled driver
    with its tiles on a ``data=2`` mesh: per-frame PSNR within 4e-6 dB, the
    same pick."""
    net = mv.small_ffdnet()
    variables = tconvert.ffdnet_to_flax(net.state_dict())
    sc = make_scene(b=8, h=SIZES.tiled, w=SIZES.tiled, seed=7)
    cfg = ADMMConfig(sigma=(25 / 255, 12 / 255), iters=(3, 2), select_best=True,
                     adapt=AdaptConfig(lr=2e-6, update_per_iter=1, initial_iter=0,
                                       interval_iter=2))
    ref = jadmm.two_stage_admm_tiled(
        jnp.asarray(sc.meas), jnp.asarray(sc.mask), cfg, tile=SIZES.tiled // 2,
        prior=ffdnet_prior(FFDNet(in_nc=3, out_nc=3, nc=8, nb=3)), variables=variables,
        orig_bayer=jnp.asarray(sc.orig_bayer), mesh=make_mesh(data=2))
    for got in results(ranks, "tiled"):
        gap = float(np.abs(got["psnr"] - np.asarray(ref.psnr_per_frame)).max())
        print(f"tiled mesh vs JAX mesh: {gap:.2e} dB")
        assert gap <= JAX_DB


def test_batched_mesh_matches_jax(ranks):
    """Measurements over two ranks against the JAX batched driver with the
    batch placed ``P('data')``: per-frame PSNR within 4e-6 dB, x 1e-5."""
    net = mv.small_ffdnet()
    variables = tconvert.ffdnet_to_flax(net.state_dict())
    sc = make_scene(b=4, h=SIZES.side, w=SIZES.side, seed=14, n_meas=4)
    y4 = jax.device_put(jnp.asarray(sc.meas.transpose(2, 0, 1)),
                        NamedSharding(make_mesh(data=4, frame=2), P("data")))
    ref = jadmm.two_stage_admm_batched(
        y4, jnp.asarray(sc.mask), ADMMConfig(sigma=(25 / 255,), iters=(2,)),
        prior=ffdnet_prior(FFDNet(in_nc=3, out_nc=3, nc=8, nb=3)), variables=variables)
    for got in results(ranks, "batched"):
        np.testing.assert_allclose(got["x_bayer"], np.asarray(ref.x_bayer), rtol=0, atol=1e-5)


def test_mesh_layout_without_a_process_group():
    """One process: a (1, 1) mesh, every collective the identity; the
    backend defaults to the device."""
    mesh = global_mesh(frame=1)
    assert mesh.shape == {"data": 1, "frame": 1} and mesh.coords == {"data": 0, "frame": 0}
    assert mesh.group("frame") is None and mesh.axis_index(("data", "frame")) == 0
    with pytest.raises(ValueError, match="not divisible"):
        global_mesh(frame=2)
    assert default_backend("cuda") == "nccl" and default_backend("cpu") == "gloo"
