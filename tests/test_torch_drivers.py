"""Port multi-measurement drivers vs the JAX package on the CPU: the patch
ops, ``two_stage_admm_tiled`` (TV exact and warm-started, FFDNet adaptation
shared over tiles, sequential tile groups, halo overlap, the global
``select_best`` pick, in-scan DDnet adaptation), ``two_stage_admm_batched``,
``two_stage_admm_sequence`` (the FFDNet and DDnet carries) and the carried
Adam state (``fresh_opt_per_trigger=False``).

Both packages get the same numpy scene and weights (FFDNet: Flax init,
bridged; DDnet: ``weights/ddnet.npz``, bridged), at the JAX tests' shapes
(32x32x4 scenes, 16 px tiles). No adaptation noise is drawn (FFDNet has
none), so no PRNG stream has to agree.
Bar: per-frame PSNR within 1e-3 dB and max |dx_bayer| <= 1e-4 in float32;
adapted weights within 5 % of lr of JAX's; Adam moments to float32 rounding.
"""

import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.adapt.online import AdaptConfig as TAdaptConfig
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.ddnet import DDnet as TDDnet
from adaptivepnp_sci_torch.models.ffdnet import FFDNet as TFFDNet
from adaptivepnp_sci_torch.ops import patches as tpatches
from adaptivepnp_sci_torch.solvers import two_stage_admm as tadmm
from adaptivepnp_sci_tpu.adapt.online import AdaptConfig
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models.ddnet import DDnet
from adaptivepnp_sci_tpu.ops import patches
from adaptivepnp_sci_tpu.solvers import ADMMConfig, GapTVConfig, gap_tv
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz
from test_torch_solvers import ffdnet_pair

# the JAX solvers package exports the function under the module's name
jadmm = importlib.import_module("adaptivepnp_sci_tpu.solvers.two_stage_admm")
DDNET_WEIGHTS = Path(__file__).resolve().parent.parent / "weights" / "ddnet.npz"
LR = 1e-4
ADAPT = dict(lr=LR, update_per_iter=1, interval_iter=2, initial_iter=0)
DB, DX = 1e-3, 1e-4


@pytest.fixture(scope="module")
def scene():
    sc = make_scene(b=4, h=32, w=32, seed=7)
    warm = np.array(gap_tv(jnp.asarray(sc.meas), jnp.asarray(sc.mask),
                           GapTVConfig(iters=10)).x_bayer)
    return sc, warm


@pytest.fixture(scope="module")
def ffdnet():
    return ffdnet_pair(nc=16, nb=4)


@pytest.fixture(scope="module")
def ddnet_vars():
    return load_variables_npz(str(DDNET_WEIGHTS))


def gaps(port, ref):
    """Max per-frame PSNR gap (dB) and max |dx_bayer| of two results, over
    any leading axes."""
    p = float(np.abs(port.psnr_per_frame.numpy() - np.asarray(ref.psnr_per_frame)).max())
    x = float(np.abs(port.x_bayer.numpy() - np.asarray(ref.x_bayer)).max())
    assert np.all(np.isfinite(port.x_bayer.numpy()))
    return p, x


def assert_close(port, ref, db=DB, dx=DX):
    p, x = gaps(port, ref)
    print(f"parity: dPSNR {p:.2e} dB, max |dx_bayer| {x:.2e}")
    assert p <= db and x <= dx, (p, x)
    assert port.x_bayer.shape == ref.x_bayer.shape
    np.testing.assert_allclose(port.x_rgb.numpy(), np.asarray(ref.x_rgb), atol=10 * dx)


def assert_ffdnet_weights(got_sd, ref_variables, before, steps, lr=LR):
    """Adapted FFDNet weights within 5 % of lr of JAX's (a fresh Adam moves a
    weight by about lr per step whatever its gradient), and moved."""
    got = tconvert.ffdnet_to_flax(got_sd)["params"]
    moved = 0
    for name, p in ref_variables["params"].items():
        for leaf in ("kernel", "bias"):
            diff = np.abs(got[name][leaf] - np.asarray(p[leaf]))
            print(f"weights {name}/{leaf}: max |dw| = {diff.max() / lr:.2e} lr")
            assert diff.max() <= 0.05 * lr, (name, leaf, diff.max() / lr)
            moved += int((got[name][leaf] != np.asarray(before["params"][name][leaf])).sum())
    assert moved > 0
    assert steps * lr > 0


def assert_ddnet_weights(got_sd, ref_variables, lr, steps):
    """Adapted DDnet weights within 5 % of lr of JAX's for 99 % of them (a
    fresh-moment Adam step moves a weight by about lr whatever its gradient,
    so a gradient near 0 can step either way) and within steps * lr for all."""
    got = tconvert.ddnet_to_flax(got_sd)["params"]
    n_far = n_all = 0
    for path, want in jax.tree_util.tree_leaves_with_path(ref_variables["params"]):
        mine = got
        for p in path:
            mine = mine[p.key]
        diff = np.abs(mine - np.asarray(want))
        assert diff.max() <= steps * lr, (path, diff.max() / lr)
        n_far += int((diff > 0.05 * lr).sum())
        n_all += diff.size
    print(f"DDnet weights: {n_far} of {n_all} beyond 5 % of lr")
    assert n_far <= 0.01 * n_all, (n_far, n_all)


def tiled_both(sc, cfg, pair=None, jax_kw=None, port_kw=None, adapt=None, **kw):
    """JAX ``two_stage_admm_tiled`` and the port's on the same inputs."""
    jprior = variables = tprior = params = None
    if pair is not None:
        (jprior, variables), (tprior, params) = pair
    ref = jadmm.two_stage_admm_tiled(
        jnp.asarray(sc.meas), jnp.asarray(sc.mask),
        ADMMConfig(**cfg, adapt=adapt and AdaptConfig(**adapt)), prior=jprior,
        variables=variables, **{k: v if not isinstance(v, np.ndarray) else jnp.asarray(v)
                                for k, v in kw.items()}, **(jax_kw or {}))
    got = tadmm.two_stage_admm_tiled(
        sc.meas, sc.mask, tadmm.ADMMConfig(**cfg, adapt=adapt and TAdaptConfig(**adapt)),
        prior=tprior, params=params, device="cpu", **kw, **(port_kw or {}))
    return ref, got


def test_crop_stitch_round_trip_equals_jax(rng):
    x = rng.random((2, 32, 48, 3), dtype=np.float32)
    want, grid = patches.crop_patches(jnp.asarray(x), 16)
    got, tgrid = tpatches.crop_patches(torch.from_numpy(x), 16)
    assert tgrid == grid == (2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tpatches.stitch_patches(got, grid).numpy(), x)


def test_crop_overlapping_and_strided_equal_jax(rng):
    x = rng.random((2, 32, 48, 3), dtype=np.float32)
    xp = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    want, grid = patches.crop_overlapping(jnp.asarray(xp), 16, 4)
    got, tgrid = tpatches.crop_overlapping(torch.from_numpy(xp), 16, 4)
    assert tgrid == grid
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cores = tpatches.stitch_patches(got[:, :, 4:20, 4:20, :], grid)
    np.testing.assert_array_equal(cores.numpy(), x)
    img = rng.random((20, 20, 1), dtype=np.float32)
    np.testing.assert_array_equal(tpatches.strided_patches(torch.from_numpy(img), 8, 4).numpy(),
                                  np.asarray(patches.strided_patches(jnp.asarray(img), 8, 4)))


def test_random_crop_is_a_window_of_the_input(rng):
    x = torch.from_numpy(rng.random((4, 20, 20, 3), dtype=np.float32))
    c = tpatches.random_crop(torch.Generator().manual_seed(0), x, 8)
    assert c.shape == (4, 8, 8, 3)
    windows = tpatches.strided_patches(x.permute(1, 2, 0, 3).reshape(20, 20, 12), 8, 1)
    assert any(torch.equal(w, c.permute(1, 2, 0, 3).reshape(8, 8, 12)) for w in windows)
    again = tpatches.random_crop(torch.Generator().manual_seed(0), x, 8)
    assert torch.equal(c, again)


@pytest.mark.parametrize("warm", [False, True])
def test_tiled_tv_matches_jax(scene, warm):
    """TV path, cold (the adjoint) and warm-started (the full-size GAP-TV
    cropped into tiles)."""
    sc, x0 = scene
    kw = dict(tile=16, orig_bayer=sc.orig_bayer)
    if warm:
        kw["x0_bayer"] = x0
    ref, got = tiled_both(sc, dict(sigma=(0.0,), iters=(5,), denoiser="tv"), **kw)
    assert_close(got, ref)
    np.testing.assert_allclose(got.psnr_trace.numpy(), np.asarray(ref.psnr_trace), atol=DB)


def test_tiled_adaptation_shares_one_weight_copy(scene, ffdnet):
    """FFDNet adapting at k = 2 (one Adam step): the tiles' gradients pooled,
    one weight copy out, equal to JAX's pmean-ed adaptation."""
    sc, x0 = scene
    ref, got = tiled_both(sc, dict(sigma=(25 / 255,), iters=(4,)), ffdnet, adapt=ADAPT,
                          tile=16, x0_bayer=x0, orig_bayer=sc.orig_bayer)
    assert_close(got, ref)
    assert_ffdnet_weights(got.variables, ref.variables, ffdnet[0][1], 1)


def test_tiled_chunked_matches_jax(scene, ffdnet):
    """tile_chunk=2: two sequential groups of two tiles, the weights carried
    from the first to the second; 3 does not divide 4 tiles."""
    sc, x0 = scene
    kw = dict(tile=16, x0_bayer=x0, orig_bayer=sc.orig_bayer, tile_chunk=2)
    ref, got = tiled_both(sc, dict(sigma=(25 / 255,), iters=(4,)), ffdnet, adapt=ADAPT, **kw)
    assert_close(got, ref)
    assert_ffdnet_weights(got.variables, ref.variables, ffdnet[0][1], 2)
    with pytest.raises(ValueError, match="tile_chunk"):
        tadmm.two_stage_admm_tiled(sc.meas, sc.mask, tadmm.ADMMConfig(sigma=(0.0,), iters=(1,),
                                                                      denoiser="tv"),
                                   tile=16, tile_chunk=3, device="cpu")


def test_tiled_overlap_matches_jax(scene, ffdnet):
    """Halo windows of 16 + 2 * 4 px, reflect-padded at the scene's edges,
    only the cores stitched; a DDnet window that would fail is refused."""
    sc, x0 = scene
    ref, got = tiled_both(sc, dict(sigma=(25 / 255,), iters=(3,)), ffdnet, tile=16,
                          x0_bayer=x0, orig_bayer=sc.orig_bayer, overlap=4)
    assert_close(got, ref)
    with pytest.raises(ValueError, match="DDnet"):
        tadmm.two_stage_admm_tiled(
            sc.meas, sc.mask, tadmm.ADMMConfig(sigma=(0.1,), iters=(1,), demosaic_method="ddnet"),
            tile=16, overlap=2, prior=ffdnet[1][0], demosaic_fn=lambda m: m, device="cpu")


def test_tiled_select_best_is_global(scene, ffdnet):
    """The guard over tiles: the residual averaged over the tiles ranks the
    candidates, so every tile returns the same pick, JAX's."""
    sc, x0 = scene
    ref, got = tiled_both(sc, dict(sigma=(25 / 255,), iters=(3,), select_best=True), ffdnet,
                          tile=16, x0_bayer=x0, orig_bayer=sc.orig_bayer)
    assert_close(got, ref)
    assert got.resid_trace.shape == (1, 4)
    pick = int(torch.argmin(got.resid_trace[0]))
    if pick == 0:  # the random-init denoiser loses to the warm start, as in JAX's test
        np.testing.assert_allclose(got.x_bayer.numpy(), x0, atol=1e-6)


def test_tiled_dm_spec_matches_jax(scene, ffdnet, ddnet_vars):
    """In-scan DDnet adaptation over tiles: one demosaicker copy, its
    gradients pooled over the tiles, one Adam step an iteration."""
    sc, x0 = scene
    dd_lr = 1e-6
    ref, got = tiled_both(
        sc, dict(sigma=(25 / 255,), iters=(2,), demosaic_method="ddnet"), ffdnet,
        jax_kw=dict(dm_spec=jadmm.make_dm_spec(DDnet(), lr=dd_lr), dm_variables=ddnet_vars),
        port_kw=dict(dm_spec=tadmm.make_dm_spec(TDDnet(), lr=dd_lr),
                     dm_variables=tconvert.ddnet_from_flax(ddnet_vars)),
        tile=16, x0_bayer=x0, orig_bayer=sc.orig_bayer)
    assert_close(got, ref)
    assert_ddnet_weights(got.dm_variables, ref.dm_variables, dd_lr, 2)


def test_batched_matches_jax(scene, ffdnet):
    """Two measurements: fixed weights in lockstep (one launch per step for
    both), then each adapting on its own from the same start, the weights and
    Adam states stacked over T."""
    sc, x0 = scene
    (jprior, variables), (tprior, params) = ffdnet
    y2 = np.stack([sc.meas, sc.meas[::-1, ::-1].copy()])
    x02 = np.stack([x0, x0[:, ::-1, ::-1].copy()])
    o2 = np.stack([sc.orig_bayer, sc.orig_bayer[:, ::-1, ::-1].copy()])
    kw = dict(sigma=(25 / 255,), iters=(3,))
    ref = jadmm.two_stage_admm_batched(jnp.asarray(y2), jnp.asarray(sc.mask), ADMMConfig(**kw),
                                       jprior, variables, jnp.asarray(x02), jnp.asarray(o2))
    got = tadmm.two_stage_admm_batched(y2, sc.mask, tadmm.ADMMConfig(**kw), tprior, params,
                                       x02, o2, device="cpu")
    assert_close(got, ref)
    assert got.psnr_trace.shape == (2, 3)
    assert got.variables["model.0.weight"].shape[0] == 2
    adapt = dict(ADAPT, fresh_opt_per_trigger=False)
    ref = jadmm.two_stage_admm_batched(
        jnp.asarray(y2), jnp.asarray(sc.mask), ADMMConfig(**kw, adapt=AdaptConfig(**adapt)),
        jprior, variables, jnp.asarray(x02), jnp.asarray(o2))
    got = tadmm.two_stage_admm_batched(
        y2, sc.mask, tadmm.ADMMConfig(**kw, adapt=TAdaptConfig(**adapt)), tprior, params,
        x02, o2, device="cpu")
    assert_close(got, ref)
    for t in range(2):
        assert_ffdnet_weights({k: v[t] for k, v in got.variables.items()},
                              jax.tree_util.tree_map(lambda a: a[t], ref.variables),
                              variables, 1)
    assert got.opt_state["state"][0]["exp_avg"].shape[0] == 2
    assert not torch.equal(got.opt_state["state"][0]["exp_avg"][0],
                           got.opt_state["state"][0]["exp_avg"][1])


def test_sequence_carries_ffdnet_weights(scene, ffdnet):
    """The reuse_model loop: measurement 2 starts from measurement 1's
    adapted weights; the same as JAX's scan over measurements."""
    sc, x0 = scene
    (jprior, variables), (tprior, params) = ffdnet
    y2 = np.stack([sc.meas, sc.meas])
    x02, o2 = np.stack([x0, x0]), np.stack([sc.orig_bayer, sc.orig_bayer])
    kw = dict(sigma=(25 / 255,), iters=(4,))
    ref = jadmm.two_stage_admm_sequence(jnp.asarray(y2), jnp.asarray(sc.mask),
                                        ADMMConfig(**kw, adapt=AdaptConfig(**ADAPT)), jprior,
                                        variables, jnp.asarray(x02), jnp.asarray(o2))
    got = tadmm.two_stage_admm_sequence(y2, sc.mask,
                                        tadmm.ADMMConfig(**kw, adapt=TAdaptConfig(**ADAPT)),
                                        tprior, params, x02, o2, device="cpu")
    assert_close(got, ref)
    assert got.psnr_trace.shape == (2, 4)
    assert_ffdnet_weights(got.variables, ref.variables, variables, 2)
    # the second measurement differs from the first only by the carried weights
    assert not torch.equal(got.x_bayer[0], got.x_bayer[1])


def test_sequence_carries_ddnet(scene, ffdnet, ddnet_vars):
    """In-scan DDnet adaptation carried across measurements (its weights and
    its Adam), the denoiser fixed."""
    sc, x0 = scene
    (jprior, variables), (tprior, params) = ffdnet
    y2 = np.stack([sc.meas, sc.meas])
    x02, o2 = np.stack([x0, x0]), np.stack([sc.orig_bayer, sc.orig_bayer])
    kw = dict(sigma=(25 / 255,), iters=(1,), demosaic_method="ddnet")
    ref = jadmm.two_stage_admm_sequence(
        jnp.asarray(y2), jnp.asarray(sc.mask), ADMMConfig(**kw), jprior, variables,
        jnp.asarray(x02), jnp.asarray(o2), dm_spec=jadmm.make_dm_spec(DDnet(), lr=1e-6),
        dm_variables=ddnet_vars)
    got = tadmm.two_stage_admm_sequence(
        y2, sc.mask, tadmm.ADMMConfig(**kw), tprior, params, x02, o2,
        dm_spec=tadmm.make_dm_spec(TDDnet(), lr=1e-6),
        dm_variables=tconvert.ddnet_from_flax(ddnet_vars), device="cpu")
    assert_close(got, ref)
    assert_ddnet_weights(got.dm_variables, ref.dm_variables, 1e-6, 2)
    assert int(got.dm_opt_state["state"][0]["step"]) == 2  # 1 iteration x 2 measurements


def test_carried_adam_moments_match_jax(scene, ffdnet):
    """fresh_opt_per_trigger=False: one Adam through both triggers of a solve,
    with a second stage at another lr; its moments equal optax's, and a
    solve continued from JAX's state equals JAX's continued solve."""
    sc, x0 = scene
    (jprior, variables), (tprior, params) = ffdnet
    adapt = dict(ADAPT, lr=(LR, LR / 2), fresh_opt_per_trigger=False)
    kw = dict(sigma=(25 / 255,), iters=(5,))
    y, phi = jnp.asarray(sc.meas), jnp.asarray(sc.mask)
    ref = jadmm.two_stage_admm(y, phi, ADMMConfig(**kw, adapt=AdaptConfig(**adapt)), jprior,
                               variables, jnp.asarray(x0), jnp.asarray(sc.orig_bayer))
    tcfg = tadmm.ADMMConfig(**kw, adapt=TAdaptConfig(**adapt))
    got = tadmm.two_stage_admm(sc.meas, sc.mask, tcfg, tprior, params, x0, sc.orig_bayer,
                               device="cpu")
    assert_close(got, ref)
    net = TFFDNet(nc=16, nb=4)
    count, mu, nu = tconvert.adam_state_to_optax(got.opt_state, net, tconvert.ffdnet_to_flax)
    adam = ref.opt_state[0]
    assert count == int(adam.count) == 4  # 2 triggers x 2 stages x 1 step
    for mine_tree, want_tree in ((mu, adam.mu), (nu, adam.nu)):
        for name, p in want_tree.items():
            for leaf in ("kernel", "bias"):
                want = np.asarray(p[leaf])
                np.testing.assert_allclose(mine_tree[name][leaf], want, rtol=1e-3,
                                           atol=1e-3 * np.abs(want).max() + 1e-30)
    # continue both from JAX's state: the bridge carries it across
    ref2 = jadmm.two_stage_admm(y, phi, ADMMConfig(**kw, adapt=AdaptConfig(**adapt)), jprior,
                                ref.variables, jnp.asarray(x0), jnp.asarray(sc.orig_bayer),
                                opt_state=ref.opt_state)
    state = tconvert.adam_state_from_optax(adam.count, adam.mu, adam.nu, net,
                                           tconvert.ffdnet_from_flax, LR)
    got2 = tadmm.two_stage_admm(sc.meas, sc.mask, tcfg, tprior,
                                tconvert.ffdnet_from_flax(ref.variables), x0, sc.orig_bayer,
                                device="cpu", opt_state=state)
    assert_close(got2, ref2)
    assert_ffdnet_weights(got2.variables, ref2.variables, ref.variables, 4)
    assert int(got2.opt_state["state"][0]["step"]) == 8
    # the fresh-per-trigger default returns no Adam state
    fresh = dataclasses.replace(tcfg, adapt=TAdaptConfig(**ADAPT))
    assert tadmm.two_stage_admm(sc.meas, sc.mask, fresh, tprior, params, x0,
                                device="cpu").opt_state is None
