"""The parts of the port's training slice vs the JAX package, on the CPU:
train-mode BatchNorm on Flax's convention, the augmentation, the training
data, the corruption masks (alone and in an adaptation trigger), the SVD
orthogonalization, the FFDNet and DDnet tasks, and the logging helpers.

Random draws: the port's draw functions are replaced by the JAX package's
draws (``randint``, ``choice``, ``uniform``, ``normal`` on the keys the JAX
function uses), so both sides see the same numbers. Bars are stated in each
test: bit for bit where both sides move the same values, float32 summation
noise elsewhere.
"""

import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.adapt import online as tonline
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models import fastdvdnet as tfd
from adaptivepnp_sci_torch.models.ddnet import DDnet as TDDnet
from adaptivepnp_sci_torch.models.ffdnet import FFDNet as TFFDNet
from adaptivepnp_sci_torch.ops import corruption as tcorruption
from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior as tffdnet_prior
from adaptivepnp_sci_torch.train import augment as taugment
from adaptivepnp_sci_torch.train import datasets as tdatasets
from adaptivepnp_sci_torch.train import regularizers as tregularizers
from adaptivepnp_sci_torch.train import tasks as ttasks
from adaptivepnp_sci_torch.utils import logging as tlogging
from adaptivepnp_sci_tpu.adapt import online
from adaptivepnp_sci_tpu.models.ddnet import DDnet
from adaptivepnp_sci_tpu.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_tpu.models.ffdnet import FFDNet
from adaptivepnp_sci_tpu.ops import bayer, corruption
from adaptivepnp_sci_tpu.solvers.priors import ffdnet_prior
from adaptivepnp_sci_tpu.train import augment, datasets, regularizers, tasks
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz
from tests.test_torch_train_tasks import run_case

WEIGHTS = Path(__file__).resolve().parent.parent / "weights"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Small tensors gain nothing from many threads, and the other test
    workers share the cores: two intra-op threads while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fdvd_vars():
    return load_variables_npz(str(WEIGHTS / "fastdvd.npz"))


@pytest.fixture(scope="module")
def ffd_vars():
    """Flax-initialised FFDNet nc 8 / nb 3 variables, as numpy arrays."""
    init = jax.jit(FFDNet(nc=8, nb=3).init)
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 16, 16, 3)), jnp.float32(0.1)))


def _rand(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# ---------------------------------------------------------------- BatchNorm


def _train_stats_gap(variables, windows, want_stats, bn_class):
    """One train-mode forward of the port with ``bn_class`` as its
    BatchNorm; the largest difference of the moved statistics from JAX's
    over the whole collection, against the collection's largest entry."""
    net = tfd.FastDVDnet()
    for m in net.modules():
        if isinstance(m, tfd.BatchNorm2d):
            m.__class__ = bn_class
    net.load_state_dict(tconvert.fastdvdnet_from_flax(variables))
    net.train()(torch.from_numpy(windows), 0.05)
    stats = tconvert.fastdvdnet_to_flax(net.state_dict())["batch_stats"]
    got, want = [], []
    for path, leaf in jax.tree_util.tree_leaves_with_path(want_stats):
        mine = stats
        for p in path:
            mine = mine[p.key]
        got.append(mine.ravel())
        want.append(np.asarray(leaf).ravel())
    got, want = np.concatenate(got), np.concatenate(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_train_mode_batchnorm_follows_flax(fdvd_vars):
    """Train-mode BatchNorm on Flax's convention (biased variance into the
    running average, momentum 0.9): after one train-mode forward of the
    trained weights at 2x16x16, the running statistics (three ``temp1``
    updates and one ``temp2``) within 1e-6 of JAX's, relative to the largest
    statistic. ``nn.BatchNorm2d`` (the unbiased variance, a factor
    N/(N-1)) misses that bar by orders of magnitude."""
    windows = _rand(0, (2, 5, 16, 16, 3))
    _, new = jax.jit(lambda v, w: FastDVDnet(remat=False).apply(
        v, w, jnp.float32(0.05), True, mutable=["batch_stats"]))(fdvd_vars, jnp.asarray(windows))
    port = _train_stats_gap(fdvd_vars, windows, new["batch_stats"], tfd.BatchNorm2d)
    plain = _train_stats_gap(fdvd_vars, windows, new["batch_stats"], torch.nn.BatchNorm2d)
    print(f"train-mode BatchNorm statistics vs Flax: port {port:.2e}, nn.BatchNorm2d {plain:.2e}")
    assert port <= 1e-6 < 100 * 1e-6 < plain


def test_eval_mode_and_frozen_statistics(fdvd_vars):
    """Eval mode is ``nn.BatchNorm2d``'s bit for bit; under
    ``frozen_batch_stats`` a train-mode forward leaves the buffers."""
    x = torch.from_numpy(_rand(1, (2, 6, 8, 8))) * 3 + 1
    bn = tfd.BatchNorm2d(6)
    plain = torch.nn.BatchNorm2d(6)
    with torch.no_grad():
        for m in (bn, plain):
            m.running_mean.copy_(torch.arange(6.0) / 10)
            m.running_var.copy_(torch.arange(1.0, 7.0))
    assert torch.equal(bn.eval()(x), plain.eval()(x))
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    with tfd.frozen_batch_stats(bn):
        bn.train()(x)
    assert all(torch.equal(v, bn.state_dict()[k]) for k, v in before.items())
    bn(x)
    assert not torch.equal(before["running_var"], bn.running_var)
    biased = x.permute(1, 0, 2, 3).reshape(6, -1).var(1, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 * before["running_var"] + 0.1 * biased)


# ------------------------------------------------------------- augmentation


def test_apply_mode_matches_jax_bit_for_bit():
    img = _rand(2, (3, 8, 8, 3))
    for m in range(8):
        want = np.asarray(augment.apply_mode(jnp.asarray(img), jnp.int32(m)))
        np.testing.assert_array_equal(taugment.apply_mode(torch.from_numpy(img), m).numpy(),
                                      want, err_msg=f"mode {m}")


def test_augment_batch_matches_jax_with_its_modes(monkeypatch):
    batch = _rand(3, (6, 2, 8, 8, 3))
    key = jax.random.PRNGKey(11)
    modes = np.asarray(jax.random.randint(key, (6,), 0, 8)).astype(np.int64)
    assert len(set(modes.tolist())) > 3
    monkeypatch.setattr(taugment, "draw_modes", lambda g, n: torch.from_numpy(modes))
    got = taugment.augment_batch(torch.Generator(), torch.from_numpy(batch))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(augment.augment_batch(key, jnp.asarray(batch))))


def test_normalize_augment_matches_jax_with_its_draws(monkeypatch):
    """Every choice of the 9 (the 8 modes and the constant offsets) that the
    first keys give, with JAX's choice and offsets injected: bit for bit, but
    the offsets within 2 ulp (XLA fuses their scale and the
    add into one multiply-add)."""
    batch = _rand(4, (3, 5, 8, 8, 3)) * 255
    w = augment._REF_AUG_WEIGHTS
    seen = set()
    for i in range(64):
        key = jax.random.PRNGKey(i)
        k_mode, k_noise = jax.random.split(key)
        mode = int(jax.random.choice(k_mode, 9, p=w))
        if mode in seen:
            continue
        seen.add(mode)
        offs = np.asarray(jax.random.normal(k_noise, (3, 1, 1, 1, 1), jnp.float32)).ravel()
        monkeypatch.setattr(taugment, "draw_choice", lambda g, m=mode: m)
        monkeypatch.setattr(taugment, "draw_offsets", lambda g, n, o=offs: torch.from_numpy(o))
        out, gt = taugment.normalize_augment(torch.Generator(), torch.from_numpy(batch))
        jout, jgt = augment.normalize_augment(key, jnp.asarray(batch))
        if mode < 8:
            np.testing.assert_array_equal(out.numpy(), np.asarray(jout), err_msg=f"choice {mode}")
            np.testing.assert_array_equal(gt.numpy(), np.asarray(jgt))
        else:
            np.testing.assert_array_max_ulp(out.numpy(), np.asarray(jout), maxulp=2)
            np.testing.assert_array_max_ulp(gt.numpy(), np.asarray(jgt), maxulp=2)
            assert not np.array_equal(out.numpy(), batch / 255.0)
    assert 8 in seen and len(seen) >= 6, seen


def test_draw_functions_use_the_generator():
    """Unpatched: the reference's weights and ranges; one seed, one draw."""
    g = torch.Generator().manual_seed(0)
    choices = [taugment.draw_choice(g) for _ in range(2000)]
    assert abs(choices.count(0) / 2000 - 32 / 148) < 0.03 and set(choices) == set(range(9))
    s = taugment.random_sigma(torch.Generator().manual_seed(1), 1000, 0.1, 0.2)
    assert float(s.min()) >= 0.1 and float(s.max()) <= 0.2
    assert torch.equal(taugment.draw_modes(torch.Generator().manual_seed(2), 9),
                       taugment.draw_modes(torch.Generator().manual_seed(2), 9))


# --------------------------------------------------------------------- data


def test_patches_and_chunks_match_jax_bit_for_bit():
    img = _rand(5, (40, 36, 3))
    np.testing.assert_array_equal(tdatasets.extract_patches(img, 16, 8),
                                  datasets.extract_patches(img, 16, 8))
    np.testing.assert_array_equal(tdatasets.extract_patches(img, 64, 8),
                                  datasets.extract_patches(img, 64, 8))
    video = _rand(6, (12, 8, 8, 3))
    np.testing.assert_array_equal(tdatasets.temporal_chunks(video, 5, 3),
                                  datasets.temporal_chunks(video, 5, 3))


@pytest.mark.parametrize("kw", [
    dict(n_clips=3, length=5, size=16, seed=1),
    dict(n_clips=3, length=5, size=16, seed=2, textured=True),
    dict(n_clips=2, length=3, size=16, seed=3, styles=("smooth",)),
    dict(n_clips=2, length=3, size=16, seed=4, styles=("textured",)),
    dict(n_clips=2, length=3, size=32, seed=5, styles=("leaves",)),
    dict(n_clips=5, length=3, size=16, seed=6, source_sizes=(24, 32), crops_per_video=2,
         textured=True),
    dict(n_clips=4, length=2, size=16, seed=7, source_sizes=(32,),
         styles=("smooth", "leaves", "textured")),
], ids=["legacy", "legacy_textured", "smooth", "textured", "leaves", "sources",
        "sources_styles"])
def test_synthetic_video_dataset_matches_jax_bit_for_bit(kw):
    np.testing.assert_array_equal(tdatasets.synthetic_video_dataset(**kw),
                                  datasets.synthetic_video_dataset(**kw))


def test_photo_styles_and_unknown_styles_are_refused():
    """The photograph clip styles are ported (bit for bit JAX's clips, more
    cases in ``test_torch_photos.py``); an unknown style is refused."""
    for style in ("photo", "photos"):
        kw = dict(n_clips=2, length=2, size=16, seed=1, styles=("smooth", style))
        np.testing.assert_array_equal(tdatasets.synthetic_video_dataset(**kw),
                                      datasets.synthetic_video_dataset(**kw))
    with pytest.raises(ValueError):
        tdatasets.synthetic_video_dataset(2, styles=("marble",))


def test_batch_iterators_match_jax_bit_for_bit():
    data = np.arange(22 * 3, dtype=np.float32).reshape(22, 3)
    mine = tdatasets.batch_iterator(data, 4, seed=3, epochs=2)
    theirs = datasets.batch_iterator(data, 4, seed=3, epochs=2)
    pairs = list(zip(mine, theirs, strict=True))
    assert len(pairs) == 10
    for a, b in pairs:
        np.testing.assert_array_equal(a, b)
    arrays = (data, np.arange(22.0), np.arange(22) % 2)
    for a, b in zip(tdatasets.paired_batch_iterator(arrays, 5, seed=4, epochs=2),
                    datasets.paired_batch_iterator(arrays, 5, seed=4, epochs=2), strict=True):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        next(tdatasets.paired_batch_iterator((data, data[:3]), 2))


def test_load_array_dir_matches_jax(tmp_path):
    np.save(tmp_path / "b.npy", _rand(8, (6, 4, 4, 3)))
    np.save(tmp_path / "a.npy", _rand(9, (5, 4, 4, 3)))
    np.savez(tmp_path / "c.npz", x=_rand(10, (7, 4, 4, 3)), y=_rand(11, (2, 4, 4, 3)))
    (tmp_path / "notes.txt").write_text("ignored")
    mine, theirs = tdatasets.load_array_dir(str(tmp_path)), datasets.load_array_dir(str(tmp_path))
    assert len(mine) == len(theirs) == 4
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)


def test_patch_db_round_trips_and_needs_h5py(tmp_path, monkeypatch):
    patches = _rand(12, (10, 8, 8, 3))
    path = str(tmp_path / "p.h5")
    tdatasets.write_patch_db(path, patches, chunk=4)
    np.testing.assert_array_equal(tdatasets.read_patch_db(path), patches)
    np.testing.assert_array_equal(datasets.read_patch_db(path), patches)
    import builtins

    real_import = builtins.__import__

    def no_h5py(name, *args, **kw):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    for call in (lambda: tdatasets.read_patch_db(path),
                 lambda: tdatasets.write_patch_db(str(tmp_path / "q.h5"), patches)):
        with pytest.raises(ImportError, match="h5py"):
            call()


# -------------------------------------------------------------- corruption


def _jax_drop(key, shape, ratio):
    return torch.from_numpy(np.asarray(jax.random.uniform(key, shape) < ratio))


def test_corruption_masks_match_jax_with_its_draws(monkeypatch):
    """Spatial, temporal and block masks, and a sequence of all three, with
    JAX's dropped sites injected: bit for bit."""
    x = jnp.asarray(_rand(13, (2, 5, 8, 8, 3)))
    tx = torch.from_numpy(np.asarray(x))
    key = jax.random.PRNGKey(3)
    g = torch.Generator()
    monkeypatch.setattr(tcorruption, "drop_mask", lambda g, shape, r: _jax_drop(key, shape, r))
    np.testing.assert_array_equal(tcorruption.mask_spatial(g, tx, 0.3).numpy(),
                                  np.asarray(corruption.mask_spatial(key, x, 0.3)))
    np.testing.assert_array_equal(tcorruption.mask_block(g, tx, 0.3).numpy(),
                                  np.asarray(corruption.mask_block(key, x, 0.3)))
    np.testing.assert_array_equal(tcorruption.mask_temporal(tx).numpy(),
                                  np.asarray(corruption.mask_temporal(x)))
    modes = ("s", "t", "b")
    keys = iter([jax.random.fold_in(key, 0), jax.random.fold_in(key, 2)])
    monkeypatch.setattr(tcorruption, "drop_mask",
                        lambda g, shape, r: _jax_drop(next(keys), shape, r))
    for a, b in zip(tcorruption.mask_sequence(g, tx, modes, 0.2),
                    corruption.mask_sequence(key, x, modes, 0.2), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tcorruption.mask_sequence(g, tx, ("q",))
    assert torch.equal(tx, torch.from_numpy(np.asarray(x)))  # the input is not changed


def _adapt_inputs(b=4, h=8, w=12):
    rng = np.random.default_rng(14)
    rgb = rng.random((b, h, w, 3), dtype=np.float32)
    phi = (rng.random((b, h, w)) > 0.5).astype(np.float32)
    y = (rng.random((b, h, w), dtype=np.float32) * phi).sum(0)
    return rgb, phi, y


@pytest.mark.parametrize("mode", ["s", "t", "b"])
def test_adapt_mask_trigger_matches_jax_with_its_mask(monkeypatch, ffd_vars, mode):
    """One FFDNet adaptation trigger (two Adam steps, lr 2e-6) with the
    input corrupted by ``Prior.adapt_mask`` (ratio 0.3), JAX's mask injected
    (drawn from the first split of ``PRNGKey(0)``). Bar of the FFDNet
    trigger test: every weight within 2 steps of lr of JAX's, 99 % within 1 %
    of lr; and the corruption changes the result."""
    model, variables = FFDNet(in_nc=3, out_nc=3, nc=8, nb=3), ffd_vars
    rgb, phi, y = _adapt_inputs()
    sigma, lr = np.float32(25 / 255), 2e-6
    kw = dict(lr=lr, update_per_iter=2, interval_iter=15, initial_iter=1)
    cfg = online.AdaptConfig(**kw)
    opt = online.default_adam(online.first_lr(cfg))
    jprior = ffdnet_prior(model)._replace(adapt_mask=(mode, 0.3))
    y_p, phi_p = bayer.pack(jnp.asarray(y)), bayer.pack(jnp.asarray(phi))
    jvars, _, _ = jax.jit(online.make_adapt_fn(jprior, opt, cfg))(
        variables, opt.init(variables["params"]), jax.random.PRNGKey(0), jnp.asarray(rgb),
        sigma, y_p, phi_p, jnp.asarray(y), jnp.asarray(phi))
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    monkeypatch.setattr(tcorruption, "drop_mask", lambda g, shape, r: _jax_drop(sub, shape, r))

    def trigger(adapt_mask):
        net = TFFDNet(nc=8, nb=3)
        net.load_state_dict(tconvert.ffdnet_from_flax(variables))
        prior = tffdnet_prior(net)._replace(adapt_mask=adapt_mask)
        if adapt_mask is not None:
            assert tonline.draws_randoms(prior, tonline.AdaptConfig(**kw)) == (mode != "t")
        tonline.make_adapt_fn(prior, tonline.AdaptConfig(**kw))(
            net.eval(), torch.from_numpy(rgb), torch.tensor(sigma),
            torch.from_numpy(np.array(y_p)), torch.from_numpy(np.array(phi_p)),
            torch.from_numpy(y), torch.from_numpy(phi), torch.Generator())
        return tconvert.ffdnet_to_flax(net.state_dict())["params"]

    got, unmasked = trigger((mode, 0.3)), trigger(None)
    n_far = n_all = 0
    moved_by_mask = 0.0
    for name, p in jvars["params"].items():
        for leaf in ("kernel", "bias"):
            before = variables["params"][name][leaf]
            d_jax = np.asarray(p[leaf]) - before
            diff = np.abs(got[name][leaf] - before - d_jax)
            assert diff.max() <= 2 * lr + 1e-7
            n_far += int((diff > 0.01 * lr).sum())
            n_all += diff.size
            moved_by_mask = max(moved_by_mask,
                                float(np.abs(got[name][leaf] - unmasked[name][leaf]).max()))
    assert n_far <= 0.01 * n_all, (n_far, n_all)
    assert moved_by_mask > 0.1 * lr


# ------------------------------------------------------- orthogonalization


def test_svd_orthogonalize_matches_jax(fdvd_vars, ffd_vars):
    """The polar factor per conv weight, within 1e-5 of JAX's: a small FFDNet
    and FastDVDnet's ``temp1`` convs (every conv shape of the model; the
    grouped input conv is a 36 x 90 matrix with orthonormal rows)."""
    ffd = TFFDNet(nc=8, nb=3)
    fdvd = tfd.FastDVDnet()
    cases = [(ffd, ffd, ffd_vars, tconvert.ffdnet_from_flax, 3),
             (fdvd, fdvd.temp1, {"params": {"temp1": fdvd_vars["params"]["temp1"]},
                                 "batch_stats": fdvd_vars["batch_stats"]},
              tconvert.fastdvdnet_from_flax, 16)]
    for net, part, variables, from_flax, n_convs in cases:
        want = regularizers.svd_orthogonalize(variables["params"])
        net.load_state_dict(from_flax(variables), strict=False)  # temp1's alone
        tregularizers.svd_orthogonalize(part)
        got = tconvert.flax_from_state_dict(net.state_dict())["params"]
        n = 0
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            mine = got
            for p in path:
                mine = mine[p.key]
            np.testing.assert_allclose(mine, np.asarray(leaf), rtol=0, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))
            n += np.asarray(leaf).ndim == 4
        assert n == n_convs
    w = fdvd.temp1.inc.convblock[0].weight
    mat = w.detach().reshape(w.shape[0], -1).T  # (36, 90)
    torch.testing.assert_close(mat @ mat.T, torch.eye(36), atol=1e-5, rtol=0)


# ----------------------------------------------------- FFDNet / DDnet tasks


def test_ffdnet_task_matches_jax(monkeypatch, ffd_vars):
    """FFDNet nc 8 / nb 3 at 16x16, batch 2 (bars of
    ``tests/test_torch_train_tasks.py``)."""
    run_case(monkeypatch, "ffdnet", tasks.ffdnet_task(FFDNet(nc=8, nb=3)),
             ttasks.ffdnet_task(TFFDNet(nc=8, nb=3)), ffd_vars, _rand(15, (2, 16, 16, 3)),
             jax.random.PRNGKey(3))


def test_ddnet_task_matches_jax(monkeypatch):
    """DDnet with the weights of ``weights/ddnet.npz`` at 16x16, batch 2: the
    noisy centre frame as the target, plain MSE."""
    run_case(monkeypatch, "ddnet", tasks.ddnet_task(DDnet()), ttasks.ddnet_task(TDDnet()),
             load_variables_npz(str(WEIGHTS / "ddnet.npz")), _rand(16, (2, 5, 16, 16, 3)),
             jax.random.PRNGKey(8))


# ------------------------------------------------------------------ logging


def test_logging_helpers(tmp_path):
    log = tlogging.get_logger("adaptivepnp_sci_torch.test")
    path = tmp_path / "log.txt"
    tlogging.add_file_handler(str(path))
    try:
        log.info("hello %d", 7)
    finally:
        root = logging.getLogger("adaptivepnp_sci_torch")
        for h in list(root.handlers):
            if isinstance(h, logging.FileHandler):
                root.removeHandler(h)
                h.close()
    text = path.read_text()
    assert "hello 7" in text
    rev = tlogging.git_revision(str(Path(__file__).parent))
    assert rev == "unknown" or len(rev) == 40
