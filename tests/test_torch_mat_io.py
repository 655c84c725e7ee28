"""Port scene and result I/O vs the JAX package on the CPU: the loader on
the MATLAB-convention fixtures of ``test_native_mat_contract.py`` and the
loader tests of ``test_pipelines.py`` (bit for bit), files written by either
package read by the other, the refusal of a v7.3 file without ``h5py``, the
host metrics of ``utils.image``, the ``.pth`` loaders and the Flax parameter
paths behind ``--trainable-filter``.
"""

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from adaptivepnp_sci_torch.data import mat_io as tmat
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.utils import image as timage
from adaptivepnp_sci_tpu.adapt.online import _trainable_mask
from adaptivepnp_sci_tpu.data import mat_io as jmat
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models import convert as jconvert
from adaptivepnp_sci_tpu.models.ffdnet import FFDNet
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz
from adaptivepnp_sci_tpu.utils import image as jimage
from test_native_mat_contract import B, H, T, W, _write_matlab_v73

FIELDS = ("meas", "mask", "orig_bayer", "orig_real", "maxb", "name")


@pytest.fixture(scope="module")
def truth():
    """The uint8 ground truth, mask and 0-255 measurement of
    ``test_native_mat_contract.py``'s fixture."""
    rng = np.random.default_rng(77)
    base = rng.random((T, B, H, W)).astype(np.float32)
    base = (base + np.roll(base, 1, -1) + np.roll(base, 1, -2)) / 3.0
    orig_u8 = np.round(base * 255).astype(np.uint8)
    mask = (rng.random((B, H, W)) > 0.5).astype(np.float32)
    meas255 = np.einsum("tbhw,bhw->thw", orig_u8.astype(np.float64), mask)
    return orig_u8, mask, meas255


def _v73_full(path, truth):
    orig_u8, mask, meas255 = truth
    _write_matlab_v73(path, mask, meas255, orig_u8,
                      np.arange(3 * H * W, dtype=np.uint8).reshape(3, W, H))


def _v73_single(path, truth):
    orig_u8, mask, meas255 = truth
    _write_matlab_v73(path, mask, meas255[0], orig_u8[:1])


def _v73_no_gt(path, truth):
    _, mask, meas255 = truth
    _write_matlab_v73(path, mask, meas255)


def _v5_full(path, truth):
    orig_u8, mask, meas255 = truth
    sio.savemat(path, {"meas_bayer": np.transpose(meas255, (1, 2, 0)),
                       "mask_bayer": np.transpose(mask, (1, 2, 0)),
                       "orig_bayer": np.transpose(orig_u8.reshape(T * B, H, W), (1, 2, 0))})


def _v5_single_no_gt(path, truth):
    _, mask, meas255 = truth
    sio.savemat(path, {"meas_bayer": meas255[0], "mask_bayer": np.transpose(mask, (1, 2, 0))})


def _pipelines_v5(path, truth):
    s = make_scene(b=4, h=16, w=16, seed=0)
    sio.savemat(path, {"meas_bayer": s.meas.astype(np.float32) * 255.0,
                       "mask_bayer": np.transpose(s.mask, (1, 2, 0)),
                       "orig_bayer": np.transpose(s.orig_bayer, (1, 2, 0)) * 255.0})


def _pipelines_v73(path, truth):
    import h5py

    s = make_scene(b=4, h=16, w=16, seed=1, n_meas=2)
    with h5py.File(path, "w") as f:
        f["meas_bayer"] = np.transpose(s.meas, (2, 1, 0)) * 255.0
        f["mask_bayer"] = np.transpose(s.mask, (0, 2, 1))
        f["orig_bayer"] = np.transpose(s.orig_bayer.reshape(8, 16, 16), (0, 2, 1)) * 255.0
        f["orig"] = s.orig_rgb.astype(np.float32)


def _dark_v73(path, truth):
    import h5py

    s = make_scene(b=4, h=16, w=16, seed=2)
    with h5py.File(path, "w") as f:
        f["meas_bayer"] = (s.meas.astype(np.float32) * 0.2 * 255.0).T
        f["mask_bayer"] = np.transpose(s.mask, (0, 2, 1))
        f["orig_bayer"] = np.transpose(s.orig_bayer, (0, 2, 1)) * 0.2 * 255.0


WRITERS = {"v73_full": _v73_full, "v73_single": _v73_single, "v73_no_gt": _v73_no_gt,
           "v5_full": _v5_full, "v5_single_no_gt": _v5_single_no_gt,
           "pipelines_v5": _pipelines_v5, "pipelines_v73": _pipelines_v73,
           "dark_v73": _dark_v73}


def assert_same_scene(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


@pytest.mark.parametrize("kind", sorted(WRITERS))
@pytest.mark.parametrize("maxb", [255.0, 1.0])
def test_loader_matches_jax_bit_for_bit(tmp_path, truth, kind, maxb):
    path = str(tmp_path / f"{kind}.mat")
    WRITERS[kind](path, truth)
    got = tmat.load_cacti_mat(path, kind, maxb=maxb)
    assert_same_scene(got, jmat.load_cacti_mat(path, kind, maxb=maxb))
    assert got.n_meas == got.meas.shape[0] and got.n_frames == got.mask.shape[0]


def test_without_h5py_v73_is_refused_and_v5_still_reads(tmp_path, truth, monkeypatch):
    v73, v5 = str(tmp_path / "a.mat"), str(tmp_path / "b.mat")
    _v73_full(v73, truth)
    _v5_full(v5, truth)
    want = jmat.load_cacti_mat(v5, "v5")
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now fails
    with pytest.raises(ImportError, match="h5py"):
        tmat.load_cacti_mat(v73, "v73")
    assert_same_scene(tmat.load_cacti_mat(v5, "v5"), want)
    # MATLAB's own v7.3 files put the HDF5 signature after a 512-byte header
    padded = str(tmp_path / "matlab.mat")
    with open(v73, "rb") as src, open(padded, "wb") as dst:
        dst.write(b"MATLAB 7.3 MAT-file".ljust(512, b" ") + src.read())
    assert tmat.is_hdf5(padded) and not tmat.is_hdf5(v5)


def test_files_cross_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    recon = rng.random((2, 4, 8, 6)).astype(np.float32)
    for save, load in ((tmat.save_warm_start, jmat.load_warm_start),
                       (jmat.save_warm_start, tmat.load_warm_start)):
        path = str(tmp_path / "warm.mat")
        save(path, recon)
        np.testing.assert_array_equal(load(path, n_frames=4), recon)
        np.testing.assert_array_equal(tmat.load_warm_start(path, 4),
                                      jmat.load_warm_start(path, 4))
    args = (recon, rng.random((2, 4, 8, 6, 3)).astype(np.float32), rng.random((2, 4)),
            rng.random((2, 4)), rng.random((2, 10)))
    kw = dict(meta={"tag": np.arange(3)}, orig_real=rng.random((2, 3, 2, 2)),
              meas_bayer=rng.random((8, 6, 2)))
    tmat.save_results(str(tmp_path / "t.mat"), *args, **kw)
    jmat.save_results(str(tmp_path / "j.mat"), *args, **kw)
    a, b = sio.loadmat(str(tmp_path / "t.mat")), sio.loadmat(str(tmp_path / "j.mat"))
    keys = sorted(k for k in a if not k.startswith("__"))
    assert keys == sorted(k for k in b if not k.startswith("__"))
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # a scene the port's CLI writes loads the same in both packages
    from adaptivepnp_sci_torch.cli import main as tmain

    scene = str(tmp_path / "scene.mat")
    tmain(["synth", "--out", scene, "--size", "16", "--frames", "4", "--n-meas", "2"])
    assert_same_scene(tmat.load_cacti_mat(scene, "s"), jmat.load_cacti_mat(scene, "s"))


def test_host_metrics_match_jax():
    rng = np.random.default_rng(3)
    a = rng.random((2, 24, 20, 3)) * 255
    b = np.clip(a + rng.normal(0, 8, a.shape), 0, 255)
    for x, y in ((a[0, ..., 0], b[0, ..., 0]), (a[0], b[0]), (a, b)):
        for border in ((0, 2) if x.ndim < 4 else (0,)):  # border shaves (H, W) first
            assert timage.calculate_psnr(x, y, border) == jimage.calculate_psnr(x, y, border)
            assert timage.calculate_ssim(x, y, border) == jimage.calculate_ssim(x, y, border)
    assert timage.calculate_psnr(a, a) == float("inf")
    with pytest.raises(ValueError):
        timage.calculate_ssim(a[0], b[0, ..., 0])


def _equal_trees(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_pth_loaders_match_jax(tmp_path):
    """A reference-layout ``.pth`` (``module.``-prefixed, DDnet's wrapped in
    ``state_dict``) loads into the weights JAX's loader gives."""
    fdvd = tconvert.fastdvdnet_from_flax(load_variables_npz("weights/fastdvd.npz"))
    ddnet = tconvert.ddnet_from_flax(load_variables_npz("weights/ddnet.npz"))
    ffd = tconvert.ffdnet_from_flax(jax.tree_util.tree_map(np.asarray, FFDNet(nc=8, nb=3).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), jnp.float32(0.1))))
    cases = [
        ("fdvd.pth", {f"module.{k}": v for k, v in fdvd.items()},
         tconvert.load_fastdvdnet, tconvert.fastdvdnet_to_flax, jconvert.load_fastdvdnet),
        ("ddnet.pth", {"state_dict": {f"module.{k}": v for k, v in ddnet.items()}},
         tconvert.load_ddnet, tconvert.ddnet_to_flax, jconvert.load_ddnet),
        ("ffd.pth", ffd, tconvert.load_ffdnet, tconvert.ffdnet_to_flax, jconvert.load_ffdnet),
    ]
    for name, sd, load, to_flax, jload in cases:
        path = str(tmp_path / name)
        torch.save(sd, path)
        got = load(path)
        want = jload(path)
        mine = to_flax(got)
        _equal_trees(mine["params"], want["params"])
        if "batch_stats" in want:
            _equal_trees(mine["batch_stats"], want["batch_stats"])
    # the reference DDnet's noise-map blocks are dropped, as JAX drops them
    extra = dict(ddnet, **{"temp1.inc.convblock.0.weight": torch.zeros(1)})
    torch.save({"state_dict": extra}, str(tmp_path / "dd2.pth"))
    assert tconvert.load_ddnet(str(tmp_path / "dd2.pth")).keys() == ddnet.keys()
    # a checkpoint that pickles more than tensors is refused, not unpickled
    torch.save({"state_dict": ffd, "args": argparse.Namespace(lr=1e-4)},
               str(tmp_path / "obj.pth"))
    with pytest.raises(ValueError, match="state dict alone"):
        tconvert.load_ffdnet(str(tmp_path / "obj.pth"))


@pytest.mark.parametrize("filters", [("temp2",), ("inc", "bn1"), ("cvblock/conv1",),
                                     ("conv_1",), ("kernel",), ("conv_2/bias",)])
def test_flax_param_paths_select_what_jax_selects(filters):
    from adaptivepnp_sci_torch.cli import trainable_names
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet as TFastDVDnet
    from adaptivepnp_sci_torch.models.ffdnet import FFDNet as TFFDNet

    fdvd = load_variables_npz("weights/fastdvd.npz")["params"]
    ffd = jax.tree_util.tree_map(np.asarray, FFDNet(nc=8, nb=3).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), jnp.float32(0.1)))["params"]
    for params, net, from_flax in ((fdvd, TFastDVDnet(), tconvert.fastdvdnet_from_flax),
                                   (ffd, TFFDNet(nc=8, nb=3), tconvert.ffdnet_from_flax)):
        # mark JAX's selected leaves with 1, the rest with 0, and bridge them
        mask = _trainable_mask(params, filters)
        marked = jax.tree_util.tree_map(lambda p, m: np.full(p.shape, float(m), np.float32),
                                        params, mask)
        stats = jax.tree_util.tree_map(np.zeros_like, load_variables_npz(
            "weights/fastdvd.npz")["batch_stats"]) if net.__class__ is TFastDVDnet else {}
        sd = from_flax({"params": marked, "batch_stats": stats})
        want = {n for n, _ in net.named_parameters() if bool(sd[n].flatten()[0] == 1)}
        if not want:
            with pytest.raises(SystemExit):
                trainable_names(net, filters)
            continue
        assert set(trainable_names(net, filters)) == want
