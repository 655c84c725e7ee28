"""The port's remaining models and utilities vs the JAX package on the CPU:
every block of the KAIR zoo (``models/blocks.py``) and its factories,
FFDNet-IPOL in both widths, ``SpatialDnCNN``, ``PyramidEncoder`` and
``VGGFeatures``, each against its Flax module on the same variables carried
by ``models/convert`` (drawn from numpy in the Flax module's shapes, every
bias, BatchNorm scale, shift and statistic too, so that none is trivial);
the weight loaders; the
MATLAB bicubic ``imresize``; the converters, augmentation and colour
transforms of ``utils/image.py``.

Bars: each eval-mode output within 1e-5 of its largest magnitude from the
Flax module's (float32 summation order). Train mode is held against the
Flax module evaluated in float64: the output within 1e-5, or within twice
the distance of JAX's own float32 output from float64 where that is larger
(a train-mode BatchNorm over a channel of small spread amplifies float32
noise: the non-local block's, 1.2e-4 and 2.3e-4 for JAX); the running
statistics within 1e-6 of their largest entry, and within 1e-5 of JAX's
float32 ones (XLA's CPU reductions sum in sequence: JAX's float32
statistics sit up to ~3e-6 from float64 where a channel's mean is large
against its spread, the port's ~1e-7). The NumPy utilities bit for bit
(the same NumPy code); ``imresize`` within 1e-5 of its largest magnitude
(two float32 products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.models import blocks as tb
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models import feature as tfeature
from adaptivepnp_sci_torch.models import ffdnet_ipol as tipol
from adaptivepnp_sci_torch.models.ddnet import PyramidEncoder as TPyramidEncoder
from adaptivepnp_sci_torch.models.fastdvdnet import SpatialDnCNN as TSpatialDnCNN
from adaptivepnp_sci_torch.ops.resize import imresize as timresize
from adaptivepnp_sci_torch.utils import image as timage
from adaptivepnp_sci_tpu.models import blocks as jb
from adaptivepnp_sci_tpu.models import convert as jconvert
from adaptivepnp_sci_tpu.models import feature as jfeature
from adaptivepnp_sci_tpu.models import ffdnet_ipol as jipol
from adaptivepnp_sci_tpu.models.ddnet import PyramidEncoder
from adaptivepnp_sci_tpu.models.fastdvdnet import SpatialDnCNN
from adaptivepnp_sci_tpu.ops.resize import imresize
from adaptivepnp_sci_tpu.utils import image as jimage

OUT_REL, STATS_REL, STATS_REL_F32 = 1e-5, 1e-6, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Small tensors gain nothing from many threads, and the other test
    workers share the cores: two intra-op threads while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# name -> (Flax module, port module, NHWC input shape, extra call args,
#          converter, whether the port takes NHWC (else NCHW))
def _zoo():
    blk = tconvert.blocks_from_flax
    # name -> (Flax block, port block, input channels)
    cases = {
        "ConvBlock_CBR": (jb.ConvBlock(out_ch=6, mode="CBR"), tb.ConvBlock(4, 6, mode="CBR"), 4),
        "ConvBlock_TIl": (jb.ConvBlock(out_ch=6, kernel_size=2, stride=2, padding=0, mode="TIl"),
                          tb.ConvBlock(4, 6, 2, 2, 0, mode="TIl"), 4),
        "ConvBlock_CLr2": (jb.ConvBlock(out_ch=8, mode="CLr2"), tb.ConvBlock(4, 8, mode="CLr2"),
                           4),
        "ConvBlock_C3Uuv": (jb.ConvBlock(out_ch=18, mode="C3Uuv"),
                            tb.ConvBlock(4, 18, mode="C3Uuv"), 4),
        "ConvBlock_C4MA": (jb.ConvBlock(out_ch=32, mode="C4MA"), tb.ConvBlock(4, 32, mode="C4MA"),
                           4),
        "ConcatBlock": (jb.ConcatBlock(jb.ConvBlock(out_ch=3, mode="CR")),
                        tb.ConcatBlock(tb.ConvBlock(4, 3, mode="CR")), 4),
        "ShortcutBlock": (jb.ShortcutBlock(jb.ConvBlock(out_ch=4, mode="CLC")),
                          tb.ShortcutBlock(tb.ConvBlock(4, 4, mode="CLC")), 4),
        "ResBlock": (jb.ResBlock(channels=4, mode="RCBC"), tb.ResBlock(4, mode="RCBC"), 4),
        "IMDBlock": (jb.IMDBlock(channels=8), tb.IMDBlock(8), 8),
        "ESA": (jb.ESA(channels=8), tb.ESA(8), 8),
        "CFRB": (jb.CFRB(channels=8), tb.CFRB(8), 8),
        "CFRB_relu": (jb.CFRB(channels=8, mode="CR"), tb.CFRB(8, mode="CR"), 8),
        "CALayer": (jb.CALayer(channels=8, reduction=4), tb.CALayer(8, 4), 8),
        "RCABlock": (jb.RCABlock(channels=8, reduction=4), tb.RCABlock(8, reduction=4), 8),
        "RCAGroup": (jb.RCAGroup(channels=8, reduction=4, nb=2),
                     tb.RCAGroup(8, reduction=4, nb=2), 8),
        "ResidualDenseBlock5C": (jb.ResidualDenseBlock5C(nc=8, gc=4),
                                 tb.ResidualDenseBlock5C(8, 4), 8),
        "RRDB": (jb.RRDB(nc=8, gc=4), tb.RRDB(8, 4), 8),
        "NonLocalBlock2D": (jb.NonLocalBlock2D(nc=8), tb.NonLocalBlock2D(8), 8),
        "NonLocalBlock2D_down": (jb.NonLocalBlock2D(nc=8, downsample=True),
                                 tb.NonLocalBlock2D(8, downsample=True), 8),
        "upsample_pixelshuffle": (jb.upsample_pixelshuffle(out_ch=3, mode="2BR"),
                                  tb.upsample_pixelshuffle(8, 3, mode="2BR"), 8),
        "upsample_upconv": (jb.upsample_upconv(out_ch=3, mode="3L"),
                            tb.upsample_upconv(8, 3, mode="3L"), 8),
        "upsample_convtranspose": (jb.upsample_convtranspose(out_ch=3, mode="2R"),
                                   tb.upsample_convtranspose(8, 3, mode="2R"), 8),
        "downsample_strideconv": (jb.downsample_strideconv(out_ch=5, mode="2R"),
                                  tb.downsample_strideconv(8, 5, mode="2R"), 8),
        "downsample_maxpool": (jb.downsample_maxpool(out_ch=5, mode="2R"),
                               tb.downsample_maxpool(8, 5, mode="2R"), 8),
        "downsample_avgpool": (jb.downsample_avgpool(out_ch=5, mode="3BR"),
                               tb.downsample_avgpool(8, 5, mode="3BR"), 8),
    }
    zoo = {name: (jmod, tmod, (2, 24, 24, c), (), blk, False)
           for name, (jmod, tmod, c) in cases.items()}
    sigma = (np.array([0.1, 0.04], np.float32),)
    zoo.update({
        "ConditionalBatchNorm2d": (jb.ConditionalBatchNorm2d(6, 3),
                                   tb.ConditionalBatchNorm2d(6, 3), (3, 8, 8, 6),
                                   (np.array([0, 2, 1]),), blk, False),
        "FFDNetIPOL_rgb": (jipol.ffdnet_ipol_rgb(), tipol.ffdnet_ipol_rgb(), (2, 16, 16, 3),
                           sigma, tconvert.ffdnet_ipol_from_flax, True),
        "FFDNetIPOL_gray": (jipol.ffdnet_ipol_gray(), tipol.ffdnet_ipol_gray(), (2, 16, 16, 1),
                            sigma, tconvert.ffdnet_ipol_from_flax, True),
        "SpatialDnCNN": (SpatialDnCNN(), TSpatialDnCNN(), (2, 16, 16, 3), sigma,
                         tconvert.spatial_dncnn_from_flax, True),
        "PyramidEncoder": (PyramidEncoder(nf=16, n_rb=2), TPyramidEncoder(16, 2),
                           (2, 18, 22, 4), (), blk, True),
        "VGGFeatures": (jfeature.VGGFeatures(), tfeature.VGGFeatures(), (1, 32, 32, 3), (),
                        tfeature.vgg_from_flax, True),
        "VGGFeatures_cut9_raw": (jfeature.VGGFeatures(9, False), tfeature.VGGFeatures(9, False),
                                 (1, 16, 16, 3), (), tfeature.vgg_from_flax, True),
    })
    return zoo


ZOO = _zoo()


def _draw_variables(jmod, x, extra, seed=0):
    """Variables of the Flax module's shapes (``jax.eval_shape`` of its
    init), every leaf drawn from numpy: kernels N(0, 1/fan_in), biases and
    means N(0, 0.1^2), scales, variances and embeddings U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x, *extra)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("bias", "mean"):
            v = 0.1 * rng.standard_normal(s.shape)
        else:  # scale, var, embedding
            v = rng.uniform(0.5, 1.5, s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port_in(x, nhwc):
    t = torch.from_numpy(x)
    return t if nhwc else t.permute(0, 3, 1, 2)


def _port_out(y, nhwc):
    y = y.detach()
    return (y if nhwc else y.permute(0, 2, 3, 1)).numpy()


@pytest.mark.parametrize("name", sorted(ZOO))
def test_model_matches_flax(name):
    """Eval mode (and, with BatchNorm, train mode with the moved running
    statistics) of the port against the Flax module on the same variables."""
    jmod, tmod, shape, extra, convert, nhwc = ZOO[name]
    x = np.random.default_rng(1).random(shape, dtype=np.float32)
    variables = _draw_variables(jmod, jnp.asarray(x), tuple(map(jnp.asarray, extra)))
    tmod.load_state_dict(convert(variables))
    targs = [torch.from_numpy(a) for a in extra]
    want = jmod.apply(variables, jnp.asarray(x), *map(jnp.asarray, extra))
    got = _port_out(tmod.eval()(_port_in(x, nhwc), *targs), nhwc)
    assert got.shape == want.shape
    err = _rel(got, want)
    print(f"{name}: eval {err:.2e}")
    assert err <= OUT_REL
    if "batch_stats" not in variables:
        return
    want, new = jmod.apply(variables, jnp.asarray(x), *map(jnp.asarray, extra), train=True,
                           mutable=["batch_stats"])
    with jax.enable_x64(True):
        want64, new64 = jmod.apply(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables),
            np.asarray(x, np.float64), *map(jnp.asarray, extra), train=True,
            mutable=["batch_stats"])
        want64 = np.asarray(want64)
        new64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), new64)
    got = _port_out(tmod.train()(_port_in(x, nhwc), *targs), nhwc)
    err, jax_err = _rel(got, want64), _rel(want, want64)
    sd = tmod.state_dict()
    serr = {}
    for label, stats in (("float64", new64), ("float32", new)):
        moved = convert({**variables, "batch_stats": stats["batch_stats"]})
        keys = [k for k in moved if "running_" in k]
        assert keys
        serr[label] = _rel(np.concatenate([sd[k].numpy().ravel() for k in keys]),
                           np.concatenate([moved[k].numpy().ravel() for k in keys]))
    print(f"{name}: train {err:.2e} from float64 (JAX float32 {jax_err:.2e}), "
          f"running statistics {serr}")
    assert err <= max(OUT_REL, 2 * jax_err)
    assert serr["float64"] <= STATS_REL and serr["float32"] <= STATS_REL_F32


def test_sequential_and_pixel_shuffle_match_flax():
    x = np.random.default_rng(2).random((2, 8, 8, 12), dtype=np.float32)
    want = jb.sequential(lambda h: jb.pixel_shuffle(h, 2), jax.nn.relu)(jnp.asarray(x) - 0.5)
    seq = tb.sequential(tb.sequential(torch.nn.PixelShuffle(2)), torch.nn.ReLU())
    got = seq(torch.from_numpy(x).permute(0, 3, 1, 2) - 0.5).permute(0, 2, 3, 1)
    assert len(seq) == 2
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tb.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).numpy(),
        np.asarray(jb.pixel_unshuffle(jnp.asarray(x), 2)))


def test_weight_loaders_match_jax(tmp_path):
    """The reference checkpoint layouts: FFDNet-IPOL's ``.pth``, the pyramid
    encoder's and torchvision's VGG19 state dicts, through the port's loaders
    and the JAX package's converters, the same arrays."""
    port = tipol.FFDNetIPOL(in_nc=1, nc=8, nb=4)
    for m in port.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            torch.nn.init.uniform_(m.running_var, 0.5, 1.5)
            torch.nn.init.normal_(m.bias)
    ref = {f"intermediate_dncnn.itermediate_dncnn.{k.removeprefix('layers.')}": v
           for k, v in port.state_dict().items()}
    path = str(tmp_path / "net_gray.pth")
    torch.save(ref, path)
    loaded = tconvert.load_ffdnet_ipol(path)
    assert all(torch.equal(loaded[k], v) for k, v in port.state_dict().items())
    jvars = jconvert.load_ffdnet_ipol(path)
    back = tconvert.ffdnet_ipol_to_flax(loaded)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jvars)
    assert all(torch.equal(tconvert.ffdnet_ipol_from_flax(jvars)[k], v)
               for k, v in port.state_dict().items())

    enc = TPyramidEncoder(8, 2)
    ref = {}
    for k, v in enc.state_dict().items():
        body, leaf = k.rsplit(".", 1)
        if body.startswith("rbs_"):
            body = "rbs." + body.removeprefix("rbs_")
        elif body.startswith("conv_first0"):  # the head Sequentials
            body = body[:-2] + "." + body[-1]
        ref[f"{body}.{leaf}"] = v
    mapped = tconvert.pyramid_encoder_state_dict_from_reference(ref)
    assert all(torch.equal(mapped[k], v) for k, v in enc.state_dict().items())
    assert all(torch.equal(tconvert.blocks_from_flax(
        jconvert.pyramid_encoder_variables({k: v.numpy() for k, v in ref.items()}))[k], v)
        for k, v in enc.state_dict().items())

    vgg = tfeature.VGGFeatures(9)
    tv = {k: v.numpy() for k, v in vgg.state_dict().items()}
    tv["features.10.weight"] = np.zeros((4, 4, 3, 3), np.float32)  # past the cut
    tv["classifier.0.weight"] = np.zeros((4, 4), np.float32)
    for sd in (tv, {k.removeprefix("features."): v for k, v in tv.items()
                    if k.startswith("features.")}):
        mine = tfeature.vgg_state_dict_from_torch(sd, 9)
        vgg.load_state_dict(mine)
        jvars = jfeature.vgg_variables_from_torch(
            {k: v for k, v in sd.items() if not k.startswith("classifier")
             and int(k.removeprefix("features.").split(".")[0]) < 9})
        assert all(torch.equal(tfeature.vgg_from_flax(jvars)[k], v) for k, v in mine.items())


def test_perceptual_loss_matches_flax():
    jmod, tmod = jfeature.VGGFeatures(9), tfeature.VGGFeatures(9)
    rng = np.random.default_rng(3)
    pred, target = (rng.random((1, 16, 16, 3), dtype=np.float32) for _ in range(2))
    variables = _draw_variables(jmod, jnp.asarray(pred), ())
    tmod.load_state_dict(tfeature.vgg_from_flax(variables))
    want = float(jfeature.perceptual_loss(variables, jmod, jnp.asarray(pred),
                                          jnp.asarray(target)))
    got = float(tfeature.perceptual_loss(tmod, torch.from_numpy(pred), torch.from_numpy(target)))
    assert abs(got - want) <= OUT_REL * abs(want)


@pytest.mark.parametrize("shape, kw", [
    ((2, 13, 17, 3), dict(scale=2.0)),
    ((2, 13, 17, 3), dict(scale=0.5)),
    ((2, 13, 17, 3), dict(scale=0.5, antialias=False)),
    ((20, 9), dict(out_shape=(7, 23))),
], ids=["up", "down_antialias", "down_plain", "gray_out_shape"])
def test_imresize_matches_jax(shape, kw):
    img = np.random.default_rng(4).random(shape, dtype=np.float32)
    want = np.asarray(imresize(jnp.asarray(img), **kw))
    got = timresize(torch.from_numpy(img), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= OUT_REL
    assert torch.equal(timresize(img, **kw), got)  # a NumPy array is a CPU tensor


_U8 = (np.random.default_rng(5).random((6, 7, 3)) * 255).astype(np.uint8)
_F32 = np.random.default_rng(6).random((6, 7, 3)).astype(np.float32)
_U16 = (np.random.default_rng(7).random((6, 7)) * 65535).astype(np.uint16)
_IMAGE_CASES = {
    "uint2single": ("uint2single", (_U8,)),
    "single2uint": ("single2uint", (_F32 * 1.2 - 0.1,)),
    "uint162single": ("uint162single", (_U16,)),
    "single2uint16": ("single2uint16", (_F32,)),
    "uint2array4": ("uint2array4", (_U8[..., 0],)),
    "uint2array3": ("uint2array3", (_U8,)),
    "array2uint": ("array2uint", (_F32[None],)),
    "single2array4": ("single2array4", (_F32,)),
    "single2array5": ("single2array5", (_F32,)),
    "array2single": ("array2single", (_F32[None],)),
    "array2img": ("array2img", (_F32 * 3 - 1, np.uint8, (-1.0, 2.0))),
    "array2img_float": ("array2img", (_F32, np.float32)),
    "rgb2ycbcr_y_u8": ("rgb2ycbcr", (_U8, True)),
    "rgb2ycbcr_f32": ("rgb2ycbcr", (_F32, False)),
    "bgr2ycbcr_y_f32": ("bgr2ycbcr", (_F32, True)),
    "bgr2ycbcr_u8": ("bgr2ycbcr", (_U8, False)),
    "ycbcr2rgb_f32": ("ycbcr2rgb", (_F32,)),
    "ycbcr2rgb_u8": ("ycbcr2rgb", (_U8,)),
    "modcrop": ("modcrop", (_F32, 4)),
    "shave": ("shave", (_F32, 2)),
    "channel_convert_y": ("channel_convert", (3, "y", [_U8, _F32])),
    "channel_convert_gray": ("channel_convert", (3, "gray", [_F32])),
    "channel_convert_rgb": ("channel_convert", (1, "RGB", [_F32[..., :1]])),
    "channel_convert_none": ("channel_convert", (3, "RGB", [_F32])),
}


@pytest.mark.parametrize("case", sorted(_IMAGE_CASES))
def test_image_converters_match_jax(case):
    fn, args = _IMAGE_CASES[case]
    got, want = getattr(timage, fn)(*args), getattr(jimage, fn)(*args)
    for g, w in zip(*(v if isinstance(v, list) else [v] for v in (got, want)), strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_augmentation_and_paths_match_jax(tmp_path):
    for mode in range(8):
        np.testing.assert_array_equal(timage.augment_img(_F32, mode), jimage.augment_img(_F32, mode))
    with pytest.raises(ValueError):
        timage.augment_img(_F32, 8)
    for seed in range(4):
        for kw in ({}, dict(hflip=False), dict(rot=False)):
            got = timage.augment_imgs([_F32, _U8[..., 0]], rng=np.random.default_rng(seed), **kw)
            want = jimage.augment_imgs([_F32, _U8[..., 0]], rng=np.random.default_rng(seed), **kw)
            for g, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(g, w)
    (tmp_path / "a" / "b").mkdir(parents=True)
    for f in ("a/x.PNG", "a/b/y.jpg", "a/z.txt", "w.tif"):
        (tmp_path / f).write_bytes(b"")
    assert timage.get_image_paths(str(tmp_path)) == jimage.get_image_paths(str(tmp_path))
    assert [timage.is_image_file(f) for f in ("a.webp", "b.npy")] == [True, False]
    timage.mkdirs([str(tmp_path / "m1"), str(tmp_path / "m2")])
    timage.mkdir_and_rename(str(tmp_path / "m1"))
    assert sorted(p.name.split("_archived_")[0] for p in tmp_path.glob("m1*")) == ["m1", "m1"]


def test_image_io_matches_jax(tmp_path):
    """PIL is imported only when an image is read or written; the files and
    arrays are the JAX package's."""
    for n_channels, img in ((3, _U8), (1, _U8[..., :1])):
        path_t, path_j = str(tmp_path / f"t{n_channels}.png"), str(tmp_path / f"j{n_channels}.png")
        timage.imsave(img, path_t)
        jimage.imsave(img, path_j)
        assert open(path_t, "rb").read() == open(path_j, "rb").read()
        got = timage.imread_uint(path_t, n_channels)
        np.testing.assert_array_equal(got, jimage.imread_uint(path_j, n_channels))
        np.testing.assert_array_equal(got, img)
