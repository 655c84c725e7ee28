"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and ``nvcc``; without a GPU they skip. On the card:
``python -m pytest tests/test_torch_cuda.py -q -m cuda``.
Bar: rtol 1e-5 / atol 1e-6, as for the Pallas kernels; the bf16 conv pair is
held to the A/B script's gate, max abs error / max abs reference < 2e-2; the
bf16 BatchNorm-and-ReLU epilogue bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.ab_convpair import make_inputs
from adaptivepnp_sci_torch.models.convert import fastdvdnet_from_flax, load_variables_npz
from adaptivepnp_sci_torch.models.fastdvdnet import CvBlock, FastDVDnet
from adaptivepnp_sci_torch.ops import convpair, cuda_kernels, physics, tv

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _xdata(cuda, b, h, w, misaligned=False):
    g = torch.Generator().manual_seed(0)
    n = b * 4 * h * w

    def cube(t):
        if not misaligned:
            return t.to(cuda)
        buf = torch.empty(n + 1, device=cuda)  # offset by one float: no float4 loads
        view = buf[1:].view(b, 4, h, w)
        view.copy_(t)
        return view

    theta = cube(torch.rand(b, 4, h, w, generator=g))
    bd = cube((torch.rand(b, 4, h, w, generator=g) - 0.5) * 0.2)
    phi = cube((torch.rand(b, 4, h, w, generator=g) > 0.5).float())
    y = (torch.rand(b, 4, h, w, generator=g).to(cuda) * phi).sum(0)
    return theta, bd, y, phi, physics.phi_sum(phi)


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("shape", [(8, 32, 64), (3, 5, 7)])
def test_x_update_kernel_matches_plain(cuda, shape, misaligned):
    args = _xdata(cuda, *shape, misaligned=misaligned)
    before = cuda_kernels.launches["x_update"]
    torch.testing.assert_close(cuda_kernels.admm_x_update(*args, 0.55, 1.0),
                               physics.admm_x_update(*args, 0.55, 1.0), **TOL)
    for lam in (1.0, 0.5):
        torch.testing.assert_close(cuda_kernels.gap_x_update(*args, lam, 0.01),
                                   physics.gap_x_update(*args, lam, 0.01), **TOL)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["x_update"] == before + 3


@pytest.mark.parametrize("shared_phi", [False, True])
@pytest.mark.parametrize("shape", [(3, 8, 32, 64), (2, 3, 5, 7)])
def test_x_update_kernel_takes_an_item_axis(cuda, shape, shared_phi):
    """N items in one launch (the tiles of a scene, each with its own masks;
    or a batch under one mask, item stride 0): equal to the plain version on
    the item tensors and to N single-item launches."""
    n, b, h, w = shape
    g = torch.Generator().manual_seed(4)
    theta = torch.rand(n, b, 4, h, w, generator=g).to(cuda)
    bd = ((torch.rand(n, b, 4, h, w, generator=g) - 0.5) * 0.2).to(cuda)
    phi = (torch.rand(*(() if shared_phi else (n,)), b, 4, h, w, generator=g) > 0.5).float().to(cuda)
    y = (torch.rand(n, b, 4, h, w, generator=g).to(cuda) * phi).sum(1)
    phis = physics.phi_sum(phi, physics.PACKED_FRAME_AXIS)
    before = cuda_kernels.launches["x_update"]
    got = cuda_kernels.admm_x_update(theta, bd, y, phi, phis, 0.55, 1.0)
    torch.testing.assert_close(got, physics.admm_x_update(theta, bd, y, phi, phis, 0.55, 1.0),
                               **TOL)
    gap = cuda_kernels.gap_x_update(theta, bd, y, phi, phis, 0.5, 0.01)
    torch.testing.assert_close(gap, physics.gap_x_update(theta, bd, y, phi, phis, 0.5, 0.01),
                               **TOL)
    assert cuda_kernels.launches["x_update"] == before + 2
    for i in range(n):
        pi, si = (phi, phis) if shared_phi else (phi[i], phis[i])
        one = cuda_kernels.admm_x_update(theta[i], bd[i], y[i], pi, si, 0.55, 1.0)
        assert torch.equal(one, got[i])
    with pytest.raises(ValueError):
        cuda_kernels.admm_x_update(theta, bd, y[:1], phi, phis, 0.55, 1.0)


@pytest.mark.parametrize("shape,design", [
    ((4, 1024, 1024), "grid"),      # the packed planes of a 2048^2 warm start: 128 strips of 8
    ((16, 288, 288), "cluster"),    # a 512 tile with 32 px of overlap: 8 strips of 36 rows
])
def test_tv_kernel_at_the_drivers_plane_shapes(cuda, shape, design):
    assert cuda_kernels.tv_plan(*shape[1:])[0] == design
    assert cuda_kernels.tv_plan(*shape[1:])[1:] == {"cluster": (8, 36), "grid": (128, 8)}[design]
    g = torch.Generator().manual_seed(5)
    noise = torch.rand(*shape, generator=g)
    smooth = torch.nn.functional.avg_pool2d(noise[None], 5, 1, 2)[0].contiguous()
    for x in (noise.to(cuda), smooth.to(cuda)):
        got, it = cuda_kernels.tv_chambolle_planes_cuda(x, 0.1, 2e-4, 5)
        want, want_it = tv.tv_chambolle_planes(x, 0.1, 2e-4, 5)
        torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(it, want_it)


def test_tv_kernel_matches_plain_and_golden(cuda):
    g = torch.Generator().manual_seed(1)
    x = torch.rand(6, 40, 1100, generator=g).to(cuda)  # rows wider than a block
    got, it = cuda_kernels.tv_chambolle_planes_cuda(x, 0.1, 2e-4, 5)
    want, want_it = tv.tv_chambolle_planes(x, 0.1, 2e-4, 5)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(it, want_it)
    gold = np.load(Path(__file__).parent / "goldens" / "tv_chambolle_golden.npz")
    out = cuda_kernels.tv_chambolle_fused(torch.from_numpy(gold["cube"]).to(cuda), 0.1)
    np.testing.assert_allclose(out.cpu().numpy(), gold["out"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("design", [None, "cluster", "grid", "block"])
@pytest.mark.parametrize("shape", [
    (32, 256, 256),   # the main path: 7 strips of 37 rows, the last of 34
    (1, 256, 256),    # one plane
    (3, 37, 53),      # h not a multiple of anything, w not a multiple of 4
    (2, 100, 201),    # 3 strips of 34 rows, the last of 32, odd width
    (2, 3, 10000),    # fewer rows than strips: empty strips; a row too wide for the grid
    (2, 300, 500),    # 8 strips, the last one short
    (2, 512, 512),    # too large for a cluster: the grid design by the shape rule, 29 strips
    (4, 1024, 1024),  # the warm start's planes at 2048^2: 128 strips of 8 rows, 2 groups
])
def test_tv_designs_match_plain(cuda, shape, design):
    """Every design against the plain version, noise and smooth planes (which
    stop early): same output, same iteration counts. The cluster design
    refuses a plane planned for another; the grid design one whose rows are
    too wide for its strips."""
    planned = cuda_kernels.tv_plan(*shape[1:])[0]
    g = torch.Generator().manual_seed(2)
    noise = torch.rand(*shape, generator=g)
    smooth = torch.nn.functional.avg_pool2d(noise[None], 3, 1, 1)[0].contiguous()
    for x in (noise.to(cuda), smooth.to(cuda)):
        if (design == "cluster" and planned != "cluster"
                or design == "grid" and cuda_kernels.tv_grid_strips(*shape[1:]) is None):
            with pytest.raises(ValueError):
                cuda_kernels.tv_chambolle_planes_cuda(x, 0.1, 2e-4, 5, design=design)
            continue
        before = cuda_kernels.launches["tv_chambolle"]
        got, it = cuda_kernels.tv_chambolle_planes_cuda(x, 0.1, 2e-4, 5, design=design)
        want, want_it = tv.tv_chambolle_planes(x, 0.1, 2e-4, 5)
        torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(it, want_it)
        assert cuda_kernels.launches["tv_chambolle"] == before + 1


def test_tv_cluster_design_gives_identical_bits_on_repeated_calls(cuda):
    """No atomics: the energy sums are added in a fixed order."""
    g = torch.Generator().manual_seed(3)
    x = torch.rand(32, 256, 256, generator=g).to(cuda)
    assert cuda_kernels.tv_plan(256, 256)[0] == "cluster"
    first, first_it = cuda_kernels.tv_chambolle_planes_cuda(x, 0.1, 2e-4, 5)
    for _ in range(3):
        again, again_it = cuda_kernels.tv_chambolle_planes_cuda(x, 0.1, 2e-4, 5)
        assert torch.equal(first, again) and torch.equal(first_it, again_it)
    assert cuda_kernels.tv_sms_used(32, 256, 256) > 32
    with pytest.raises(ValueError):
        cuda_kernels.tv_chambolle_planes_cuda(x, 0.1, 2e-4, 5, design="fast")


def test_tv_grid_design_gives_identical_bits_on_repeated_calls(cuda):
    """The 32 packed planes of a 2048^2 warm start on the grid design, noise
    and smooth (some stop early): equal to the plain version plane for plane,
    and the same bits on every call (the strips' sums are added in a fixed
    order, with no atomics)."""
    assert cuda_kernels.tv_plan(1024, 1024) == ("grid", 128, 8)
    g = torch.Generator().manual_seed(6)
    noise = torch.rand(32, 1024, 1024, generator=g)
    smooth = torch.nn.functional.avg_pool2d(noise[None], 5, 1, 2)[0].contiguous()
    for x in (noise.to(cuda), smooth.to(cuda)):
        first, first_it = cuda_kernels.tv_chambolle_planes_cuda(x, 0.1, 2e-4, 30)
        want, want_it = tv.tv_chambolle_planes(x, 0.1, 2e-4, 30)
        torch.testing.assert_close(first, want, **TOL)
        assert torch.equal(first_it, want_it)
        for _ in range(3):
            again, again_it = cuda_kernels.tv_chambolle_planes_cuda(x, 0.1, 2e-4, 30)
            assert torch.equal(first, again) and torch.equal(first_it, again_it)
    assert cuda_kernels.tv_sms_used(32, 1024, 1024) > 32


@pytest.mark.parametrize("shape,design", [((32, 1024, 1024), "grid"), ((3, 512, 512), "grid"),
                                          ((32, 256, 256), "cluster"),
                                          ((2, 1600, 1600), "block")])
def test_tv_design_launches_count_one_a_call(cuda, shape, design):
    """Each call is one launch of the planned design, counted once in
    ``launches`` and once in ``tv_design_launches``."""
    assert cuda_kernels.tv_plan(*shape[1:])[0] == design
    x = torch.rand(*shape, generator=torch.Generator().manual_seed(7)).to(cuda)
    before = dict(cuda_kernels.tv_design_launches)
    before_all = cuda_kernels.launches["tv_chambolle"]
    for calls in (1, 2):
        cuda_kernels.tv_chambolle_fused(x, 0.1)
        torch.cuda.synchronize()
        assert cuda_kernels.launches["tv_chambolle"] == before_all + calls
        assert cuda_kernels.tv_design_launches == {
            k: v + (calls if k == design else 0) for k, v in before.items()}


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    theta, bd, y, phi, phis = _xdata(cuda, 2, 8, 8)
    with pytest.raises(TypeError):
        cuda_kernels.admm_x_update(theta.double(), bd, y, phi, phis, 1.0, 1.0)
    with pytest.raises(ValueError):
        cuda_kernels.gap_x_update(theta, bd, y[:2], phi, phis)
    with pytest.raises(ValueError):
        cuda_kernels.tv_chambolle_fused(theta.transpose(-1, -2))
    with pytest.raises(ValueError):
        cuda_kernels.gap_x_update(theta, bd.cpu(), y, phi, phis)


@pytest.mark.parametrize("shape", [(2, 64, 64, 64), (1, 24, 32, 32), (2, 70, 94, 32),
                                   (3, 8, 16, 128), (1, 37, 5, 128), (1, 1, 1, 64)])
def test_convpair_kernel_matches_plain(cuda, shape):
    """Whole tiles, ragged tiles, images smaller than a tile, every C."""
    args = make_inputs(*shape, cuda)
    before = cuda_kernels.launches["convpair"]
    got = cuda_kernels.convpair(*args)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["convpair"] == before + 1
    want = convpair.convpair(*args).float()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert float((got.float() - want).abs().max()) < 2e-2 * float(want.abs().max())


@pytest.mark.parametrize("design", ["wgmma", "mma"])
@pytest.mark.parametrize("shape", [
    (8, 256, 256, 64), (8, 128, 128, 128),  # the main path's two shapes
    (2, 70, 94, 64), (2, 70, 94, 128),      # ragged tiles in both directions
    (1, 5, 40, 64), (1, 40, 5, 128), (1, 3, 3, 128),  # H or W smaller than one tile
    (3, 25, 29, 64),                        # several tiles a block, none whole
])
def test_convpair_designs_match_plain(cuda, shape, design):
    """The wgmma design and the kept mma.sync design, each named outright."""
    args = make_inputs(*shape, cuda)
    got = cuda_kernels.convpair(*args, design=design)
    torch.cuda.synchronize()
    want = convpair.convpair(*args).float()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(got.isfinite().all())
    assert float((got.float() - want).abs().max()) < 2e-2 * float(want.abs().max())
    assert cuda_kernels.convpair_launches[shape[3], shape[1], shape[2]] >= 1


def test_convpair_wgmma_design_is_not_built_for_c32(cuda):
    args = make_inputs(1, 8, 8, 32, cuda)
    assert cuda_kernels.CONVPAIR_DESIGN[32] == "mma"
    with pytest.raises(ValueError):
        cuda_kernels.convpair(*args, design="wgmma")
    with pytest.raises(ValueError):
        cuda_kernels.convpair(*args, design="fast")


@pytest.mark.parametrize("c", [32, 64, 128])
def test_convpair_kernel_zeroes_the_intermediate_outside_the_image(cuda, c):
    """Corners see 4 taps of the intermediate, edges 6, the interior 9."""
    x, w1, _, _, w2, _, _ = make_inputs(1, 30, 40, c, cuda)
    s, b1, b2 = torch.ones(c, device=cuda), torch.full((c,), 0.5, device=cuda), \
        torch.zeros(c, device=cuda)
    args = (torch.zeros_like(x), w1, s, b1, torch.full_like(w2, 0.01), s, b2)
    got = cuda_kernels.convpair(*args).float()
    full = 9 * c * 0.5 * float(args[4][0, 0, 0, 0])
    for (i, j), taps in (((15, 20), 9), ((0, 0), 4), ((29, 39), 4), ((0, 20), 6), ((15, 39), 6)):
        torch.testing.assert_close(got[0, i, j], torch.full((c,), full * taps / 9, device=cuda),
                                   rtol=1e-2, atol=0)


def test_convpair_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = list(make_inputs(1, 8, 8, 32, cuda))
    with pytest.raises(RuntimeError):  # no backward
        cuda_kernels.convpair(args[0], args[1].clone().requires_grad_(True), *args[2:])
    with torch.no_grad():  # the same tensors without grad mode run
        cuda_kernels.convpair(args[0], args[1].clone().requires_grad_(True), *args[2:])
    with pytest.raises(TypeError):
        cuda_kernels.convpair(args[0].float(), *args[1:])
    with pytest.raises(ValueError):
        cuda_kernels.convpair(args[0][..., :16].contiguous(), *args[1:])
    with pytest.raises(ValueError):
        cuda_kernels.convpair(args[0].permute(0, 2, 1, 3), *args[1:])
    with pytest.raises(ValueError):
        cuda_kernels.convpair(args[0], args[1].cpu(), *args[2:])


def test_bf16_fastdvdnet_runs_the_kernel_only_without_gradient(cuda):
    """Eight CvBlocks per denoiser call go through the kernel under no_grad,
    each reading a channels-last activation in place (no transposing copy);
    a forward with gradient takes the library route and still differentiates;
    the two routes agree at bf16 level."""
    root = Path(__file__).resolve().parent.parent
    net = FastDVDnet(dtype=torch.bfloat16, remat=False)
    net.load_state_dict(
        fastdvdnet_from_flax(load_variables_npz(str(root / "weights" / "fastdvd.npz"))))
    net.to(cuda).eval()
    layouts = []
    for m in net.modules():
        if isinstance(m, CvBlock):
            m.register_forward_pre_hook(lambda _, inp: layouts.append(
                inp[0].is_contiguous(memory_format=torch.channels_last)))
    g = torch.Generator().manual_seed(0)
    x = torch.rand(8, 64, 48, 3, generator=g).to(cuda)
    before = cuda_kernels.launches["convpair"]
    with torch.no_grad():
        fused = net.seq_circular(x, 12 / 255)
    assert cuda_kernels.launches["convpair"] == before + 8
    assert layouts == [True] * 8
    plain = net.seq_circular(x, 12 / 255)
    plain.square().mean().backward()
    assert cuda_kernels.launches["convpair"] == before + 8
    assert all(p.grad is not None and bool(p.grad.isfinite().all()) for p in net.parameters())
    assert float((fused - plain.detach()).abs().max()) < 1e-2


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("shape", [(3, 90, 5, 7), (3, 90, 127, 129)])
def test_bn_relu_kernel_equals_the_plain_epilogue_bit_for_bit(cuda, shape, channels_last):
    """C = 90: vectors of 8 straddle channels in both layouts (HW = 35 and
    16383 are not multiples of 8); the element count is not a multiple of 8
    either, and the larger shape takes several turns of the grid-stride loop.
    NaN, +-0 and negative inputs included."""
    n, c, h, w = shape
    g = torch.Generator().manual_seed(h)
    x = torch.randn(shape, generator=g) * 4
    flat = x.view(-1)
    flat[::97] = float("nan")
    flat[1::89] = 0.0
    flat[2::83] = -0.0
    x = x.to(torch.bfloat16).to(cuda)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    s = (torch.randn(c, generator=g) * 2).to(cuda)
    b = torch.randn(c, generator=g).to(cuda)
    s[:3] = torch.tensor([0.0, -0.0, -1.0])
    before = cuda_kernels.launches["bn_relu"]
    got = cuda_kernels.scale_shift_relu(x, s, b)
    want = convpair.scale_shift_relu(x, s, b)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["bn_relu"] == before + 1
    assert x.numel() % 8 and got.stride() == want.stride() == x.stride()
    assert bool(want.isnan().any()) and bool((want == 0).any())
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_bn_relu_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn(2, 90, 8, 8, device=cuda).to(torch.bfloat16)
    s, b = torch.randn(90, device=cuda), torch.randn(90, device=cuda)
    with pytest.raises(TypeError):
        cuda_kernels.scale_shift_relu(x.float(), s, b)
    with pytest.raises(ValueError):
        cuda_kernels.scale_shift_relu(x, s[:64], b[:64])
    with pytest.raises(ValueError):
        cuda_kernels.scale_shift_relu(x.transpose(2, 3), s, b)
    with pytest.raises(RuntimeError):  # no backward
        cuda_kernels.scale_shift_relu(x, s.clone().requires_grad_(True), b)
    with torch.no_grad():  # the same tensors without grad mode run
        cuda_kernels.scale_shift_relu(x, s.clone().requires_grad_(True), b)


def test_bf16_fastdvdnet_runs_the_epilogue_kernel_only_without_gradient(cuda, monkeypatch):
    """Ten epilogue launches per ``seq_circular`` call under no_grad (five
    BatchNorm'd library convolutions per DenBlock, two DenBlocks), equal bit
    for bit to the same call with PyTorch's passes; none with a gradient."""
    root = Path(__file__).resolve().parent.parent
    net = FastDVDnet(dtype=torch.bfloat16, remat=False)
    net.load_state_dict(
        fastdvdnet_from_flax(load_variables_npz(str(root / "weights" / "fastdvd.npz"))))
    net.to(cuda).eval()
    g = torch.Generator().manual_seed(0)
    x = torch.rand(8, 64, 48, 3, generator=g).to(cuda)
    before = cuda_kernels.launches["bn_relu"]
    with torch.no_grad():
        fused = net.seq_circular(x, 12 / 255)
        assert cuda_kernels.launches["bn_relu"] == before + 10
        monkeypatch.setattr(cuda_kernels, "scale_shift_relu", convpair.scale_shift_relu)
        plain = net.seq_circular(x, 12 / 255)
        monkeypatch.undo()
    assert torch.equal(fused, plain)
    net.seq_circular(x, 12 / 255).square().mean().backward()
    assert cuda_kernels.launches["bn_relu"] == before + 10
