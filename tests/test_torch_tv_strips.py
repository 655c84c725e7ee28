"""The decomposition behind the TV cluster kernel, on the CPU.

``csrc/tv_chambolle.cu`` cuts a plane into strips of rows, one per block of a
thread-block cluster: each block keeps its strip's state, the two halo rows
(``p_y`` of the row above for the divergence, ``out`` of the row below for the
gradient) are read from the neighbour strip, and each strip's two energy sums,
taken in float64, are added in rank order before every block takes the same
stop decision. :func:`tv_strips` below is that decomposition in plain PyTorch.
It is held against the port's plain version (equal bit for bit, equal
iteration counts) and against the JAX package (rtol 1e-5 / atol 1e-6: float32,
sums taken in another order). The shape rule that picks the design, the
cluster size and the strip height is tested beside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.ops import cuda_kernels
from adaptivepnp_sci_torch.ops import tv as ttv
from adaptivepnp_sci_tpu.ops import tv

TOL = dict(rtol=1e-5, atol=1e-6)


def tv_strips(planes, weight, eps, max_iter, cluster, strip_h):
    """The cluster kernel's arithmetic: ``cluster`` strips of ``strip_h`` rows
    (the last ones shorter or empty); returns ``(out, iterations)``."""
    img = planes.to(torch.float32)
    n, h, w = img.shape
    assert cluster * strip_h >= h
    tau = 0.25
    bounds = [(min(r * strip_h, h), min((r + 1) * strip_h, h)) for r in range(cluster)]
    im = [img[:, a:b] for a, b in bounds]
    out = [s.clone() for s in im]
    py = [torch.zeros_like(s) for s in im]
    px = [torch.zeros_like(s) for s in im]
    active = torch.ones(n, dtype=torch.bool)
    iters = torch.zeros(n, dtype=torch.int32)
    e_init = torch.zeros(n, dtype=torch.float64)
    e_prev = torch.zeros(n, dtype=torch.float64)
    for i in range(max_iter):
        if i > 0 and not bool(active.any()):
            break
        # phase 1, strip by strip: out = img + div(p); the row above the strip
        # comes from the neighbour's p_y
        new_out, dd = [], []
        for r, (a, b) in enumerate(bounds):
            d = -(py[r] + px[r])
            if b > a:
                d[:, 1:, :] += py[r][:, :-1, :]
                if a > 0:
                    d[:, 0, :] += py[r - 1][:, -1, :]
                d[:, :, 1:] += px[r][:, :, :-1]
            new_out.append(im[r] + d)
            dd.append((d.double() ** 2).sum((1, 2)))
        # phase 2: forward differences; the row below the strip comes from the
        # neighbour's out
        new_py, new_px, nn = [], [], []
        for r, (a, b) in enumerate(bounds):
            o = new_out[r]
            gy, gx = torch.zeros_like(o), torch.zeros_like(o)
            if b > a:
                gy[:, :-1, :] = o[:, 1:, :] - o[:, :-1, :]
                if b < h:
                    gy[:, -1, :] = new_out[r + 1][:, 0, :] - o[:, -1, :]
                gx[:, :, :-1] = o[:, :, 1:] - o[:, :, :-1]
            norm = torch.sqrt(gy * gy + gx * gx)
            coef = norm * (tau / weight) + 1.0
            new_py.append((py[r] - tau * gy) / coef)
            new_px.append((px[r] - tau * gx) / coef)
            nn.append(norm.double().sum((1, 2)))
        # phase 3: the strips' sums added in rank order, one decision per plane
        sum_dd = torch.zeros(n, dtype=torch.float64)
        sum_nn = torch.zeros(n, dtype=torch.float64)
        for r in range(cluster):
            sum_dd = sum_dd + dd[r]
            sum_nn = sum_nn + nn[r]
        e = (sum_dd + weight * sum_nn) / (h * w)
        sel = active[:, None, None]
        for r in range(cluster):
            out[r] = torch.where(sel, new_out[r], out[r])
            py[r] = torch.where(sel, new_py[r], py[r])
            px[r] = torch.where(sel, new_px[r], px[r])
        iters = iters + active.to(torch.int32)
        if i == 0:
            e_init = e
        else:
            active = active & ~((e_prev - e).abs() < eps * e_init)
        e_prev = torch.where(active, e, e_prev)
    return torch.cat(out, dim=1), iters


def _planes(seed, h, w):
    """Three smooth planes, which stop after 13 to 26 iterations, and three noisy
    ones, which stop after 21 to 25."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    smooth = np.stack([np.sin(3 * xx + k) * np.cos(2 * yy) for k in range(3)]) * 0.5 + 0.5
    noisy = rng.random((3, h, w), dtype=np.float32)
    return np.concatenate([smooth, noisy]).astype(np.float32)


@pytest.mark.parametrize("max_iter", [1, 5, 30])
@pytest.mark.parametrize("h,w,cluster", [(32, 40, 1), (32, 40, 2), (32, 40, 4), (32, 40, 8),
                                         (37, 29, 4), (9, 33, 8), (3, 50, 4), (32, 40, 7),
                                         (40, 24, 3)])
def test_strips_equal_the_plain_version_bit_for_bit(h, w, cluster, max_iter):
    """1, 2, 4 and 8 strips, 3 and 7 (an h that does not divide: a short last
    strip), more strips than rows need (empty strips), planes that stop
    early."""
    x = _planes(h * w + cluster, h, w)
    strip_h = -(-h // cluster)
    got, iters = tv_strips(torch.from_numpy(x), 0.1, 2e-4, max_iter, cluster, strip_h)
    want, want_iters = ttv.tv_chambolle_planes(torch.from_numpy(x), 0.1, 2e-4, max_iter)
    assert torch.equal(got, want)
    assert torch.equal(iters, want_iters)
    if max_iter == 30:  # every plane stops on its own, at its own iteration
        assert int(iters.max()) < 30 and int(iters.max()) > int(iters.min())
    if max_iter <= 5:
        # the solvers' depth. Over 30 iterations the JAX package, which sums
        # the energies in float32, may stop a plane one iteration apart from
        # the float64 sums here; that is the plain versions' difference, not
        # the strips'.
        jax_out = tv.tv_chambolle_multichannel(jnp.asarray(x), 0.1, 2e-4, max_iter)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), **TOL)


def test_strips_of_the_planned_shape_equal_the_plain_version():
    """The plan for a shape drives the emulation as it drives the kernel."""
    h, w = 150, 130
    design, cluster, strip_h = cuda_kernels.tv_plan(h, w)
    assert (design, cluster, strip_h) == ("cluster", 3, 50)
    x = torch.from_numpy(_planes(5, h, w))
    got, iters = tv_strips(x, 0.1, 2e-4, 5, cluster, strip_h)
    want, want_iters = ttv.tv_chambolle_planes(x, 0.1, 2e-4, 5)
    assert torch.equal(got, want) and torch.equal(iters, want_iters)


@pytest.mark.parametrize("h,w,want", [
    (256, 256, ("cluster", 7, 37)),      # the flagship's planes: 7 strips, the last of 34 rows
    (128, 128, ("cluster", 2, 64)),
    (32, 32, ("cluster", 1, 32)),        # the 64 x 64 parity runs: one block a plane
    (1, 1, ("cluster", 1, 1)),
    (37, 53, ("cluster", 1, 37)),
    (100, 200, ("cluster", 3, 34)),
    (3, 10000, ("cluster", 8, 1)),       # fewer rows than strips: empty strips
    (384, 384, ("cluster", 8, 48)),      # past the tuned strip size, still in shared memory
    (300, 500, ("cluster", 8, 38)),
    (512, 512, ("block", 1, 512)),       # the planes of a 1024 x 1024 snapshot
    (1024, 1024, ("block", 1, 1024)),    # the planes of a 2048 x 2048 snapshot
    (8, 40000, ("block", 1, 8)),         # one row is more than a strip may hold
])
def test_tv_plan(h, w, want):
    design, cluster, strip_h = got = cuda_kernels.tv_plan(h, w)
    assert got == want
    assert cluster in cuda_kernels.TV_CLUSTER_SIZES and cluster * strip_h >= h
    if design == "cluster":
        assert (strip_h * w * cuda_kernels.TV_STRIP_BYTES_PER_PIXEL
                <= cuda_kernels.TV_STRIP_SMEM_BYTES)
        # no smaller cluster would have met the strip size
        smaller = [c for c in cuda_kernels.TV_CLUSTER_SIZES if c < cluster]
        assert all(-(-h // c) * w > cuda_kernels.TV_STRIP_PIXELS for c in smaller)


def test_tv_plan_is_a_function_of_the_shape_alone():
    assert cuda_kernels.tv_plan(256, 256) == cuda_kernels.tv_plan(256, 256)
    for bad in ((0, 4), (4, 0), (-1, 8)):
        with pytest.raises(ValueError):
            cuda_kernels.tv_plan(*bad)


def test_wrappers_on_cpu_tensors_ignore_the_design():
    """A CPU tensor takes the plain version whatever design is named."""
    x = torch.from_numpy(_planes(0, 16, 24))
    np.testing.assert_array_equal(cuda_kernels.tv_chambolle_fused(x, 0.1),
                                  ttv.tv_chambolle_multichannel(x, 0.1))
    assert cuda_kernels.CONVPAIR_DESIGN == {32: "mma", 64: "wgmma", 128: "wgmma"}
    for design, (source, _, chans) in cuda_kernels.CONVPAIR_DESIGNS.items():
        assert source in cuda_kernels.SOURCES and cuda_kernels.SOURCES[source].exists()
        assert all(cuda_kernels.CONVPAIR_DESIGN[c] in cuda_kernels.CONVPAIR_DESIGNS
                   for c in chans), design
