"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and ``nvcc``; without a GPU they skip. On the card:
``python -m pytest tests/test_torch_cuda.py -q -m cuda``.
Bar: rtol 1e-5 / atol 1e-6, as for the Pallas kernels.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.ops import cuda_kernels, physics, tv

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
