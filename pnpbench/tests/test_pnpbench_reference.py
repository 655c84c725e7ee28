"""The plain reference beside the port on the CPU, at 64x64x8 with cut
schedules, through the benchmark's own comparison (``harness.run``), and
piece by piece. Each tolerance says why it is what it is."""

import numpy as np
import pytest
import torch

from pnpbench import harness
from pnpbench.reference import fastdvdnet as ref_fastdvdnet
from pnpbench.reference import ffdnet as ref_ffdnet
from pnpbench.reference import precision, solver

SMALL = {"height": 64, "width": 64, "pool": 2, "warmup": 1, "check_requests": 2,
         "check_among_first": 2}
SCHEDULES = {
    "ffdnet_color.adaptive512": {"iters": [3, 2, 1], "adapt": {"interval_iter": 2},
                                 "warm_iters": 5},
    "fastdvdnet_bf16.adaptive512": {"iters": [4, 2], "adapt": {"interval_iter": 2},
                                    "warm_iters": 5},
    "ffdnet_color.warmstart2048": {"warm_iters": 10},
}


def small_cell(name: str) -> harness.Cell:
    return harness.load_cell(name, {"traffic": SMALL, "config": {"schedule": SCHEDULES[name]}})


def numbers(name: str, seed: int = 3) -> dict:
    out = harness.run(small_cell(name), seed, 0.05, False, "cpu", 0.0, log=open("/dev/null", "w"))
    assert out.result["failed"] == 0 and out.forbidden == []
    return out.numbers


@pytest.mark.parametrize("name", ["ffdnet_color.adaptive512", "ffdnet_color.warmstart2048"])
def test_float32_solves_agree(name):
    # On the CPU the port runs the plain float32 versions of its kernels,
    # the same operations in the same order as the reference: nothing but
    # the library's summation order may part them.
    got = numbers(name)
    assert got["x_max_abs"] <= 1e-6
    if "dtheta_rel" in got:
        assert got["dtheta_rel"] <= 1e-6


def test_bf16_fastdvdnet_solve_agrees():
    # The port keeps FastDVDnet's activations channels-last, so its CPU
    # convolutions sum in another order than the reference's and a bf16
    # rounding may land one ulp (2^-8 of the value) apart; the solve carries
    # such steps through 6 iterations (max 7e-3, rms 1.1e-3 read on three
    # seeds). Adam's first step is lr * sign(g), so a near-zero gradient whose
    # sign differs moves its weight the other way (0.12-0.15 read).
    got = numbers("fastdvdnet_bf16.adaptive512")
    assert got["x_max_abs"] <= 0.03
    assert got["x_rms"] <= 4e-3
    assert got["dtheta_rel"] <= 0.4


def test_ffdnet_forward_agrees():
    from adaptivepnp_sci_torch.models.ffdnet import FFDNet

    from pnpbench import weights

    p = weights.ffdnet_init(3, 3, 96, 12, 5, "cpu")
    net = FFDNet(nc=96, nb=12)
    net.load_state_dict(p)
    x = torch.rand(2, 31, 34, 3, generator=torch.Generator().manual_seed(1))
    s = torch.tensor(25 / 255)
    with torch.no_grad():
        # the same float32 convolutions: equal
        assert torch.equal(net.eval()(x, s), ref_ffdnet.forward(p, x, s, 12))


def test_fastdvdnet_forward_agrees():
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet

    from pnpbench import weights

    p = weights.fastdvdnet_from_npz("weights/fastdvd.npz", "cpu")
    net = FastDVDnet(dtype=torch.bfloat16, remat=False)
    net.load_state_dict(p)
    x = torch.rand(6, 32, 40, 3, generator=torch.Generator().manual_seed(2))
    s = torch.tensor(12 / 255)
    with torch.no_grad():
        a = net.eval().seq_circular(x, s)
        b = ref_fastdvdnet.seq_circular(p, x, s, "bfloat16")
        f8 = ref_fastdvdnet.seq_circular(p, x, s, "fp8")
    # one-ulp bf16 roundings (the port's channels-last sums), a few deep:
    # the residual of frames in [0, 1] within 2^-6
    assert float((a - b).abs().max()) <= 2 ** -6
    # the fp8 control parts from both by far more than they part
    assert float((f8 - b).abs().mean()) > 4 * float((a - b).abs().mean())


def test_tv_malvar_and_warm_start_agree():
    from adaptivepnp_sci_torch.ops import demosaic, tv
    from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, gap_tv

    g = torch.Generator().manual_seed(3)
    planes = torch.nn.functional.avg_pool2d(torch.rand(1, 6, 40, 36, generator=g), 5, 1, 2)[0]
    out_r, it_r = solver.tv_chambolle(planes, 0.1, 5)
    out_p, it_p = tv.tv_chambolle_planes(planes, 0.1, 2e-4, 5)
    assert torch.equal(out_r, out_p) and torch.equal(it_r, it_p.long())
    mos = torch.rand(3, 24, 20, generator=g)
    assert torch.equal(solver.malvar(mos), demosaic.malvar2004(mos))
    phi = (torch.rand(8, 32, 32, generator=g) > 0.5).float()
    y = (torch.rand(8, 32, 32, generator=g) * phi).sum(0)
    mine = solver.unpack(solver.gap_tv(y, phi, 7).x_p)
    port = gap_tv(y, phi, GapTVConfig(iters=7), device="cpu").x_bayer
    assert torch.equal(mine, port)


def test_fp8_rounding_and_tf32_switch():
    t = torch.tensor([0.3, -1.7, 100.0, 1e-3])
    q = precision.lowp(t, "fp8").float()
    # on the e4m3 grid under a power-of-two scale: 4 significant bits
    scale = 2.0 ** np.floor(np.log2(448 / 100))
    m = (q * scale).numpy()
    assert np.all(m == np.asarray(torch.tensor(m).to(torch.float8_e4m3fn).float()))
    assert float((q - t).abs().max()) <= 100 * 2 ** -4
    before = torch.backends.cudnn.allow_tf32
    with precision.tf32(True):
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32 == before
