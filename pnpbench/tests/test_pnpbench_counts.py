"""The benchmark's counts of operations and bytes, its trace arithmetic and
its traffic generator, on the CPU."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pnpbench import trace, traffic
from pnpbench.counts import adapt, fastdvdnet, ffdnet, k1, k2, k3


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("n,h,w", [(2, 16, 20), (1, 15, 17)])
def test_ffdnet_count_is_the_flop_counters(n, h, w):
    from adaptivepnp_sci_torch.models.ffdnet import FFDNet

    net = FFDNet(nc=96, nb=12).eval()
    x = torch.rand(n, h, w, 3)
    with torch.no_grad():
        got = counted(lambda: net(x, torch.tensor(0.1)))
    assert ffdnet.flops_per_call(n, h, w, 3, 96, 12, 3) == got


def test_ffdnet_flagship_count():
    # 892 GFLOP a call on 8 frames of 512^2 (PERF: decompose_flagship_floor)
    assert round(ffdnet.flops_per_call(8, 512, 512) / 1e9) == 892


def test_fastdvdnet_count_is_the_flop_counters():
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet

    net = FastDVDnet(dtype=None, remat=False).eval()
    x = torch.rand(4, 16, 24, 3)
    with torch.no_grad():
        got = counted(lambda: net.seq_circular(x, torch.tensor(0.05)))
    assert fastdvdnet.flops_per_call(4, 16, 24) == got


def test_k3_count_is_its_formula_and_the_pairs_convolutions():
    n, h, w, c = 3, 10, 12, 64
    assert k3.flops_per_launch(n, h, w, c) == 2 * 2 * 9 * c * c * n * h * w
    assert k3.bytes_per_launch(n, h, w, c) == 2 * n * h * w * c * 2 + 2 * 9 * c * c * 2 + 4 * c * 4
    from adaptivepnp_sci_torch.ops import convpair

    x = torch.rand(n, h, w, c)
    wk = torch.rand(3, 3, c, c) * 0.01
    s, b = torch.ones(c), torch.zeros(c)
    assert counted(lambda: convpair.convpair(x, wk, s, b, wk, s, b)) == k3.flops_per_launch(
        n, h, w, c)


def test_kernel_bytes_and_adaptation():
    # K1 on one 512^2 x 8 cube: theta, b, phi and out, then y and the mask sum
    assert k1.bytes_per_launch(8, 512, 512) == (4 * 8 * 4 * 256 * 256 + 2 * 4 * 256 * 256) * 4
    assert k2.bytes_per_launch(32, 256, 256) == 2 * 32 * 256 * 256 * 4
    assert k2.flops_per_launch(32, 256, 256, 5) == 5 * 32 * 256 * 256 * 22
    assert adapt.flops(10, 4) == 120


def test_generator_is_deterministic_in_the_seed():
    spec = {"frames": 4, "height": 32, "width": 48, "style": "leaves", "pool": 3,
            "check_requests": 2, "check_among_first": 6}
    seed = 2 ** 31 + 12345
    a, b = traffic.make(spec, seed, "cpu"), traffic.make(spec, seed, "cpu")
    c = traffic.make(spec, seed + 1, "cpu")
    assert torch.equal(a.masks, b.masks) and not torch.equal(a.masks, c.masks)
    assert all(torch.equal(x, y) for x, y in zip(a.measurements, b.measurements))
    assert not torch.equal(a.measurements[0], c.measurements[0])
    assert np.array_equal(a.order, b.order) and a.sample == b.sample
    assert traffic.noise_seed(seed, 3) == traffic.noise_seed(seed, 3) != traffic.noise_seed(seed, 4)
    assert traffic.noise_seed(seed, -1) != traffic.noise_seed(seed, 1)
    assert a.masks.shape == (4, 32, 48) and a.measurements[0].shape == (32, 48)
    # a measurement is the masked sum of mosaics in [0, 1]
    assert float(a.measurements[0].max()) <= 4.0 and float(a.measurements[0].min()) >= 0.0


def test_leaves_are_occluding_disks_over_grey():
    v = traffic.leaves_video(2, 64, 64, np.random.default_rng(0), "cpu")
    assert v.shape == (2, 64, 64, 3)
    assert 0.0 <= float(v.min()) and float(v.max()) <= 1.0
    assert len(torch.unique(v[0].reshape(-1, 3), dim=0)) > 20  # many disks show
    assert not torch.equal(v[0], v[1])  # they drift


def test_trace_union_gaps_and_kernel_time():
    ev = trace.Event
    tr = trace.Trace([(0, 100), (120, 150)],
                     [ev(10, 30, "x_update_kernel<true>"), ev(20, 40, "memcpy"),
                      ev(60, 70, "tv_chambolle_cluster_kernel"), ev(120, 140, "memcpy")],
                     [ev(40, 60, "aten::copy_"), ev(0, 100, "outer op")], {}, {})
    assert tr.window_s == 130e-9  # the requests in flight; 100-120 is the client's
    assert trace.busy_intervals(tr) == [(10, 40), (60, 70), (120, 140)]
    assert trace.busy_s(tr) == 60e-9
    assert trace.kernel_s(tr, "x_update") == 20e-9
    assert trace.kernel_s(tr, "tv_chambolle") == 10e-9
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0] == ["memcpy", 40e-9]
    assert bd["idle_gaps"][0] == ["outer op", 30e-9]  # 70 -> 100: only the outer op covers it
    assert ["aten::copy_", 20e-9] in bd["idle_gaps"]
    assert ["no profiled host op", 10e-9] in bd["idle_gaps"]  # 140 -> 150
