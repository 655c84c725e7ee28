"""The deep-demosaicking row as the benchmark runs it (``pnpbench``'s cell
``fastdvdnet_ddnet.ddnet512``), on the CPU at small sizes: the port's DDnet
and its deep-demosaicking solve against the plain reference
(``pnpbench/reference/ddnet.py``, ``solver_demosaic.py``), the DDnet spans
and counters, and ``cli serve --deep-demosaicking``. Each tolerance says why
it is what it is, and the reference a precision lower (fp8, the cell's
control) fails it."""

import contextlib
import io
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io as sio
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from adaptivepnp_sci_torch.models.ddnet import DDnet  # noqa: E402
from adaptivepnp_sci_torch.solvers.priors import ddnet_demosaic  # noqa: E402
from adaptivepnp_sci_torch.utils import profiling  # noqa: E402

from pnpbench.reference import ddnet as ref_ddnet  # noqa: E402


def random_ddnet(seed: int) -> dict:
    """DDnet's PyTorch default initialisation under ``seed``, its window and
    branch weights drawn around 1."""
    torch.manual_seed(seed)
    sd = DDnet().state_dict()
    g = torch.Generator().manual_seed(seed)
    for k in sd:
        if k.startswith("weight_tensor"):
            sd[k] = 1 + 0.1 * torch.randn(sd[k].shape, generator=g)
    return sd


def windows(n: int, hw: int, seed: int) -> torch.Tensor:
    mos = torch.rand(n * 5, hw, hw, generator=torch.Generator().manual_seed(seed))
    return ref_ddnet.sparse_rgb(mos).reshape(n, 5, hw, hw, 3)


@pytest.mark.parametrize("hw", [32, 48])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_ddnet_matches_the_plain_reference(precision, hw):
    sd = random_ddnet(hw)
    x = windows(2, hw, hw + 1)
    net = DDnet(dtype=None if precision == "float32" else torch.bfloat16)
    net.load_state_dict(sd)
    with torch.no_grad():
        got = net.eval()(x)
    want = ref_ddnet.forward(sd, x, precision)
    fp8 = ref_ddnet.forward(sd, x, "fp8")
    d = (got - want).abs()
    if precision == "float32":
        # the same float32 convolutions; the port batches the three triplets
        # of a U-Net into one call, which may only change the library's
        # summation order
        assert float(d.max()) <= 1e-5
        return
    # The port keeps its activations channels-last, so a bf16 rounding may
    # land one ulp apart (2^-8 of a value in [0.5, 1): 3.9e-3); the residuals
    # and the mixing are float32, so such steps reach the output scaled down
    # (read: max 4.5e-4 to 9.0e-4, mean 1.8e-5 to 3.7e-5 over three seeds and
    # both sizes). fp8 reads max 0.018 to 0.030, mean 3.3e-3 to 4.7e-3.
    assert float(d.max()) <= 4e-3 and float(d.mean()) <= 2e-4
    e = (fp8 - want).abs()
    assert float(e.max()) > 4e-3 and float(e.mean()) > 2e-4


def test_npz_weights_load_as_the_ports_converter_reads_them():
    from adaptivepnp_sci_torch.models import convert

    mine = ref_ddnet.state_dict_from_npz(str(ROOT / "weights/ddnet.npz"), "cpu")
    port = convert.ddnet_from_flax(convert.load_variables_npz(str(ROOT / "weights/ddnet.npz")))
    assert mine.keys() == port.keys()
    assert all(torch.equal(mine[k], port[k]) for k in mine)
    DDnet().load_state_dict(mine)


# ------------------------------------------------------------ the solve

def _solve_pair(precision_ref: str):
    """The port's deep-demosaicking solve (bf16 FastDVDnet and DDnet with the
    repository's weights, adapting at k = 2 and 4) and the reference loop's,
    on one 32x32x8 leaves snapshot: (x, variables, reference)."""
    from adaptivepnp_sci_torch.adapt.online import AdaptConfig
    from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
    from adaptivepnp_sci_torch.solvers import end_to_end
    from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig
    from adaptivepnp_sci_torch.solvers.priors import fastdvd_prior
    from adaptivepnp_sci_torch.solvers.two_stage_admm import ADMMConfig

    from pnpbench import traffic, weights
    from pnpbench.reference import fastdvdnet as ref_fastdvdnet
    from pnpbench.reference import solver, solver_demosaic

    plan = traffic.make({"frames": 8, "height": 32, "width": 32, "style": "leaves", "pool": 1,
                         "check_requests": 1, "check_among_first": 1}, 2 ** 31 + 17, "cpu")
    fd = weights.fastdvdnet_from_npz(str(ROOT / "weights/fastdvd.npz"), "cpu")
    dd = ref_ddnet.state_dict_from_npz(str(ROOT / "weights/ddnet.npz"), "cpu")
    sigma, iters, lr = (8 / 255, 6 / 255), (4, 2), 2e-7
    admm = ADMMConfig(sigma=sigma, iters=iters, denoiser="fastdvd", demosaic_method="ddnet",
                      adapt=AdaptConfig(lr=lr, update_per_iter=2, interval_iter=2,
                                        initial_iter=1))
    model = FastDVDnet(dtype=torch.bfloat16, remat=False)
    model.load_state_dict(fd)
    res = end_to_end.reconstruct_single_dispatch(
        plan.measurements[0], plan.masks, GapTVConfig(iters=5), admm,
        fastdvd_prior(model.eval()), fd, device="cpu",
        generator=torch.Generator().manual_seed(5),
        demosaic_fn=ddnet_demosaic(DDnet(dtype=torch.bfloat16), dd))
    trainable = [k for k in fd if not k.endswith(("running_mean", "running_var",
                                                    "num_batches_tracked"))]
    ref = solver_demosaic.reconstruct(
        plan.measurements[0], plan.masks, 5,
        solver.Schedule(sigma, iters, 0.55, 100.0, 1.0, lr, 2, 2, 1),
        lambda p, rgb, s: ref_fastdvdnet.seq_circular(p, rgb, s, precision_ref),
        lambda m: ref_ddnet.demosaic(dd, m, precision_ref), fd, trainable, "bayer1", 5 / 255,
        torch.Generator().manual_seed(5))
    return res.x_bayer, res.variables, ref, fd, trainable


def _gaps(x, variables, ref, start, trainable):
    x_rms = float(((x.double() - ref.x_bayer.double()) ** 2).mean().sqrt())
    leaf = []
    for k in trainable:
        r = ref.params[k].double() - start[k].double()
        if r.norm() > 0:
            leaf.append(float((variables[k].double() - start[k].double() - r).norm()
                              / r.norm()))
    return x_rms, sorted(leaf)[len(leaf) // 2]


def test_deep_demosaicking_solve_matches_the_reference_loop():
    x, variables, ref, start, trainable = _solve_pair("bfloat16")
    x_rms, leaf_median = _gaps(x, variables, ref, start, trainable)
    # One-ulp bf16 roundings in both networks (the port's channels-last
    # sums), carried through 6 iterations: x_rms read 1.4e-3 to 1.6e-3 on
    # four seeds at this size. Adam's first step is lr * sign(g), so the
    # weights whose gradients are near zero flip with those roundings: the
    # median leaf's relative gap read 0.18 to 0.27 at 32^2 (the cell at
    # 512^2 sums each gradient over 256x more pixels).
    assert x_rms <= 6e-3 and leaf_median <= 0.45
    x8, v8, ref8, _, _ = _solve_pair("fp8")
    del x8, v8
    x_rms8, leaf8 = _gaps(x, variables, ref8, start, trainable)
    # the fp8 control (both networks) read x_rms 0.022 to 0.024 and the leaf
    # median 0.74 to 0.79 against the program at this size
    assert x_rms8 > 6e-3 and leaf8 > 0.45


# --------------------------------------------------------------- spans

@pytest.fixture
def recorder(monkeypatch):
    """A fresh span store for the test, so that no other test's spans show."""
    rec = profiling._Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def _small_deep_solve(dm_spec: bool):
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.ffdnet import FFDNet
    from adaptivepnp_sci_torch.solvers.end_to_end import reconstruct_single_dispatch
    from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig
    from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior
    from adaptivepnp_sci_torch.solvers.two_stage_admm import (ADMMConfig, make_dm_spec,
                                                              two_stage_admm)

    sc = make_scene(b=4, h=16, w=16, seed=3)
    cfg = ADMMConfig(sigma=(25 / 255, 12 / 255), iters=(2, 1), demosaic_method="ddnet")
    torch.manual_seed(0)
    prior = ffdnet_prior(FFDNet(nc=8, nb=3))
    params = {k: v.clone() for k, v in prior.model.state_dict().items()}
    dd = random_ddnet(1)
    if dm_spec:
        model = DDnet()
        model.load_state_dict(dd)
        return two_stage_admm(sc.meas, sc.mask, cfg, prior, params, device="cpu",
                              dm_spec=make_dm_spec(model, update_per_iter=2))
    return reconstruct_single_dispatch(sc.meas, sc.mask, GapTVConfig(iters=2), cfg, prior,
                                       params, device="cpu", demosaic_fn=ddnet_demosaic(DDnet(), dd))


def _cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("dm_spec", [False, True], ids=["fixed", "in_scan"])
def test_ddnet_spans_nest_in_the_demosaic_step_and_count_windows(recorder, dm_spec):
    off = _small_deep_solve(dm_spec)
    assert profiling.spans() == []  # nothing recorded with the profiler off
    with _cpu_profile():
        on = _small_deep_solve(dm_spec)
    assert torch.equal(off.x_bayer, on.x_bayer)
    got = profiling.spans()
    by_index = {s.index: s for s in got}
    solve = [s for s in got if s.parent == -1]
    assert [s.name for s in solve] == ["apnp.solve"]
    ddnet = [s for s in got if s.name == "apnp.ddnet"]
    adapts = [s for s in got if s.name == "apnp.dm_adapt"]
    demosaics = [s for s in got if s.name == "apnp.demosaic"]
    iters = 3
    assert len(demosaics) == iters
    # each forward nests in a demosaic step, directly or in its adaptation
    for s in ddnet:
        parent = by_index[s.parent]
        assert parent.name in ("apnp.demosaic", "apnp.dm_adapt")
        if parent.name == "apnp.dm_adapt":
            assert by_index[parent.parent].name == "apnp.demosaic"
    counters = solve[0].counters
    assert counters["apnp.ddnet_windows"] == len(ddnet) * 4  # calls x B
    if dm_spec:
        # each step's loss runs one forward, then the demosaic itself
        assert len(adapts) == iters and counters["apnp.dm_adam_steps"] == 2 * iters
        assert len(ddnet) == 3 * iters
    else:
        assert not adapts and "apnp.dm_adam_steps" not in counters
        assert len(ddnet) == iters and all(by_index[s.parent].name == "apnp.demosaic"
                                           for s in ddnet)


# ----------------------------------------------------------------- CLI

def _run(argv):
    from adaptivepnp_sci_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_serve_deep_demosaicking_matches_reconstruct(tmp_path):
    scene = str(tmp_path / "s.mat")
    _run(["synth", "--out", scene, "--size", "32", "--frames", "8", "--seed", "4"])
    common = ["--random-init", "--deep-demosaicking", "--device", "cpu"]
    _run(["reconstruct", "--data", scene, "--name", "Beauty", "--out",
          str(tmp_path / "r.mat")] + common)
    watch = tmp_path / "in"
    watch.mkdir()
    shutil.copy(scene, watch / "a.mat")
    out = _run(["serve", "--watch", str(watch), "--out", str(tmp_path / "out"), "--once",
                "--poll", "0.05", "--scene", "Beauty"] + common)
    assert "a.mat ->" in out and "FAILED" not in out
    served = sio.loadmat(str(tmp_path / "out" / "a.mat"))["v_recon_bayer"]
    want = sio.loadmat(str(tmp_path / "r.mat"))["v_recon_bayer"]
    assert served.shape == (32, 32, 8)
    np.testing.assert_array_equal(served, want)
    # the deep row differs from Malvar's
    malvar = tmp_path / "malvar"
    _run(["serve", "--watch", str(watch), "--out", str(malvar), "--once", "--poll", "0.05",
          "--scene", "Beauty", "--random-init", "--device", "cpu"])
    assert not np.array_equal(sio.loadmat(str(malvar / "a.mat"))["v_recon_bayer"], served)
    assert os.listdir(malvar) == ["a.mat"]
