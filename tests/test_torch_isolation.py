"""The port stands alone: it imports neither JAX nor the JAX package (nor PIL
or matplotlib to make a photograph scene), and on CPU tensors its kernel
wrappers run the plain versions without launching."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent

_RUN = r"""
import sys
# JAX, the JAX package, PIL and matplotlib are unimportable here
for name in ("jax", "jaxlib", "flax", "optax", "adaptivepnp_sci_tpu", "PIL", "matplotlib"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
from adaptivepnp_sci_torch import (ADMMConfig, AdaptConfig, DDnet, FastDVDnet, FFDNet,
                                   GapTVConfig, admm_config_for, ddnet_demosaic, fastdvd_prior,
                                   ffdnet_prior, make_dm_spec, reconstruct_single_dispatch)
from adaptivepnp_sci_torch import ab_convpair
from adaptivepnp_sci_torch.adapt.ddnet_online import make_dm_adapt_fn
from adaptivepnp_sci_torch.data.synthetic import make_scene
from adaptivepnp_sci_torch.models.convert import (ddnet_from_flax, fastdvdnet_from_flax,
                                                  load_variables_npz)
from adaptivepnp_sci_torch.ops import cuda_kernels

sc = make_scene(b=8, h=16, w=16, seed=0)
prior = ffdnet_prior(FFDNet(nc=8, nb=3))
res = reconstruct_single_dispatch(
    sc.meas, sc.mask, GapTVConfig(iters=3),
    ADMMConfig(sigma=(25 / 255, 12 / 255), iters=(3, 2),
               adapt=AdaptConfig(interval_iter=3)),
    prior, None, orig=sc.orig_bayer, device="cpu")
assert res.x_bayer.shape == (8, 16, 16) and bool(res.x_bayer.isfinite().all())
params = fastdvdnet_from_flax(load_variables_npz("weights/fastdvd.npz"))
for dtype in (None, torch.bfloat16):
    res = reconstruct_single_dispatch(
        sc.meas, sc.mask, GapTVConfig(iters=3),
        ADMMConfig(sigma=(12 / 255,), iters=(3,), denoiser="fastdvd",
                   adapt=AdaptConfig(lr=2e-7, interval_iter=2)),
        fastdvd_prior(FastDVDnet(dtype=dtype)), params, orig=sc.orig_bayer, device="cpu")
    assert res.x_bayer.shape == (8, 16, 16) and bool(res.x_bayer.isfinite().all())
# the deep-demosaicking modules: the scene table's row, DDnet fixed and adapted
dd = ddnet_from_flax(load_variables_npz("weights/ddnet.npz"))
row = admm_config_for("Bosphorus", "fastdvd", deep_demosaicking=True)
assert row.demosaic_method == "ddnet" and row.select_best_holdout == 0.05
rgb = ddnet_demosaic(DDnet(), dd)(torch.from_numpy(sc.orig_bayer))
assert rgb.shape == (8, 16, 16, 3) and bool(rgb.isfinite().all())
assert make_dm_spec(DDnet()).update_per_iter == 1
state, _, loss = make_dm_adapt_fn(DDnet())(dd, None, torch.from_numpy(sc.orig_bayer))
assert state.keys() == dd.keys() and bool(loss.isfinite())
# the multi-measurement drivers, the carried Adam, gap_deep, Menon and gray
from adaptivepnp_sci_torch import (GapDeepConfig, GrayConfig, gap_deep, gap_denoise_gray,
                                   menon2007, two_stage_admm_batched, two_stage_admm_sequence,
                                   two_stage_admm_tiled)
from adaptivepnp_sci_torch.models.convert import (adam_state_from_optax, adam_state_to_optax,
                                                  ffdnet_from_flax, ffdnet_to_flax)
carried = ADMMConfig(sigma=(25 / 255,), iters=(3,), demosaic_method="menon2007",
                     adapt=AdaptConfig(interval_iter=2, initial_iter=0, fresh_opt_per_trigger=False))
tiled = two_stage_admm_tiled(sc.meas, sc.mask, carried, tile=8, prior=prior, overlap=2,
                             tile_chunk=2, orig_bayer=sc.orig_bayer, device="cpu")
assert tiled.x_bayer.shape == (8, 16, 16) and int(tiled.opt_state["state"][0]["step"]) == 4
count, mu, nu = adam_state_to_optax(tiled.opt_state, prior.model, ffdnet_to_flax)
state = adam_state_from_optax(count, mu, nu, prior.model, ffdnet_from_flax, 2e-6)
assert torch.equal(state["state"][0]["exp_avg"], tiled.opt_state["state"][0]["exp_avg"])
y2 = np.stack([sc.meas, sc.meas])
seq = two_stage_admm_sequence(y2, sc.mask, carried, prior, tiled.variables, device="cpu")
assert seq.x_bayer.shape == (2, 8, 16, 16) and int(seq.opt_state["state"][0]["step"]) == 4
bat = two_stage_admm_batched(y2, sc.mask, ADMMConfig(sigma=(0.1,), iters=(2,), denoiser="tv"),
                             device="cpu")
assert bat.x_bayer.shape == (2, 8, 16, 16)
gd = gap_deep(sc.meas, sc.mask, GapDeepConfig(sigma=(0.1,), iters=(2,)), prior, None, device="cpu")
assert gd.x_rgb.shape == (8, 16, 16, 3)
assert menon2007(torch.from_numpy(sc.orig_bayer)).shape == (8, 16, 16, 3)
gr = gap_denoise_gray(sc.meas, sc.mask, GrayConfig(iters=(3,)), device="cpu")
assert bool(gr.x.isfinite().all())
# the user's entry points: scene I/O, the pipelines and the CLI, in process
import contextlib, io, os, tempfile
from adaptivepnp_sci_torch import cli, pipelines
from adaptivepnp_sci_torch.data import mat_io
with tempfile.TemporaryDirectory() as d:
    scene, res = os.path.join(d, "s.mat"), os.path.join(d, "r.mat")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        cli.main(["synth", "--out", scene, "--size", "16", "--frames", "4", "--n-meas", "2"])
        cli.main(["reconstruct", "--data", scene, "--random-init", "--out", res,
                  "--device", "cpu"])
    assert "s/measurement" in out.getvalue(), out.getvalue()
    sd = mat_io.load_cacti_mat(scene, "Beauty")
    assert sd.meas.shape == (2, 16, 16) and sd.orig_bayer.shape == (2, 4, 16, 16)
    ws = pipelines.run_warm_start(sd, iters=3, device="cpu")
    assert ws.x_bayer.shape == (2, 4, 16, 16)
    assert mat_io.load_warm_start.__module__ == "adaptivepnp_sci_torch.data.mat_io"
    # offline training and the standalone denoiser test, and the corruption masks
    from adaptivepnp_sci_torch import Trainer, TrainerConfig
    from adaptivepnp_sci_torch.ops import corruption
    from adaptivepnp_sci_torch.train import augment, datasets, regularizers, tasks
    with contextlib.redirect_stdout(io.StringIO()) as out:
        cli.main(["train", "--network", "ffdnet", "--steps", "1", "--batch", "2", "--patch", "16",
                  "--ckpt-dir", os.path.join(d, "ck"), "--device", "cpu"])
        cli.main(["denoise", "--network", "ffdnet", "--ckpt", os.path.join(d, "ck", "final.pt"),
                  "--size", "16", "--device", "cpu"])
    assert "trained ffdnet for 1 steps" in out.getvalue() and "denoised" in out.getvalue(), \
        out.getvalue()
    masked = corruption.mask_block(torch.Generator().manual_seed(0), torch.ones(1, 5, 4, 4, 3), 0.5)
    assert 0 < float((masked < 1).float().mean()) < 1
# the remaining models and utilities, the photograph scenes and the six-scene run
from adaptivepnp_sci_torch import run_all_scenes
from adaptivepnp_sci_torch.models import blocks, feature, ffdnet_ipol
from adaptivepnp_sci_torch.models.ddnet import PyramidEncoder
from adaptivepnp_sci_torch.models.fastdvdnet import SpatialDnCNN
from adaptivepnp_sci_torch.ops.resize import imresize
from adaptivepnp_sci_torch.utils import image
photo = make_scene(b=2, h=16, w=16, seed=1, style="photo", photo_source="street")
assert photo.orig_rgb.shape == (2, 16, 16, 3)
assert imresize(photo.orig_rgb[0], 0.5).shape == (8, 8, 3)
assert image.rgb2ycbcr(photo.orig_rgb[0]).shape == (16, 16)
x = torch.from_numpy(photo.orig_rgb)
assert ffdnet_ipol.FFDNetIPOL(3, 8, 3).denoise(x, 0.1).shape == x.shape
assert SpatialDnCNN()(x, 0.1).shape == x.shape
assert PyramidEncoder(8, 1)(torch.rand(1, 16, 16, 4)).shape == (1, 4, 4, 8)
assert feature.VGGFeatures(5)(x).shape == (2, 8, 8, 64)
assert blocks.RRDB(4, 2)(torch.rand(1, 4, 8, 8)).shape == (1, 4, 8, 8)
with tempfile.TemporaryDirectory() as d:
    with contextlib.redirect_stdout(io.StringIO()):
        rows = run_all_scenes.main(d, "ffd", b=2, h=16, w=16, n_meas=1, scenes=["Beauty"],
                                   random_init=True, device="cpu")
    assert rows[0][:3] == ("Beauty", "ffd", "photo") and os.path.exists(
        os.path.join(d, run_all_scenes.TABLE_NAME))
# the parallel and host modules: a one-process mesh (every collective the
# identity), the sharded prior and the DP step on it, the native ring, video, profiling
from adaptivepnp_sci_torch import multihost_validation
from adaptivepnp_sci_torch.data import native_loader, video
from adaptivepnp_sci_torch.parallel import halo_windows, make_mesh
from adaptivepnp_sci_torch.parallel.distributed import global_mesh, initialize
from adaptivepnp_sci_torch.parallel.sharded import fastdvd_prior_sharded, make_dp_train_step
from adaptivepnp_sci_torch.utils import profiling
mesh = global_mesh()
assert halo_windows(torch.arange(4.0), mesh, window=3).shape == (4, 3)
sprior = fastdvd_prior_sharded(FastDVDnet(), mesh)
with torch.no_grad():
    out = sprior.apply(FastDVDnet().eval(), torch.rand(4, 8, 8, 3), torch.tensor(0.1))
assert out.shape == (4, 8, 8, 3)
net = FFDNet(nc=8, nb=3)
step, place = make_dp_train_step(net, torch.optim.Adam(net.parameters()), mesh)
assert bool(step(*place(np.ones((2, 8, 8, 3), np.float32), np.ones((2, 8, 8, 3), np.float32),
                        np.full(2, 0.1, np.float32))).isfinite())
assert callable(initialize) and "video_clip_dataset" in dir(video)
assert multihost_validation.CASES and callable(native_loader.iter_npy_prefetched)
timer = profiling.StepTimer()
with timer.measure() as h:
    h["out"] = torch.ones(2)
# the weight tooling: the Jacobian's power iteration, the FFDNet teacher from a
# /-keyed .npz, the training schedule, the seam metric
from adaptivepnp_sci_torch import (distill_fastdvd, distill_iterates, eval_weights,
                                   harvest_iterates, measure_tile_seams, regenerate_weights)
from adaptivepnp_sci_torch.train.trainer import save_variables_npz
smax = eval_weights.sigma_max_eval(FastDVDnet(), params, torch.rand(1, 5, 8, 8, 3),
                                   torch.Generator().manual_seed(0), iters=1)
assert smax > 0
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "teacher.npz")
    save_variables_npz(path, multihost_validation.flax_style_ffdnet_params(96, 12, seed=0))
    with torch.no_grad():
        out = distill_fastdvd.teacher_fn(path, "cpu")(torch.rand(2, 8, 8, 3), torch.full((2,), 0.1))
    assert out.shape == (2, 8, 8, 3)
assert regenerate_weights.schedule(64, 6) == (2, (2, 2))
assert len(measure_tile_seams.seam_psnrs(sc.orig_bayer, sc.orig_bayer * 0.9, 8, 2)) == 3
assert callable(harvest_iterates.run_loop_and_harvest) and callable(distill_iterates.make_pool)
# the A/B, sweep and decomposition tools: every module, one table at 16x16
from adaptivepnp_sci_torch import (ab_cv_guard, ab_ddnet_precision, ab_demosaic_select,
                                   ab_ffdnet_precision, ab_kernels_adapt, ab_weight_select,
                                   bench_2048_adaptive, bench_fastdvd_bf16,
                                   decompose_fastdvd_floor, decompose_flagship_floor,
                                   diag_teacher_sigma, eval_teacher_inloop, studies,
                                   sweep_fastdvd_relax, sweep_fidelity)
small = ffdnet_from_flax(multihost_validation.flax_style_ffdnet_params(8, 3, seed=0))
with contextlib.redirect_stdout(io.StringIO()) as out:
    rows = ab_ffdnet_precision.main(small, 16, "cpu", studies.flagship_config(iters=(2, 1, 1)),
                                    lambda **kw: FFDNet(nc=8, nb=3, **kw), n=0)
assert [r[0] for r in rows] == ["fp32", "mixed", "bf16"] and "| mode |" in out.getvalue()
assert callable(ab_kernels_adapt.admm_row) and callable(decompose_fastdvd_floor.main)
try:
    ab_convpair.main(32, 16, 1)
except RuntimeError as err:
    assert "NVIDIA GPU" in str(err)
else:
    raise AssertionError("ab_convpair ran without a GPU")
# the timing drivers: bench's warm-start mode, one batch, two suite rows at 16x16
from adaptivepnp_sci_torch import bench, bench_batched, run_benchmark_suite
with contextlib.redirect_stdout(io.StringIO()) as out:
    line, _ = bench.main("warmstart", "cpu", 16, n=0)
    batches = bench_batched.main(batches=(1,), size=16, device="cpu", n=0,
                                 config=ADMMConfig(sigma=(0.1,), iters=(1,)))
    suite = run_benchmark_suite.run_rows(16, "cpu", cut=1, interval=1, n=0, rows=("1", "6"))
assert line["device"] == "cpu" and '"psnr_db"' in out.getvalue() and "batch  1:" in out.getvalue()
assert batches[0][5].shape == (1, 8, 16, 16) and [r[0] for r in suite] == ["1", "6"]
assert set(run_benchmark_suite.suite_configs()) == set(run_benchmark_suite.ROWS) - {"1"}
assert cuda_kernels.launches == {"x_update": 0, "tv_chambolle": 0, "convpair": 0,
                                 "bn_relu": 0}, cuda_kernels.launches
bad = sorted(m for m in sys.modules if sys.modules[m] is not None and m.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax", "adaptivepnp_sci_tpu", "PIL", "matplotlib"))
print("FOREIGN", bad)
"""


def test_port_runs_without_importing_jax():
    # one thread each: the run shares the machine with the other test workers
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _RUN], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "FOREIGN []" in out.stdout, out.stdout


def _imported_modules(path: Path) -> set[str]:
    """Top-level names of every module a Python file imports, statically or
    through ``importlib.import_module`` / ``__import__`` with a literal."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_no_source_imports_jax():
    files = sorted((ROOT / "adaptivepnp_sci_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    foreign = {"jax", "jaxlib", "flax", "optax", "adaptivepnp_sci_tpu"}
    for f in files:
        assert not _imported_modules(f) & foreign, f


def test_cpu_tensors_take_plain_path_without_launches(rng):
    from adaptivepnp_sci_torch.ab_convpair import make_inputs
    from adaptivepnp_sci_torch.ops import convpair, cuda_kernels, physics, tv

    cuda_kernels.reset_launches()
    theta, b, phi = (torch.from_numpy(rng.random((4, 4, 8, 8), dtype=np.float32))
                     for _ in range(3))
    y, phis = (torch.from_numpy(rng.random((4, 8, 8), dtype=np.float32) + 1) for _ in range(2))
    assert torch.equal(cuda_kernels.admm_x_update(theta, b, y, phi, phis, 1.0, 1.0),
                       physics.admm_x_update(theta, b, y, phi, phis, 1.0, 1.0))
    assert torch.equal(cuda_kernels.gap_x_update(theta, b, y, phi, phis, 0.5),
                       physics.gap_x_update(theta, b, y, phi, phis, 0.5))
    assert torch.equal(cuda_kernels.tv_chambolle_fused(theta),
                       tv.tv_chambolle_multichannel(theta))
    pair = make_inputs(1, 6, 5, 32, torch.device("cpu"))
    assert torch.equal(cuda_kernels.convpair(*pair), convpair.convpair(*pair))
    act = pair[0].permute(0, 3, 1, 2)
    assert torch.equal(cuda_kernels.scale_shift_relu(act, pair[2], pair[3]),
                       convpair.scale_shift_relu(act, pair[2], pair[3]))
    assert cuda_kernels.launches == {"x_update": 0, "tv_chambolle": 0, "convpair": 0,
                                     "bn_relu": 0}
    assert cuda_kernels._libs == {}  # nothing was built
