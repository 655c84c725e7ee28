"""The port stands alone: it imports neither JAX nor the JAX package, and on
CPU tensors its kernel wrappers run the plain versions without launching."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent

_RUN = r"""
import sys
import numpy as np
import torch
from adaptivepnp_sci_torch import (ADMMConfig, AdaptConfig, FastDVDnet, FFDNet, GapTVConfig,
                                   fastdvd_prior, ffdnet_prior, reconstruct_single_dispatch)
from adaptivepnp_sci_torch import ab_convpair
from adaptivepnp_sci_torch.data.synthetic import make_scene
from adaptivepnp_sci_torch.models.convert import fastdvdnet_from_flax, load_variables_npz
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
try:
    ab_convpair.main(32, 16, 1)
except RuntimeError as err:
    assert "NVIDIA GPU" in str(err)
else:
    raise AssertionError("ab_convpair ran without a GPU")
assert cuda_kernels.launches == {"x_update": 0, "tv_chambolle": 0, "convpair": 0}, \
    cuda_kernels.launches
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "adaptivepnp_sci_tpu"))
print("FOREIGN", bad)
"""


def test_port_runs_without_importing_jax():
    out = subprocess.run([sys.executable, "-c", _RUN], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
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
    assert cuda_kernels.launches == {"x_update": 0, "tv_chambolle": 0, "convpair": 0}
    assert cuda_kernels._libs == {}  # nothing was built
