"""The photograph scene styles of the port vs the JAX package, on the CPU.

``adaptivepnp_sci_torch/data/assets/photos.npz`` holds PIL's decode of the
two photographs the JAX package reads through PIL (matplotlib's
``grace_hopper.jpg`` and ``adaptivepnp_sci_tpu/data/assets/street.png``);
``make_scene(style='photo'|'photos')``, the photograph clip styles of
``synthetic_video_dataset`` and ``synth --style photo`` are then the JAX
package's, bit for bit, with neither PIL nor matplotlib imported.
"""

import os
import subprocess
import sys
from pathlib import Path

import matplotlib
import numpy as np
import pytest
import scipy.io as sio
import torch
from PIL import Image

from adaptivepnp_sci_torch.cli import main as tmain
from adaptivepnp_sci_torch.data import synthetic as tsyn
from adaptivepnp_sci_torch.train import datasets as tdatasets
from adaptivepnp_sci_tpu.cli import main as jmain
from adaptivepnp_sci_tpu.data import synthetic as jsyn
from adaptivepnp_sci_tpu.train import datasets as jdatasets

ROOT = Path(__file__).resolve().parent.parent
SOURCES = {
    "hopper": os.path.join(matplotlib.get_data_path(), "sample_data", "grace_hopper.jpg"),
    "street": str(ROOT / "adaptivepnp_sci_tpu" / "data" / "assets" / "street.png"),
}
FIELDS = ("meas", "mask", "orig_bayer", "orig_rgb")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The other test workers share the cores: two intra-op threads while
    this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_npz_is_pils_decode(name):
    """The stored pixels are PIL's decode of the image on this machine, and
    the port's ``uint8 / 255`` is the JAX package's float32 conversion of
    the PIL image, bit for bit."""
    with np.load(tsyn._PHOTOS_NPZ) as z:
        u8 = z[name]
    img = Image.open(SOURCES[name])
    np.testing.assert_array_equal(u8, np.asarray(img))
    assert u8.dtype == np.uint8 and u8.shape == {"hopper": (600, 512, 3),
                                                 "street": (518, 774, 3)}[name]
    want = np.asarray(img, np.float32) / 255.0
    got = tsyn._photo_source(name=name)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("style, source, seed, n_meas", [
    ("photo", "hopper", 101, 1),
    ("photo", "hopper", 404, 2),
    ("photo", "street", 101, 2),
    ("photo", "street", 404, 1),
    ("photo", None, 7, 1),
    ("photos", None, 3, 2),
])
def test_make_scene_matches_jax(style, source, seed, n_meas):
    kw = dict(b=4, h=64, w=64, seed=seed, n_meas=n_meas, style=style, photo_source=source)
    got, want = tsyn.make_scene(**kw), jsyn.make_scene(**kw)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_upscaled_source_matches_jax():
    """A crop larger than the photograph zooms it (cached per scale)."""
    kw = dict(b=2, h=700, w=64, seed=5, style="photo", photo_source="street")
    got, want = tsyn.make_scene(**kw), jsyn.make_scene(**kw)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert any(scale > 1 for _, scale in tsyn._PHOTO_CACHE)


def test_clip_styles_match_jax():
    kw = dict(n_clips=6, length=3, size=24, seed=11, source_sizes=(48, 64),
              crops_per_video=2, styles=("photo", "photos", "leaves"))
    np.testing.assert_array_equal(tdatasets.synthetic_video_dataset(**kw),
                                  jdatasets.synthetic_video_dataset(**kw))


def test_synth_photo_file_matches_jax(tmp_path):
    argv = ["synth", "--style", "photo", "--photo-source", "street", "--size", "32",
            "--frames", "4", "--n-meas", "2", "--seed", "3"]
    tmain([*argv, "--out", str(tmp_path / "t.mat")])
    jmain([*argv, "--out", str(tmp_path / "j.mat")])
    got, want = sio.loadmat(str(tmp_path / "t.mat")), sio.loadmat(str(tmp_path / "j.mat"))
    keys = {k for k in want if not k.startswith("__")}
    assert {k for k in got if not k.startswith("__")} == keys
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k])


_NO_PIL = r"""
import sys
for name in ("PIL", "matplotlib"):
    sys.modules[name] = None  # any import of them fails
from adaptivepnp_sci_torch.data.synthetic import make_scene
for style in ("photo", "photos"):
    s = make_scene(b=2, h=16, w=16, seed=1, style=style)
    assert s.orig_rgb.shape == (2, 16, 16, 3)
print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "matplotlib")
                       and sys.modules[m] is not None))
"""


def test_photo_scene_without_pil_or_matplotlib():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _NO_PIL], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
