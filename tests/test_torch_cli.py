"""The port's CLI vs the JAX package's on the CPU: ``synth`` -> ``warmstart``
-> ``reconstruct`` -> ``eval`` -> ``serve --once`` through both ``main``s,
the port's with ``--device cpu``, and the port's refusals.

Both CLIs get the same ``.npz`` of FFDNet-color weights, written from
``ffdnet_color().init(PRNGKey(0), ...)``, on a 16x16 scene of 4 frames and 2
measurements (the Beauty row: 25 iterations, adaptation on). Each JAX
command runs once per module.
Bar: the saved ``v_recon_bayer`` within 1e-4 of JAX's, PSNR within 1e-3 dB.
"""

import contextlib
import io
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from adaptivepnp_sci_torch.cli import main as tmain
from adaptivepnp_sci_tpu.cli import main as jmain
from adaptivepnp_sci_tpu.models.ffdnet import ffdnet_color

SYNTH = ["--size", "16", "--frames", "4", "--n-meas", "2", "--seed", "3"]
RECON = ["--name", "Beauty", "--denoiser", "ffdnet", "--trainable-filter", "conv_0,conv_11"]
DX, DB = 1e-4, 1e-3


def _write_npz(path):
    variables = ffdnet_color().init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                    jnp.float32(0.1))
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
            else:
                flat["/".join(prefix + [k])] = np.asarray(v)

    walk(jax.device_get(variables), [])
    np.savez(path, **flat)


def _run(main, argv):
    """``main(argv)``'s standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _chain(main, d, ckpt, extra):
    """synth, warmstart, reconstruct, eval and serve in directory ``d``;
    returns the standard output of each command after warmstart."""
    os.makedirs(d)
    s, w, r = (os.path.join(d, f) for f in ("s.mat", "w.mat", "r.mat"))
    _run(main, ["synth", "--out", s] + SYNTH)
    _run(main, ["warmstart", "--data", s, "--out", w] + extra)
    out = {"reconstruct": _run(main, ["reconstruct", "--data", s, "--warm", w, "--ckpt", ckpt,
                                      "--out", r] + RECON + extra),
           "eval": _run(main, ["eval", r, "--data", s]),
           "eval_orig_real": _run(main, ["eval", r])}
    watch = os.path.join(d, "in")
    os.makedirs(watch)
    for f in ("a.mat", "b.mat"):
        shutil.copy(s, os.path.join(watch, f))
    with open(os.path.join(watch, "bad.mat"), "wb") as f:
        f.write(b"not a mat file")
    out["serve"] = _run(main, ["serve", "--watch", watch, "--out", os.path.join(d, "out"),
                               "--once", "--poll", "0.05", "--carry-weights", "--ckpt", ckpt]
                        + extra)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(4)
    root = tmp_path_factory.mktemp("cli")
    ckpt = str(root / "ffd.npz")
    _write_npz(ckpt)
    return root, ckpt


@pytest.fixture(scope="module")
def chains(runs):
    root, ckpt = runs
    return root, {name: _chain(main, str(root / name), ckpt, extra)
                  for name, main, extra in (("jax", jmain, []),
                                            ("torch", tmain, ["--device", "cpu"]))}


def _mat(root, who, name):
    return sio.loadmat(str(root / who / name))


def test_synth_and_warmstart_match_jax(chains):
    root, _ = chains
    a, b = _mat(root, "torch", "s.mat"), _mat(root, "jax", "s.mat")
    for k in ("meas_bayer", "mask_bayer", "orig_bayer", "orig"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(_mat(root, "torch", "w.mat")["v_Admm_tv_denoise"],
                               _mat(root, "jax", "w.mat")["v_Admm_tv_denoise"], atol=1e-5)


def test_reconstruct_matches_jax(chains):
    root, outs = chains
    a, b = _mat(root, "torch", "r.mat"), _mat(root, "jax", "r.mat")
    assert sorted(k for k in a if not k.startswith("__")) == \
        sorted(k for k in b if not k.startswith("__"))
    dx = float(np.abs(a["v_recon_bayer"] - b["v_recon_bayer"]).max())
    dp = float(np.abs(a["psnr"] - b["psnr"]).max())
    print(f"cli reconstruct parity: max |dx| {dx:.2e}, dPSNR {dp:.2e} dB")
    assert a["v_recon_bayer"].shape == (16, 16, 8) and dx <= DX and dp <= DB
    np.testing.assert_array_equal(a["orig_real"], b["orig_real"])
    np.testing.assert_array_equal(a["meas_bayer"], b["meas_bayer"])
    assert "s/measurement" in outs["torch"]["reconstruct"]


def test_eval_matches_jax(chains):
    root, outs = chains
    for key in ("eval", "eval_orig_real"):
        mine = outs["torch"][key].replace(str(root / "torch"), "")
        want = outs["jax"][key].replace(str(root / "jax"), "")
        assert "recomputed vs ground truth" in mine and "WARNING" not in mine
        assert mine == want
    # the port's eval on JAX's results prints what JAX's eval prints
    argv = ["eval", str(root / "jax" / "r.mat"), "--data", str(root / "jax" / "s.mat")]
    assert _run(tmain, argv) == _run(jmain, argv)


def test_serve_matches_jax_and_survives_a_bad_file(chains):
    root, outs = chains
    out = outs["torch"]["serve"]
    assert "bad.mat FAILED" in out and "a.mat ->" in out and "b.mat ->" in out
    assert sorted(os.listdir(root / "torch" / "out")) == ["a.mat", "b.mat"]
    for f in ("a.mat", "b.mat"):
        a, b = _mat(root, "torch", f"out/{f}"), _mat(root, "jax", f"out/{f}")
        np.testing.assert_allclose(a["v_recon_bayer"], b["v_recon_bayer"], atol=DX)
        np.testing.assert_allclose(a["psnr"], b["psnr"], atol=DB)


@pytest.mark.parametrize("argv, message", [
    (["reconstruct", "--denoiser", "ffdnet"], "no default checkpoint found"),
    (["reconstruct", "--ckpt", "{dir}"], "directory"),
    (["reconstruct", "--ckpt", "auto"], "--ckpt auto"),
    (["reconstruct", "--dm-update", "--random-init"], "require --deep-demosaicking"),
    (["reconstruct", "--ckpt", "{dir}/missing.pth"], "not found"),
    (["reconstruct", "--ckpt", "{scene}"], "unknown checkpoint format"),
    (["reconstruct", "--random-init", "--device", "cuda"], "no CUDA device"),
])
def test_refusals(runs, argv, message):
    root, _ = runs
    orbax_dir = root / "orbax_ckpt"
    orbax_dir.mkdir(exist_ok=True)
    argv = [a.replace("{dir}", str(orbax_dir)) for a in argv]
    if argv[0] == "reconstruct":
        scene = root / "refusal.mat"
        if not scene.exists():
            tmain(["synth", "--out", str(scene), "--size", "16", "--frames", "4"])
        argv = [a.replace("{scene}", str(scene)) for a in argv] + ["--data", str(scene)]
        if "--device" not in argv:
            argv += ["--device", "cpu"]
    else:
        argv += ["--out", str(root / "photo.mat")]
    if "cuda" in argv and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match=message):
        tmain(argv)
