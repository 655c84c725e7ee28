"""The port's ``Trainer`` and its ``train`` / ``denoise`` subcommands vs the
JAX package's, on the CPU.

* ``Trainer``: 4 FastDVDnet steps at 16x16, batch 2, from the same weights
  with JAX's draws injected, ``steps_per_epoch=1`` and ``milestones=(0, 1)``
  (so the updates run at lr, lr/10, lr/1000, lr/1000) and the SVD
  orthogonalization after every step up to the last milestone's epoch. Bars:
  the loss trace within 1e-5 relative; the parameters within 1e-4 absolute,
  a tenth of one Adam step at lr 1e-3 (each step moves a weight by about
  lr); the BatchNorm statistics within 1e-5 relative to the collection's
  largest entry.
* Checkpoints: save, restore and continue equal to uninterrupted steps, bit
  for bit; ``save_variables_npz`` read by the JAX package's
  ``load_variables_npz``, its apply within 1e-5 of the port's.
* CLI: ``train`` for each network, ``train --resume``, ``reconstruct`` from
  the trained ``final.pt``; ``denoise`` against the JAX CLI's on the same
  weights at ``--size 32``: printed PSNRs within 0.01 dB, ``--out`` arrays
  within 1e-5.
"""

import contextlib
import io
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaptivepnp_sci_torch.cli import main as tmain
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet as TFastDVDnet
from adaptivepnp_sci_torch.models.ffdnet import FFDNet as TFFDNet
from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color as tffdnet_color
from adaptivepnp_sci_torch.models.ffdnet import ffdnet_gray as tffdnet_gray
from adaptivepnp_sci_torch.train import Trainer as TTrainer
from adaptivepnp_sci_torch.train import TrainerConfig as TTrainerConfig
from adaptivepnp_sci_torch.train import tasks as ttasks
from adaptivepnp_sci_torch.train import trainer as ttrainer
from adaptivepnp_sci_tpu.cli import main as jmain
from adaptivepnp_sci_tpu.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_tpu.train import Trainer, TrainerConfig
from adaptivepnp_sci_tpu.train.tasks import fastdvd_task
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz
from tests.test_torch_train_tasks import Draws, push_jax_draws

WEIGHTS = Path(__file__).resolve().parent.parent / "weights"
CFG = dict(lr=1e-3, steps_per_epoch=1, milestones=(0, 1), orthogonalize_every=1, seed=42)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Small tensors gain nothing from many threads, and the other test
    workers share the cores: two intra-op threads while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clips(seed, n=2):
    return np.random.default_rng(seed).random((n, 5, 16, 16, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def fdvd_vars():
    return load_variables_npz(str(WEIGHTS / "fastdvd.npz"))


@pytest.fixture(scope="module")
def jax_run(fdvd_vars):
    """Four steps of the JAX Trainer, and its step keys."""
    batches = [_clips(20 + i) for i in range(4)]
    trainer = Trainer(fastdvd_task(FastDVDnet(remat=False)), fdvd_vars, TrainerConfig(**CFG))
    keys, key = [], jax.random.PRNGKey(CFG["seed"])
    for _ in batches:
        key, sub = jax.random.split(key)
        keys.append(sub)
    losses = [float(trainer.train_step(b)) for b in batches]
    return batches, keys, losses, jax.tree_util.tree_map(np.asarray, trainer.variables)


def _port_trainer(variables):
    return TTrainer(ttasks.fastdvd_task(TFastDVDnet()), tconvert.state_dict_from_flax(variables),
                    TTrainerConfig(**CFG), device="cpu")


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_learning_rate_schedule_matches_optax():
    for spe, ms in ((1, (0, 1)), (3, (1, 2)), (2, (1, 1))):
        cfg = TTrainerConfig(lr=1e-3, steps_per_epoch=spe, milestones=ms)
        sched = optax.piecewise_constant_schedule(
            1e-3, {(ms[0] + 1) * spe: 0.1, (ms[1] + 1) * spe: 0.01})
        trainer = TTrainer(ttasks.ffdnet_task(TFFDNet(nc=4, nb=2)), None, cfg, device="cpu")
        for count in range(12):
            assert trainer.learning_rate(count) == pytest.approx(float(sched(count)), rel=1e-6)


def test_trainer_matches_jax_over_both_milestones(monkeypatch, fdvd_vars, jax_run):
    batches, keys, jlosses, jvars = jax_run
    draws = Draws(monkeypatch)
    for key, b in zip(keys, batches):
        push_jax_draws(draws, "fastdvd", key, b.shape)
    trainer = _port_trainer(fdvd_vars)
    lrs = [trainer.learning_rate(i) for i in range(4)]
    assert lrs == pytest.approx([1e-3, 1e-4, 1e-6, 1e-6])
    losses = trainer.fit(iter(batches), max_steps=4, log_every=10**9)
    assert draws.empty() and trainer.step == 4 and trainer.epoch == 4
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, jlosses))
    got = tconvert.flax_from_state_dict(trainer.variables)
    mine, want = _flat(got["params"]), _flat(jvars["params"])
    start = _flat(fdvd_vars["params"])
    dparam = max(float(np.abs(mine[k] - want[k]).max()) for k in want)
    moved = max(float(np.abs(want[k] - start[k]).max()) for k in want)
    smine, swant = _flat(got["batch_stats"]), _flat(jvars["batch_stats"])
    allw = np.concatenate([v.ravel() for v in swant.values()])
    dstats = max(float(np.abs(smine[k] - swant[k]).max()) for k in swant) / np.abs(allw).max()
    print(f"trainer vs JAX: loss {loss_rel:.2e} rel, params {dparam:.2e} abs "
          f"(moved {moved:.2e}), stats {dstats:.2e} rel")
    assert loss_rel <= 1e-5 and dparam <= 1e-4 and dstats <= 1e-5 and moved > 1e-2


def test_save_restore_continue_equals_uninterrupted(tmp_path, fdvd_vars):
    """Two steps, a checkpoint, two more; against a trainer restored from
    the checkpoint and taking the same two: bit for bit (weights, Adam
    state, BatchNorm statistics, losses, generator)."""
    batches = [_clips(30 + i) for i in range(4)]
    a = _port_trainer(fdvd_vars)
    a.fit(iter(batches[:2]), max_steps=2, log_every=10**9)
    path = a.save(str(tmp_path / "ck" / "mid.pt"))
    la = a.fit(iter(batches[2:]), max_steps=4, log_every=10**9)
    b = _port_trainer(fdvd_vars)
    b.restore(path)
    assert b.step == 2
    lb = b.fit(iter(batches[2:]), max_steps=4, log_every=10**9)
    assert la == lb
    for k, v in a.variables.items():
        assert torch.equal(v, b.variables[k]), k
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for i in sa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k])
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    # the default path, and a checkpoint every ckpt_every_epochs epochs
    c = TTrainer(ttasks.fastdvd_task(TFastDVDnet()), tconvert.state_dict_from_flax(fdvd_vars),
                 TTrainerConfig(**dict(CFG, ckpt_dir=str(tmp_path / "auto"), ckpt_every_epochs=1)),
                 device="cpu")
    c.fit(iter(batches[:1]), max_steps=1, log_every=1)
    assert (tmp_path / "auto" / "step_1.pt").exists()
    with pytest.raises(ValueError, match="orbax"):
        c.restore(str(tmp_path))


def test_npz_export_is_read_by_jax(tmp_path, fdvd_vars):
    """``save_variables_npz`` writes the Flax layout: the JAX package's reader
    and FastDVDnet apply on it agree with the port's model within 1e-5, and
    the port reads the file back as the same state dict."""
    trainer = _port_trainer(fdvd_vars)
    trainer.fit(iter([_clips(40)]), max_steps=1, log_every=10**9)
    path = str(tmp_path / "fdvd.npz")
    ttrainer.save_variables_npz(path, trainer.variables)
    jvars = load_variables_npz(path)
    x = _clips(41)
    want = jax.jit(lambda v, w: FastDVDnet().apply(v, w, jnp.float32(0.05)))(jvars, jnp.asarray(x))
    net = trainer.net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x), 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    back = ttrainer.load_checkpoint_variables(path)
    for k, v in trainer.variables.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, back[k]), k


# ---------------------------------------------------------------------- CLI


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_cli_train_resume_and_reconstruct(tmp_path):
    """``train`` for each network at 16x16, batch 2, 2 steps; ``--resume``
    continues the step count; ``reconstruct`` reads the trained ``final.pt``;
    orbax directories are refused."""
    common = ["--steps", "2", "--batch", "2", "--patch", "16", "--device", "cpu"]
    for net in ("ffdnet", "fastdvd", "ddnet"):
        out = _run(tmain, ["train", "--network", net, "--ckpt-dir", str(tmp_path / net)] + common)
        final = tmp_path / net / "final.pt"
        assert out.strip().endswith(f"trained {net} for 2 steps -> {final}") and final.exists()
        assert ttrainer.read_checkpoint(str(final))["step"] == 2
    resumed = _run(tmain, ["train", "--network", "fastdvd", "--ckpt-dir", str(tmp_path / "r"),
                           "--resume", str(tmp_path / "fastdvd" / "final.pt"),
                           "--steps", "3", "--batch", "2", "--patch", "16", "--device", "cpu"])
    assert "trained fastdvd for 3 steps" in resumed
    scene, res = str(tmp_path / "s.mat"), str(tmp_path / "r.mat")
    _run(tmain, ["synth", "--out", scene, "--size", "16", "--frames", "8", "--seed", "1"])
    out = _run(tmain, ["reconstruct", "--data", scene, "--denoiser", "fastdvd", "--name",
                       "Bosphorus", "--ckpt", str(tmp_path / "fastdvd" / "final.pt"),
                       "--out", res, "--device", "cpu"])
    assert re.search(r"PSNR \d+\.\d+ dB", out) and os.path.exists(res)
    for argv in (["train", "--network", "ffdnet", "--ckpt-dir", str(tmp_path / "x"),
                  "--resume", str(tmp_path)] + common,
                 ["denoise", "--network", "fastdvd", "--ckpt", str(tmp_path), "--device", "cpu"]):
        with pytest.raises(SystemExit, match="orbax"):
            tmain(argv)


_PSNR = re.compile(r"noisy (\S+) dB -> denoised (\S+) dB")


@pytest.fixture(scope="module")
def pth_weights(tmp_path_factory):
    """FFDNet colour and gray ``.pth`` files (KAIR layout) of seeded PyTorch
    initialisations."""
    root = tmp_path_factory.mktemp("pth")
    paths = {}
    for name, build in (("color", tffdnet_color), ("gray", tffdnet_gray)):
        torch.manual_seed(3)
        paths[name] = str(root / f"ffdnet_{name}.pth")
        torch.save(build().state_dict(), paths[name])
    return paths


@pytest.mark.parametrize("case", ["ffdnet", "ffdnet_gray", "fastdvd", "ddnet"])
def test_cli_denoise_matches_jax(tmp_path, pth_weights, case):
    net = case.split("_")[0]
    ckpt = {"ffdnet": pth_weights["color"], "ffdnet_gray": pth_weights["gray"],
            "fastdvd": str(WEIGHTS / "fastdvd.npz"), "ddnet": str(WEIGHTS / "ddnet.npz")}[case]
    argv = ["denoise", "--network", net, "--ckpt", ckpt, "--size", "32", "--seed", "2"]
    if case == "ffdnet_gray":
        argv.append("--gray")
    jo, to = str(tmp_path / "j.npy"), str(tmp_path / "t.npy")
    jtext = _run(jmain, argv + ["--out", jo])
    ttext = _run(tmain, argv + ["--out", to, "--device", "cpu"])
    (jin, jout), (tin, tout) = (map(float, _PSNR.search(t).groups()) for t in (jtext, ttext))
    a, b = np.load(to), np.load(jo)
    print(f"denoise {case}: {ttext.strip()} | JAX {jtext.strip()} | max |dx| "
          f"{np.abs(a - b).max():.2e}")
    assert abs(tin - jin) <= 0.01 and abs(tout - jout) <= 0.01
    assert a.shape == b.shape and np.abs(a - b).max() <= 1e-5
