"""The port's distillation chain and seam metric against the JAX scripts it
ports, on the CPU, each script loaded from its file with its module
attributes set on the loaded object (``SIZE``, ``STYLES``, ``SEEDS``,
``FFDNET_CKPT``):

* ``harvest_iterates`` at 64x64 on the leaves style, seeds 11 and 22, the
  teacher loop (the student skipped with ``'-'``): the saved crops within
  1e-5 of JAX's, the sigmas exact. The teacher is a Flax-initialised
  FFDNet-color written to a ``.pth``, which both packages read.
* ``distill_fastdvd`` and ``distill_iterates`` (``jac_weight`` 0 and 0.1,
  on the harvested pool) for 2 steps on that teacher, JAX's draws injected
  (``test_torch_train_tasks.Draws``), the clips cut from 64 to 16 px on both
  sides (the synthetic clips through ``synthetic_video_dataset``'s ``size``,
  the harvested crops sliced): the pool bit for bit, the losses
  within 1e-5 relative, the trained weights to Adam's opposite-sign bound.
  Both sides start the student from ``weights/fastdvd.npz``, which the JAX
  model's ``init`` returns, in place of the scripts' random initialisations
  (from a random start, Adam's first step parts the losses by ~1e-3:
  ``test_torch_weight_tools``).
* ``measure_tile_seams``' ``band_masks`` and ``masked_psnr``: equal to the
  script's.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptivepnp_sci_tpu.train as jtrain
from adaptivepnp_sci_torch import distill_fastdvd as tdf
from adaptivepnp_sci_torch import distill_iterates as tdi
from adaptivepnp_sci_torch import harvest_iterates as thi
from adaptivepnp_sci_torch import measure_tile_seams as tms
from adaptivepnp_sci_torch import regenerate_weights as trw
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.train import datasets as tdatasets
from adaptivepnp_sci_tpu.models.fastdvdnet import FastDVDnet as JFastDVDnet
from adaptivepnp_sci_tpu.models.ffdnet import ffdnet_color as jffdnet_color
from adaptivepnp_sci_tpu.train import datasets as jdatasets
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz
from tests.test_torch_train_tasks import Draws, push_jax_draws

#: the JAX package's Trainer (the tests replace the package's attribute)
JTrainer = jtrain.Trainer
ROOT = Path(__file__).resolve().parent.parent
HARVEST = dict(size=64, styles=("leaves",), seeds=(11, 22))
STEPS = 2
DISTILL_STYLES = ("smooth", "leaves")
#: the side of the training clips of the distillation runs: the scripts' 64,
#: cut on both sides through ``synthetic_video_dataset``'s ``size`` (and the
#: harvested pool's crops cut to it) to keep the CPU runs short
CLIP = 16


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Small tensors gain nothing from many threads, and the other test
    workers share the cores: two intra-op threads while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def load_script(name):
    """``scripts/{name}.py`` as a module object (the file is not edited)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """A Flax-initialised FFDNet-color as a reference-layout ``.pth``."""
    variables = jffdnet_color().init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)),
                                     jnp.float32(0.1))
    path = tmp_path_factory.mktemp("teacher") / "ffdnet_color.pth"
    torch.save(tconvert.ffdnet_from_flax(jax.tree_util.tree_map(np.asarray, variables)),
               str(path))
    return str(path)


@pytest.fixture(scope="module")
def harvests(teacher, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        jhi = load_script("harvest_iterates")
        mp.setattr(jhi, "SIZE", HARVEST["size"])
        mp.setattr(jhi, "STYLES", HARVEST["styles"])
        mp.setattr(jhi, "SEEDS", HARVEST["seeds"])
        mp.setattr(jhi, "FFDNET_CKPT", teacher)
        d = tmp_path_factory.mktemp("harvest")
        jhi.main(str(d / "jax.npz"), "-", cpu=False)
        thi.main(str(d / "torch.npz"), teacher, "-", device="cpu", **HARVEST)
        with np.load(d / "jax.npz") as j, np.load(d / "torch.npz") as t:
            yield {k: (j[k], t[k]) for k in j.files}, set(j.files) == set(t.files), d
    finally:
        mp.undo()


def test_harvest_matches_the_jax_script(harvests):
    arrays, same_keys, _ = harvests
    assert same_keys
    (jc, tc), (js, ts) = arrays["clips"], arrays["sigmas"]
    n = 2 * 32 * 4  # seeds x iterations x crops per iteration
    assert tc.shape == jc.shape == (n, 5, 64, 64, 3) and tc.dtype == np.float32
    np.testing.assert_array_equal(ts, js)
    dx = float(np.abs(tc - jc).max())
    print(f"harvest: crops max |d| {dx:.2e} (range {jc.min():.3f}..{jc.max():.3f})")
    assert dx <= 1e-5


class Recorder:
    """Records the JAX ``Trainer`` a script builds: its config, starting
    weights, losses and trained weights."""

    def __init__(self):
        rec = self.rec = {}

        class Trainer(JTrainer):
            def __init__(self, task, variables, config, *a, **kw):
                rec["config"], rec["start"] = config, variables
                super().__init__(task, variables, config, *a, **kw)

            def fit(self, batches, max_steps, **kw):
                def seen():
                    for b in batches:
                        rec.setdefault("batches", []).append(
                            jax.tree_util.tree_map(np.asarray, b))
                        yield b
                rec["losses"] = super().fit(seen(), max_steps, **kw)
                return rec["losses"]

            def save(self, path):
                rec["variables"] = jax.tree_util.tree_map(np.asarray, self.variables)

        self.trainer = Trainer


def _port_run(mp, rec, kind, opts, run):
    """The port's run with the JAX run's starting weights and draws."""
    mp.setattr(trw, "initial_variables", lambda net: tconvert.state_dict_from_flax(rec["start"]))
    draws = Draws(mp)
    key = jax.random.PRNGKey(rec["config"].seed)
    for b in rec["batches"]:
        key, sub = jax.random.split(key)
        shape = (b[0] if isinstance(b, tuple) else b).shape
        push_jax_draws(draws, kind, sub, shape, opts)
    trainer, losses = run()
    assert draws.empty()
    return trainer, losses


#: case -> (script, task kind, draw options, jac_weight)
CASES = {"distill_fastdvd": ("distill_fastdvd", "fastdvd", {"demosaic_aug": True}, None),
         "distill_iterates_jac0": ("distill_iterates", "fastdvd_distill", {}, 0.0),
         "distill_iterates_jac0.1": ("distill_iterates", "fastdvd_distill",
                                     {"jac_weight": 0.1}, 0.1)}


@pytest.fixture(scope="module")
def distills(teacher, harvests, tmp_path_factory):
    pool = str(harvests[2] / "jax_cut.npz")
    with np.load(harvests[2] / "jax.npz") as z:
        np.savez(pool, clips=z["clips"][:, :, :CLIP, :CLIP], sigmas=z["sigmas"])
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        scripts = {name: load_script(name) for name in ("distill_fastdvd", "distill_iterates")}
        # the scripts' random initialisation, run op by op (~17 s on the CPU
        # each), replaced by the shipped weights
        start = load_variables_npz(str(ROOT / "weights" / "fastdvd.npz"))
        mp.setattr(JFastDVDnet, "init", lambda self, *a, **kw: start)
        synths = {"jax": jdatasets.synthetic_video_dataset,
                  "torch": tdatasets.synthetic_video_dataset}
        for case, (script, kind, opts, jac) in CASES.items():
            r = Recorder()
            pools = {}

            def recorded(side):
                def synth(*a, **kw):
                    pools[side] = synths[side](*a, **dict(kw, size=CLIP))
                    return pools[side]
                return synth

            mp.setattr(jtrain, "Trainer", r.trainer)
            mp.setattr(jdatasets, "synthetic_video_dataset", recorded("jax"))
            mp.setattr(tdatasets, "synthetic_video_dataset", recorded("torch"))
            jmod = scripts[script]
            mp.setattr(jmod, "FFDNET_CKPT", teacher)
            jdir, tdir = (str(tmp_path_factory.mktemp(f"{side}-{case}")) for side in ("j", "t"))
            if script == "distill_fastdvd":
                jmod.main(steps=STEPS, n_clips=32, styles=DISTILL_STYLES, distill_weight=0.5,
                          out_dir=jdir)
                run = lambda: tdf.main(teacher, steps=STEPS, n_clips=32, styles=DISTILL_STYLES,
                                       distill_weight=0.5, out_dir=tdir, device="cpu")
            else:
                jmod.main(pool, steps=STEPS, jac_weight=jac, n_synth=32, out_dir=jdir)
                run = lambda: tdi.main(pool, teacher, steps=STEPS, jac_weight=jac, n_synth=32,
                                       out_dir=tdir, device="cpu")
            trainer, losses = _port_run(mp, r.rec, kind, opts, run)
            out[case] = (r.rec, trainer, losses, pools["jax"], pools["torch"])
        yield out
    finally:
        mp.undo()


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("case", list(CASES))
def test_distill_matches_the_jax_script(distills, case):
    rec, trainer, losses, want_pool, got_pool = distills[case]
    np.testing.assert_array_equal(got_pool, want_pool)
    assert trainer.step == STEPS and len(losses) == len(rec["losses"]) == STEPS
    jcfg, tcfg = rec["config"], trainer.config
    for field in ("lr", "steps_per_epoch", "milestones", "ckpt_every_epochs", "seed"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, rec["losses"]))
    mine = _flat(tconvert.flax_from_state_dict(trainer.variables)["params"])
    want = _flat(rec["variables"]["params"])
    assert mine.keys() == want.keys()
    d = np.concatenate([np.abs(mine[k] - want[k]).ravel() for k in want])
    lr = jcfg.lr
    print(f"{case}: losses {losses}, JAX {rec['losses']}, max rel {rel:.2e}; weights max |d| "
          f"{d.max():.2e}, {(d > 0.1 * lr).mean():.2e} beyond lr/10")
    assert rel <= 1e-5
    # Adam's opposite-sign bound: all but a thousandth within a tenth of lr,
    # every weight within 2 lr a step
    assert (d > 0.1 * lr).mean() <= 1e-3 and d.max() <= 2 * lr * STEPS


def test_seam_metrics_match_the_jax_script():
    keep = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                 "jax_persistent_cache_min_compile_time_secs")}
    try:
        jms = load_script("measure_tile_seams")
    finally:
        for k, v in keep.items():  # the script points JAX's compile cache at $HOME
            jax.config.update(k, v)
    for h, w, tile, band in ((1024, 1024, 512, 8), (96, 128, 32, 3), (64, 64, 64, 8),
                             (100, 60, 25, 4)):
        got, want = tms.band_masks(h, w, tile, band), jms.band_masks(h, w, tile, band)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    rng = np.random.default_rng(0)
    orig = rng.random((4, 96, 128), dtype=np.float32)
    rec = np.clip(orig + 0.05 * rng.standard_normal(orig.shape).astype(np.float32), 0, 1)
    seam = jms.band_masks(96, 128, 32, 3)
    for mask in (seam.astype(float), (~seam).astype(float), np.ones_like(seam, dtype=float)):
        assert tms.masked_psnr(orig, rec, mask) == jms.masked_psnr(orig, rec, mask)
    full, s, interior = tms.seam_psnrs(orig, rec, 32, 3)
    assert (full, s, interior) == (jms.masked_psnr(orig, rec, np.ones_like(seam, dtype=float)),
                                   jms.masked_psnr(orig, rec, seam.astype(float)),
                                   jms.masked_psnr(orig, rec, (~seam).astype(float)))
