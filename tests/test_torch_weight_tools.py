"""The port's weight tooling against the JAX scripts it ports, on the CPU:
``adaptivepnp_sci_torch.eval_weights`` against ``scripts/eval_weights.py``
and ``adaptivepnp_sci_torch.regenerate_weights`` against
``scripts/regenerate_weights.py``, each script loaded from its file.

* ``sigma_max_eval`` on two 16x16 clips with the same start ``u`` (JAX's
  draw injected through ``eval_weights.draw_normal``): within 1e-5
  relative.
* ``eval_weights``' three numbers for ``weights/fastdvd.npz`` at 32x32
  against the JAX ``main``'s, taken where the script computes them (its
  ``sigma_max_eval`` given the model's ``apply`` under ``jax.jit``, and its
  prior's ``apply`` jitted, which give the same numbers faster) and as
  printed: the
  standalone and in-loop PSNR within 1e-4 dB, sigma_max within 1e-5
  relative, each printed number JAX's or one unit of its last digit from it
  (a value near a rounding boundary may round to the neighbour). JAX's
  noise draw is injected; FastDVDnet's adaptation noise is off on both
  sides (each package draws it from its own generator).
* ``regenerate_weights`` for each network at 32 clips of 16x16 and 3
  steps: the pool bit for bit, the ``TrainerConfig``, and the losses within
  1e-5 relative, JAX's draws injected (``test_torch_train_tasks.Draws``);
  the trained weights to Adam's opposite-sign bound. Both sides start from
  the shipped ``weights/{network}.npz``, which the JAX model's ``init``
  returns, in place of the scripts' random initialisations: from a random
  start, Adam's first step at lr 1e-3 moves every weight by about lr
  whatever its gradient's size, and the weights
  whose near-zero gradient the two summation orders give opposite signs
  part the losses by 1.2e-3 at the second step (a 2e-6 first step).
* The written ``final.npz`` read by the JAX package's ``load_variables_npz``
  equal to the trained weights, and by the port back to the same state
  dict; ``final.pt`` holds the same weights.
"""

import contextlib
import importlib
import importlib.util
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch import eval_weights as tew
from adaptivepnp_sci_torch import regenerate_weights as trw
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet as TFastDVDnet
from adaptivepnp_sci_torch.solvers import priors as tpriors
from adaptivepnp_sci_torch.train import trainer as ttrainer
from adaptivepnp_sci_tpu.models.ddnet import DDnet as JDDnet
from adaptivepnp_sci_tpu.models.fastdvdnet import FastDVDnet as JFastDVDnet
from adaptivepnp_sci_tpu.ops import metrics as jmetrics
from adaptivepnp_sci_tpu.solvers import priors as jpriors
from adaptivepnp_sci_tpu.train import trainer as jtrainer
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz
from tests.test_torch_train_tasks import Draws, push_jax_draws

#: the module (the package's ``two_stage_admm`` is the function)
jadmm = importlib.import_module("adaptivepnp_sci_tpu.solvers.two_stage_admm")
ROOT = Path(__file__).resolve().parent.parent
CKPTS = [str(ROOT / "weights" / "fastdvd.npz")]
#: the regenerated pool: 32 crops of 16x16 (one batch), 3 steps
REGEN = dict(steps=3, n_clips=32, clip_size=16)
JMODELS = {"fastdvd": JFastDVDnet, "ddnet": JDDnet}


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


def jax_normal(generator, shape):
    """JAX's ``random.normal(PRNGKey(0), shape)``: the script's one key."""
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0), shape,
                                                         jnp.float32)))


class Jitted:
    """A Flax module's ``apply`` under ``jax.jit``: the script's
    ``sigma_max_eval`` differentiates it as it is, compiled (the same
    numbers, a third of the time of op-by-op dispatch)."""

    def __init__(self, model):
        self.apply = jax.jit(model.apply)


def _no_adapt_noise(build, jit=False):
    """``build``'s prior with the adaptation noise off; with ``jit``, JAX's
    ``apply`` under ``jax.jit`` (the script calls it op by op for the
    standalone number: the same values, a fifth of the time)."""
    def wrapped(*a, **kw):
        prior = build(*a, **kw)._replace(adapt_noise_std=0.0)
        return prior._replace(apply=jax.jit(prior.apply)) if jit else prior
    return wrapped


def test_sigma_max_matches_jax(monkeypatch):
    variables = load_variables_npz(CKPTS[0])
    clips = np.random.default_rng(5).random((2, 5, 16, 16, 3), dtype=np.float32)
    want = load_script("eval_weights").sigma_max_eval(
        Jitted(JFastDVDnet()), variables, jnp.asarray(clips), jax.random.PRNGKey(0))
    monkeypatch.setattr(tew, "draw_normal", jax_normal)
    got = tew.sigma_max_eval(TFastDVDnet(), tconvert.state_dict_from_flax(variables),
                             torch.from_numpy(clips), torch.Generator().manual_seed(0))
    print(f"sigma_max: port {got:.7f}, JAX {want:.7f}")
    assert abs(got - want) <= 1e-5 * want


_LINE = re.compile(r"^(\S+): standalone=([\d.]+) dB  in-loop@32/smooth=([\d.]+) dB  "
                   r"sigma_max=([\d.]+)$")


def _printed(text):
    return [tuple(float(v) for v in m.groups()[1:]) for m in map(_LINE.match, text.splitlines())
            if m]


@pytest.fixture(scope="module")
def eval_runs():
    """Both ``main``s on the shipped weights at 32x32: the port's
    rows and lines, JAX's numbers where the script computes them and its
    lines."""
    mp = pytest.MonkeyPatch()
    try:
        jew = load_script("eval_weights")
        got = {"psnr": [], "inloop": [], "smax": []}

        def psnr(*a, **kw):
            out = jpsnr(*a, **kw)
            if not isinstance(out, jax.core.Tracer):  # the script's, not the solver's
                got["psnr"].append(float(out))
            return out

        def admm(*a, **kw):
            r = jtwo(*a, **kw)
            got["inloop"].append(float(r.psnr_per_frame.mean()))
            return r

        def smax(model, *a, **kw):
            got["smax"].append(jsmax(Jitted(model), *a, **kw))
            return got["smax"][-1]

        jpsnr, jtwo, jsmax = jmetrics.psnr, jadmm.two_stage_admm, jew.sigma_max_eval
        mp.setattr(jmetrics, "psnr", psnr)
        mp.setattr(jadmm, "two_stage_admm", admm)
        mp.setattr(jew, "sigma_max_eval", smax)
        mp.setattr(jpriors, "fastdvd_prior", _no_adapt_noise(jpriors.fastdvd_prior, jit=True))
        mp.setattr("sys.argv", ["eval_weights.py", *CKPTS, "--size", "32", "--tpu"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jew.main()
        jlines = buf.getvalue()

        mp.setattr(tpriors, "fastdvd_prior", _no_adapt_noise(tpriors.fastdvd_prior))
        mp.setattr(tew, "draw_normal", jax_normal)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows = tew.main(CKPTS, size=32, device="cpu")
        yield rows, buf.getvalue(), list(zip(got["psnr"], got["inloop"], got["smax"])), jlines
    finally:
        mp.undo()


def test_eval_weights_matches_the_jax_script(eval_runs):
    rows, lines, jnums, jlines = eval_runs
    assert [r[0] for r in rows] == CKPTS and len(jnums) == len(CKPTS)
    assert len(_printed(lines)) == len(_printed(jlines)) == len(CKPTS)
    for (path, *mine), want, printed, jprinted in zip(rows, jnums, _printed(lines),
                                                      _printed(jlines)):
        d = [abs(mine[0] - want[0]), abs(mine[1] - want[1]), abs(mine[2] - want[2]) / want[2]]
        print(f"{Path(path).name}: standalone {mine[0]:.4f} dB (d {d[0]:.1e}), in-loop "
              f"{mine[1]:.4f} dB (d {d[1]:.1e}), sigma_max {mine[2]:.5f} (rel {d[2]:.1e})")
        assert d[0] <= 1e-4 and d[1] <= 1e-4 and d[2] <= 1e-5
        for p, j, unit in zip(printed, jprinted, (0.01, 0.01, 0.001)):
            assert abs(p - j) <= 1.001 * unit


# ------------------------------------------------------------ regenerate


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def regen_runs(tmp_path_factory):
    """``regenerate_weights`` of each network from both scripts."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        jrw = load_script("regenerate_weights")
        jsynth = jrw.synthetic_video_dataset
        for network in ("fastdvd", "ddnet"):
            rec = {"batches": []}

            class Recorder(jtrainer.Trainer):
                def __init__(self, task, variables, config, *a, **kw):
                    rec["config"], rec["start"] = config, variables
                    super().__init__(task, variables, config, *a, **kw)

                def fit(self, batches, max_steps, **kw):
                    def seen():
                        for b in batches:
                            rec["batches"].append(np.asarray(b))
                            yield b
                    rec["losses"] = super().fit(seen(), max_steps, **kw)
                    return rec["losses"]

                def save(self, path):
                    rec["saved"] = path
                    rec["variables"] = jax.tree_util.tree_map(np.asarray, self.variables)

            def pool(*a, **kw):
                rec["pool"] = jsynth(*a, **kw)
                return rec["pool"]

            # the script's random initialisation, run op by op (~17 s on the
            # CPU), replaced by the shipped weights
            start = load_variables_npz(str(ROOT / "weights" / f"{network}.npz"))
            mp.setattr(JMODELS[network], "init", lambda self, *a, start=start, **kw: start)
            mp.setattr(jrw, "Trainer", Recorder)
            mp.setattr(jrw, "synthetic_video_dataset", pool)
            jdir = str(tmp_path_factory.mktemp(f"jax-{network}"))
            jrw.main(network, REGEN["steps"], out_dir=jdir, n_clips=REGEN["n_clips"],
                     clip_size=REGEN["clip_size"], styles=("smooth", "leaves"))

            # the port: JAX's starting weights and draws
            mp.setattr(trw, "initial_variables",
                       lambda net: tconvert.state_dict_from_flax(rec["start"]))
            draws = Draws(mp)
            key = jax.random.PRNGKey(rec["config"].seed)
            for b in rec["batches"]:
                key, sub = jax.random.split(key)
                push_jax_draws(draws, network, sub, b.shape, {"demosaic_aug": True})
            tdir = tmp_path_factory.mktemp(f"torch-{network}")
            trainer, losses = trw.main(network, REGEN["steps"], out_dir=str(tdir),
                                       n_clips=REGEN["n_clips"], clip_size=REGEN["clip_size"],
                                       styles=("smooth", "leaves"), device="cpu")
            assert draws.empty()
            pool_t = trw.make_pool(REGEN["n_clips"], clip_size=REGEN["clip_size"],
                                   styles=("smooth", "leaves"))
            out[network] = (rec, trainer, losses, tdir, pool_t)
        yield out
    finally:
        mp.undo()


@pytest.mark.parametrize("network", ["fastdvd", "ddnet"])
def test_regenerate_matches_the_jax_script(regen_runs, network):
    rec, trainer, losses, _, pool = regen_runs[network]
    np.testing.assert_array_equal(pool, rec["pool"])
    assert pool.shape == (REGEN["n_clips"], 5, REGEN["clip_size"], REGEN["clip_size"], 3)
    jcfg, tcfg = rec["config"], trainer.config
    for field in ("lr", "steps_per_epoch", "milestones", "ckpt_every_epochs", "seed",
                  "orthogonalize_every"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert tuple(tcfg.milestones) == (2, 2) and tcfg.steps_per_epoch == 1
    assert trainer.step == REGEN["steps"] and len(losses) == len(rec["losses"]) == 3
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, rec["losses"]))
    print(f"{network}: losses {losses}, JAX {rec['losses']}, max rel {rel:.2e}")
    assert rel <= 1e-5
    # the trained weights against JAX's, to Adam's opposite-sign bound: a
    # weight whose gradient is near zero can step +lr on one side and -lr on
    # the other, so all but a thousandth within a tenth of lr, every one
    # within 2 lr a step
    mine = _flat(tconvert.flax_from_state_dict(trainer.variables)["params"])
    want = _flat(rec["variables"]["params"])
    assert mine.keys() == want.keys()
    d = np.concatenate([np.abs(mine[k] - want[k]).ravel() for k in want])
    lr = jcfg.lr
    print(f"{network}: weights max |d| {d.max():.2e}, {(d > 0.1 * lr).mean():.2e} beyond lr/10")
    assert (d > 0.1 * lr).mean() <= 1e-3 and d.max() <= 2 * lr * REGEN["steps"]


@pytest.mark.parametrize("network", ["fastdvd", "ddnet"])
def test_regenerated_files_round_trip(regen_runs, network):
    _, trainer, _, tdir, _ = regen_runs[network]
    trained = {k: v for k, v in trainer.variables.items() if not k.endswith("num_batches_tracked")}
    jvars = load_variables_npz(str(tdir / "final.npz"))
    want = _flat(tconvert.flax_from_state_dict(trained))
    got = _flat(jvars)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back = ttrainer.load_checkpoint_variables(str(tdir / "final.npz"))
    pt = ttrainer.load_checkpoint_variables(str(tdir / "final.pt"))
    for k, v in trained.items():
        assert torch.equal(back[k], v) and torch.equal(pt[k], v), k
