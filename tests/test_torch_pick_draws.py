"""How often a pick of the port's guard and selections differs from JAX's
under each package's own draws, on the CPU at 64x64x8 over 8 scenes (not a
tier-1 test: ``-m slow``, ~7 min; run with ``-s`` to see the counts).

For each scene (seeds 100-107, the styles in turn, each under a scene
name's table row):

* the held-out guard: the FastDVDnet row (sigma (12, 6)/255 x (24, 12),
  two triggers of lr 2e-7, ``select_best_holdout=0.05``, float32
  FastDVDnet without recomputation, ``weights/fastdvd.npz``) from the
  GAP-TV warm start; the pick is the candidate the guard returned;
* ``select_prior_variables`` between ``weights/fastdvd.npz`` and
  ``weights/fastdvd_smooth.npz`` on the scene's FastDVDnet row;
* ``select_demosaicker`` (Malvar or DDnet, ``weights/ddnet.npz``) with the
  FastDVDnet prior on the scene's two FastDVDnet rows;

the two selections with every stage of their rows cut to 6 iterations
(float32 DDnet on the CPU takes minutes a scene at the full rows).

Each package runs with its own draws (the held-out mask, FastDVDnet's
adaptation noise), and the port once more with JAX's mask and the noise off
on both sides. The port with JAX's draws must make every one of JAX's
picks; the count of picks that differ under the port's own draws is the
measurement, printed and not held to a bar.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from adaptivepnp_sci_torch import pipelines as tpipe
from adaptivepnp_sci_torch.adapt.online import AdaptConfig as TAdaptConfig
from adaptivepnp_sci_torch.configs.scenes import SCENE_NAMES
from adaptivepnp_sci_torch.configs.scenes import admm_config_for as tconfig_for
from adaptivepnp_sci_torch.data.mat_io import SceneData as TSceneData
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.ddnet import DDnet as TDDnet
from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet as TFastDVDnet
from adaptivepnp_sci_torch.solvers import priors as tpriors
from adaptivepnp_sci_torch.solvers import two_stage_admm as tadmm
from adaptivepnp_sci_tpu import pipelines as jpipe
from adaptivepnp_sci_tpu.adapt.online import AdaptConfig
from adaptivepnp_sci_tpu.configs.scenes import admm_config_for as jconfig_for
from adaptivepnp_sci_tpu.data.mat_io import SceneData
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models.ddnet import DDnet
from adaptivepnp_sci_tpu.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_tpu.solvers import ADMMConfig, GapTVConfig, gap_tv
from adaptivepnp_sci_tpu.solvers.priors import fastdvd_prior
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz
from test_torch_solver_modes import jax_mask, jax_pick
from test_torch_weight_tools import ROOT

pytestmark = pytest.mark.slow

SEEDS = tuple(range(100, 108))
STYLES = ("textured", "leaves", "photo", "smooth")
GUARD = dict(sigma=(12 / 255, 6 / 255), iters=(24, 12), denoiser="fastdvd", select_best=True,
             select_best_holdout=0.05)
ADAPT = dict(lr=2e-7, update_per_iter=2, interval_iter=12, initial_iter=1)
#: the selections' rows, each stage cut to this many iterations
CUT = 6


@pytest.fixture(scope="module")
def nets():
    nat = load_variables_npz(str(ROOT / "weights" / "fastdvd.npz"))
    smooth = load_variables_npz(str(ROOT / "weights" / "fastdvd_smooth.npz"))
    dd = load_variables_npz(str(ROOT / "weights" / "ddnet.npz"))
    return nat, smooth, dd


def scenes():
    for i, seed in enumerate(SEEDS):
        sc = make_scene(b=8, h=64, w=64, seed=seed, style=STYLES[i % len(STYLES)])
        kw = dict(name=SCENE_NAMES[i % len(SCENE_NAMES)], meas=sc.meas[None], mask=sc.mask,
                  orig_bayer=sc.orig_bayer[None], orig_real=sc.orig_rgb[None] * 255.0)
        yield sc, SceneData(**kw), TSceneData(**kw)


def rows(name, config_for):
    """The scene's fixed-weight FastDVDnet rows (Malvar, DDnet), cut."""
    return [dataclasses.replace(c, iters=tuple(min(n, CUT) for n in c.iters))
            for c in (config_for(name, "fastdvd", deep, False) for deep in (False, True))]


def port_pick(res) -> int:
    """The candidate the port's guard returned (0 = the warm start)."""
    return int(np.argmin(res.resid_trace.numpy()))


def report(what, own, injected):
    print(f"\n{what}: {len(own)} scenes; picks differing from JAX's with the port's own "
          f"draws: {sum(own)}; with JAX's draws: {sum(injected)}")
    assert sum(injected) == 0


def test_guard_picks(nets, monkeypatch):
    nat, _, _ = nets
    params = tconvert.fastdvdnet_from_flax(nat)
    jprior = fastdvd_prior(FastDVDnet(remat=False))
    tprior = tpriors.fastdvd_prior(TFastDVDnet(remat=False))
    own, injected = [], []
    for sc, _, _ in scenes():
        y, phi, orig = jnp.asarray(sc.meas), jnp.asarray(sc.mask), jnp.asarray(sc.orig_bayer)
        x0 = np.asarray(gap_tv(y, phi, GapTVConfig(iters=40)).x_bayer)
        jcfg = ADMMConfig(**GUARD, adapt=AdaptConfig(**ADAPT))
        tcfg = tadmm.ADMMConfig(**GUARD, adapt=TAdaptConfig(**ADAPT))
        picks = []
        for prior_j, prior_t, mask in ((jprior, tprior, None),
                                       (jprior._replace(adapt_noise_std=0.0),
                                        tprior._replace(adapt_noise_std=0.0), jax_mask)):
            ref = tadmm_jax(y, phi, jcfg, prior_j, nat, x0, orig)
            with monkeypatch.context() as m:
                if mask is not None:
                    m.setattr(tadmm, "holdout_mask", mask)
                got = tadmm.two_stage_admm(sc.meas, sc.mask, tcfg, prior_t, params, x0,
                                           sc.orig_bayer, "cpu")
            picks.append((port_pick(got), jax_pick(ref, sc, x0)))
        print(f"seed picks (port, JAX): own {picks[0]}, JAX's draws {picks[1]}")
        own.append(picks[0][0] != picks[0][1])
        injected.append(picks[1][0] != picks[1][1])
    report("held-out guard", own, injected)


def tadmm_jax(y, phi, cfg, prior, variables, x0, orig):
    from adaptivepnp_sci_tpu.solvers.two_stage_admm import two_stage_admm

    return two_stage_admm(y, phi, cfg, prior, variables, jnp.asarray(x0), orig_bayer=orig)


def test_selection_picks(nets, monkeypatch):
    nat, smooth, dd = nets
    jprior = fastdvd_prior(FastDVDnet(remat=False))
    tprior = tpriors.fastdvd_prior(TFastDVDnet(remat=False))
    tvars = {"natural": tconvert.fastdvdnet_from_flax(nat),
             "smooth": tconvert.fastdvdnet_from_flax(smooth)}
    tdd = tconvert.ddnet_from_flax(dd)
    counts = {"select_prior_variables": ([], []), "select_demosaicker": ([], [])}
    for _, jsc, tsc in scenes():
        (jm, jd), (tm, td) = rows(jsc.name, jconfig_for), rows(tsc.name, tconfig_for)
        want_w = jpipe.select_prior_variables(jsc, jprior, {"natural": nat, "smooth": smooth},
                                              config=jm)
        want_d = jpipe.select_demosaicker(jsc, jprior, nat, DDnet(), dd, config_malvar=jm,
                                          config_ddnet=jd)
        for injected in (False, True):
            with monkeypatch.context() as m:
                if injected:
                    m.setattr(tadmm, "holdout_mask", jax_mask)
                got_w = tpipe.select_prior_variables(tsc, tprior, tvars, config=tm,
                                                     device="cpu")
                got_d = tpipe.select_demosaicker(tsc, tprior, tvars["natural"], TDDnet(), tdd,
                                                 config_malvar=tm, config_ddnet=td,
                                                 device="cpu")
            counts["select_prior_variables"][injected].append(got_w != want_w)
            counts["select_demosaicker"][injected].append(got_d != want_d)
        print(f"{tsc.name}: JAX {want_w}, {want_d}")
    for what, (own, inj) in counts.items():
        report(what, own, inj)
