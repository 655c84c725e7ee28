"""The port's training tasks vs the JAX package's, on the CPU: each task's
loss, its parameter gradients and the BatchNorm statistics its train-mode
forward leaves, from the same weights and batch, with the JAX loss's own
draws injected into the port (its draw functions replaced by JAX's
``randint`` / ``uniform`` / ``bernoulli`` / ``normal`` on the keys the JAX
``loss_fn`` splits, in its order).

Sizes: 16x16 patches, batch 2; FastDVDnet at its only width, with the
trained weights of ``weights/fastdvd.npz``. The JAX side runs under one
``jax.jit`` per case, on a FastDVDnet without recomputation (the same
function). The FFDNet and DDnet tasks, and the FastDVDnet penalties and
distillation task, which share these helpers, are held in
``tests/test_torch_train_parts.py`` and ``tests/test_torch_train_penalties.py``.

Bars: loss within 1e-5 relative; each parameter's gradient within 1e-4 of
that tensor's largest gradient entry; the mutated BatchNorm statistics within
1e-6 relative (the largest difference over the whole collection against its
largest entry).
"""

from collections import defaultdict, deque
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet as TFastDVDnet
from adaptivepnp_sci_torch.models.ffdnet import FFDNet as TFFDNet
from adaptivepnp_sci_torch.solvers.priors import module_copy
from adaptivepnp_sci_torch.train import augment as taugment
from adaptivepnp_sci_torch.train import tasks as ttasks
from adaptivepnp_sci_tpu.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_tpu.train import tasks
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz

WEIGHTS = Path(__file__).resolve().parent.parent / "weights"
LOSS_RTOL, GRAD_REL, STATS_REL = 1e-5, 1e-4, 1e-6
SIGMA_FDVD = (5 / 255, 55 / 255)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Small tensors gain nothing from many threads, and the other test
    workers share the cores: two intra-op threads while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def teacher_fn(lib):
    """A shape-preserving, sigma-aware teacher, written for both frameworks."""
    def teacher(noisy_center, sigma):
        return noisy_center * 0.5 + lib.reshape(sigma, (-1, 1, 1, 1))
    return teacher


class Draws:
    """Queues of JAX's draws, served to the port's draw functions in order."""

    def __init__(self, monkeypatch):
        self.q = defaultdict(deque)
        pop = self.pop
        monkeypatch.setattr(taugment, "draw_modes", lambda g, n: pop("modes"))
        monkeypatch.setattr(taugment, "random_sigma", lambda g, n, lo, hi: pop("sigma"))
        monkeypatch.setattr(taugment, "draw_noise", lambda g, shape: pop("noise"))
        monkeypatch.setattr(ttasks, "draw_fraction", lambda g, n: pop("frac"))
        monkeypatch.setattr(ttasks, "draw_coin", lambda g, n: pop("coin"))
        monkeypatch.setattr(ttasks, "draw_probe", lambda g, shape: pop("probe"))

    def pop(self, kind):
        return self.q[kind].popleft()

    def push(self, **kw):
        for kind, v in kw.items():
            self.q[kind].append(torch.from_numpy(np.array(v)))

    def empty(self):
        return not any(self.q.values())


def _modes(key, n):
    return np.asarray(jax.random.randint(key, (n,), 0, 8)).astype(np.int64)


def _frac(k_coin, k_u, n):
    return jnp.where(jax.random.bernoulli(k_coin, 0.5, (n,)), 1.0, jax.random.uniform(k_u, (n,)))


def push_jax_draws(draws, kind, key, shape, opts=None):
    """JAX's draws of one ``loss_fn(variables, key, batch)`` call of task
    ``kind`` on a batch of ``shape``, pushed in the port's order."""
    opts = opts or {}
    n = shape[0]
    rnd = jax.random
    if kind == "ffdnet":
        k1, k2, k3 = rnd.split(key, 3)
        lo, hi = opts.get("sigma_range", (0.0, 75 / 255))
        draws.push(modes=_modes(k1, n),
                   sigma=rnd.uniform(k2, (n,), minval=lo, maxval=hi),
                   noise=rnd.normal(k3, shape, jnp.float32))
    elif kind == "fastdvd":
        k1, k2, k3, k4 = rnd.split(key, 4)
        draws.push(modes=_modes(k1, n))
        if opts.get("demosaic_aug"):
            draws.push(coin=rnd.bernoulli(k4, 0.5, (n, 1, 1, 1, 1)).reshape(n))
        k5, k6, k6b = rnd.split(k2, 3)
        draws.push(sigma=rnd.uniform(k5, (n,), minval=SIGMA_FDVD[0], maxval=SIGMA_FDVD[1]),
                   frac=_frac(k6, k6b, n), noise=rnd.normal(k3, shape, jnp.float32))
        if opts.get("lipschitz_penalty", 0) > 0:
            k7, _ = rnd.split(rnd.fold_in(key, 7))
            draws.push(probe=rnd.normal(k7, shape, jnp.float32))
        if opts.get("spectral_penalty", 0) > 0:
            draws.push(probe=rnd.normal(rnd.fold_in(key, 9), shape, jnp.float32))
    elif kind == "fastdvd_distill":
        k1, k2, k3, k4, k5 = rnd.split(key, 5)
        draws.push(modes=_modes(k1, n), frac=_frac(k2, k5, n),
                   noise=rnd.normal(k3, shape))
        if opts.get("jac_weight", 0) > 0:
            draws.push(probe=rnd.normal(k4, shape))
    elif kind == "ddnet":
        k1, k3 = rnd.split(key)
        draws.push(modes=_modes(k1, n),
                   noise=rnd.normal(k3, shape, jnp.float32))
    else:
        raise ValueError(kind)


@pytest.fixture(scope="module")
def fdvd_vars():
    return load_variables_npz(str(WEIGHTS / "fastdvd.npz"))


def _clips(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def run_case(monkeypatch, kind, jtask, ttask, variables, batch, key, opts=None,
             grad_rel=GRAD_REL):
    """The JAX loss, gradients and mutated statistics against the port's;
    returns the readings."""
    frozen = {k: v for k, v in variables.items() if k != "params"}

    def loss_of(p):
        return jtask.loss_fn({"params": p, **frozen}, key, jax.tree_util.tree_map(
            jnp.asarray, batch))

    (jloss, jmut), jgrads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        variables["params"])

    draws = Draws(monkeypatch)
    shape = (batch[0] if isinstance(batch, tuple) else batch).shape
    push_jax_draws(draws, kind, key, shape, opts)
    net = module_copy(ttask.model, tconvert.state_dict_from_flax(variables), "cpu").train()
    tbatch = (tuple(torch.from_numpy(np.asarray(b)) for b in batch) if isinstance(batch, tuple)
              else torch.from_numpy(batch))
    loss = ttask.loss_fn(net, torch.Generator(), tbatch)
    loss.backward()
    assert draws.empty()

    readings = {"loss": loss.item(),
                "loss_rel": abs(loss.item() - float(jloss)) / abs(float(jloss))}
    grads = tconvert.flax_from_state_dict(
        {k: p.grad for k, p in net.named_parameters()})["params"]
    worst = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        want = np.asarray(want)
        got = _leaf(grads, path)
        scale = np.abs(want).max()
        assert scale > 0, jax.tree_util.keystr(path)
        worst = max(worst, float(np.abs(got - want).max() / scale))
    readings["grad_rel"] = worst
    if "batch_stats" in jmut:
        stats = tconvert.flax_from_state_dict(net.state_dict())["batch_stats"]
        pairs = [(_leaf(stats, path), np.asarray(want))
                 for path, want in jax.tree_util.tree_leaves_with_path(jmut["batch_stats"])]
        got = np.concatenate([a.ravel() for a, _ in pairs])
        want = np.concatenate([b.ravel() for _, b in pairs])
        before = np.concatenate([np.asarray(b).ravel() for b in
                                 jax.tree_util.tree_leaves(variables["batch_stats"])])
        assert np.abs(want - before).max() > 0  # the statistics moved
        readings["stats_rel"] = float(np.abs(got - want).max() / np.abs(want).max())
    print(kind, opts, readings)
    assert readings["loss_rel"] <= LOSS_RTOL, readings
    assert readings["grad_rel"] <= grad_rel, readings
    assert readings.get("stats_rel", 0.0) <= STATS_REL, readings
    return readings


FASTDVD_CASES = {
    "plain": {},
    "demosaic_aug": {"demosaic_aug": True},
    "teacher": {"teacher": True, "distill_weight": 0.5},
}


def fastdvd_case(monkeypatch, fdvd_vars, opts):
    """One FastDVDnet task with the options ``opts`` (``teacher``: the
    two-framework teacher of :func:`teacher_fn`; ``output_gain``: ``temp2``'s
    last conv scaled in both packages) against JAX; returns the readings and
    the weights used."""
    kw = dict(opts)
    gain = kw.pop("output_gain", None)
    if gain is not None:
        fdvd_vars = jax.tree_util.tree_map(np.asarray, fdvd_vars)
        conv = fdvd_vars["params"]["temp2"]["outc"]["conv1"]
        fdvd_vars["params"]["temp2"]["outc"]["conv1"] = dict(conv, kernel=conv["kernel"] * gain)
    if kw.pop("teacher", False):
        jkw, tkw = dict(kw, teacher=teacher_fn(jnp)), dict(kw, teacher=teacher_fn(torch))
    else:
        jkw = tkw = kw
    clips = _clips(2, (2, 5, 16, 16, 3))
    got = run_case(monkeypatch, "fastdvd", tasks.fastdvd_task(FastDVDnet(remat=False), **jkw),
                   ttasks.fastdvd_task(TFastDVDnet(), **tkw), fdvd_vars, clips,
                   jax.random.PRNGKey(5), opts,
                   grad_rel=2e-4 if "lipschitz_penalty" in opts else GRAD_REL)
    return got, fdvd_vars, clips


@pytest.mark.parametrize("case", list(FASTDVD_CASES))
def test_fastdvd_task_matches_jax(monkeypatch, fdvd_vars, case):
    """FastDVDnet plain, with the Malvar input augmentation, and with a
    teacher blended in at 0.5 (the penalties and the distillation task:
    ``tests/test_torch_train_penalties.py``)."""
    fastdvd_case(monkeypatch, fdvd_vars, FASTDVD_CASES[case])


def test_remat_forward_moves_the_statistics_once(fdvd_vars):
    """With recomputation (the default), a train-mode step moves the running
    statistics once: the recomputation in the backward pass leaves them."""
    clips = torch.from_numpy(_clips(9, (2, 5, 16, 16, 3)))
    after = []
    for remat in (True, False):
        net = module_copy(TFastDVDnet(remat=remat), tconvert.state_dict_from_flax(fdvd_vars),
                          "cpu").train()
        net(clips, torch.tensor([0.1, 0.2])).sum().backward()
        after.append(net.state_dict())
    for k, v in after[0].items():
        assert torch.equal(v, after[1][k]), k


def test_draws_come_from_the_generator():
    """Unpatched, each draw comes from the generator it is given: the
    fraction is 1 for about half the samples, uniform below 1 for the rest;
    the same seed gives the same loss, another seed another."""
    frac = ttasks.draw_fraction(torch.Generator().manual_seed(0), 1000)
    assert ((frac == 1).float().mean() - 0.5).abs() < 0.06 and bool((frac <= 1).all())
    net = module_copy(TFFDNet(nc=8, nb=3), None, "cpu").train()
    task = ttasks.ffdnet_task(TFFDNet(nc=8, nb=3))
    clean = torch.from_numpy(_clips(10, (2, 16, 16, 3)))
    with torch.no_grad():
        losses = [task.loss_fn(net, torch.Generator().manual_seed(s), clean).item()
                  for s in (0, 0, 1)]
    assert losses[0] == losses[1] != losses[2]
