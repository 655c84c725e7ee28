"""Port FFDNet, the Flax -> PyTorch weight bridge and online adaptation vs
the JAX package, on the same numpy weights and inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.adapt import online as tonline
from adaptivepnp_sci_torch.models import common as tcommon
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.ffdnet import FFDNet as TFFDNet
from adaptivepnp_sci_torch.solvers.priors import ffdnet_prior as tffdnet_prior
from adaptivepnp_sci_torch.solvers.priors import working_copy
from adaptivepnp_sci_tpu.adapt import online
from adaptivepnp_sci_tpu.models import common
from adaptivepnp_sci_tpu.models.ffdnet import FFDNet
from adaptivepnp_sci_tpu.ops import bayer
from adaptivepnp_sci_tpu.solvers.priors import ffdnet_prior


def flax_ffdnet(nc=8, nb=4, hw=(16, 16), seed=0):
    """Flax FFDNet and its variables as numpy arrays."""
    model = FFDNet(in_nc=3, out_nc=3, nc=nc, nb=nb)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 3)),
                           jnp.float32(0.1))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def torch_ffdnet(variables, nc=8, nb=4):
    net = TFFDNet(in_nc=3, out_nc=3, nc=nc, nb=nb)
    net.load_state_dict(tconvert.ffdnet_from_flax(variables))
    return net.eval()


def test_space_depth_match_jax(rng):
    x = rng.random((2, 6, 8, 3), dtype=np.float32)
    got = tcommon.space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = common.space_to_depth(jnp.asarray(x))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1), want)
    back = tcommon.depth_to_space(got).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(back, common.depth_to_space(want))
    odd = rng.random((1, 5, 7, 3), dtype=np.float32)
    padded, ph, pw = tcommon.replication_pad_to_even(torch.from_numpy(odd).permute(0, 3, 1, 2))
    want_p, wph, wpw = common.replication_pad_to_even(jnp.asarray(odd))
    assert (ph, pw) == (wph, wpw) == (1, 1)
    np.testing.assert_array_equal(padded.permute(0, 2, 3, 1), want_p)


@pytest.mark.parametrize("sigma", [0.1, (0.05, 0.2)])
def test_ffdnet_through_bridge_matches_flax(rng, sigma):
    """Odd size 17x19 (replication pad + crop), scalar and per-sample sigma."""
    model, variables = flax_ffdnet(hw=(17, 19))
    net = torch_ffdnet(variables)
    x = rng.random((2, 17, 19, 3), dtype=np.float32)
    s = np.asarray(sigma, np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(s))
    want = model.apply(variables, jnp.asarray(x), jnp.asarray(s))
    assert got.shape == (2, 17, 19, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_bridge_round_trip():
    _, variables = flax_ffdnet()
    back = tconvert.ffdnet_to_flax(tconvert.ffdnet_from_flax(variables))
    flat_a = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(flat_a) == len(flat_b) == 8
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_load_ffdnet_reads_kair_state_dict(tmp_path):
    """A KAIR ``.pth`` state dict (``module.`` prefix from DataParallel)
    loads into the port's FFDNet as it is."""
    _, variables = flax_ffdnet()
    sd = tconvert.ffdnet_from_flax(variables)
    path = tmp_path / "ffdnet.pth"
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    net = TFFDNet(nc=8, nb=4)
    net.load_state_dict(tconvert.load_ffdnet(str(path)))
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v, sd[k])


def _adapt_inputs(rng, b=2, h=8, w=12):
    rgb = rng.random((b, h, w, 3), dtype=np.float32)
    phi = (rng.random((b, h, w)) > 0.5).astype(np.float32)
    y = (rng.random((b, h, w), dtype=np.float32) * phi).sum(0)
    return rgb, phi, y


def test_packed4_loss_gradient_matches_jax(rng):
    model, variables = flax_ffdnet()
    rgb, phi, y = _adapt_inputs(rng)
    sigma = np.float32(25 / 255)
    jprior = ffdnet_prior(model)
    y_p, phi_p = bayer.pack(jnp.asarray(y)), bayer.pack(jnp.asarray(phi))
    loss = online.measurement_loss_fn(jprior, jnp.asarray(rgb), sigma, y_p, phi_p,
                                      jnp.asarray(y), jnp.asarray(phi))
    jgrads = jax.grad(loss)(variables)["params"]
    jval = loss(variables)

    net = torch_ffdnet(variables)
    tprior = tffdnet_prior(net)
    tloss = tonline.measurement_loss_fn(
        tprior, net, torch.from_numpy(rgb), torch.tensor(sigma),
        torch.from_numpy(np.array(y_p)), torch.from_numpy(np.array(phi_p)),
        torch.from_numpy(y), torch.from_numpy(phi))
    val = tloss()
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    grads = tconvert.ffdnet_to_flax(
        {k: p.grad for k, p in net.named_parameters()})["params"]
    for name, g in jgrads.items():
        for leaf in ("kernel", "bias"):
            want = np.asarray(g[leaf])
            scale = np.abs(want).max()
            np.testing.assert_allclose(grads[name][leaf], want, rtol=0, atol=1e-4 * scale)


def test_adapt_trigger_matches_jax(rng):
    """One trigger of the flagship's AdaptConfig: two Adam steps with a fresh
    Adam, lr 2e-6. A fresh Adam's first step is about lr * sign(g), so a
    weight whose gradient is near Adam's eps (1e-8), where the two
    frameworks' float32 gradients and roundings differ, can move by a
    different amount: at most 2 steps * lr = 4e-6 apart. Everywhere else the
    two updates agree to 1% of lr."""
    model, variables = flax_ffdnet()
    rgb, phi, y = _adapt_inputs(rng)
    sigma = np.float32(25 / 255)
    cfg = online.AdaptConfig(lr=2e-6, update_per_iter=2, interval_iter=15, initial_iter=1)
    jprior = ffdnet_prior(model)
    opt = online.default_adam(online.first_lr(cfg))
    jadapt = online.make_adapt_fn(jprior, opt, cfg)
    y_p, phi_p = bayer.pack(jnp.asarray(y)), bayer.pack(jnp.asarray(phi))
    jvars, _, _ = jadapt(variables, opt.init(variables["params"]), jax.random.PRNGKey(0),
                         jnp.asarray(rgb), sigma, y_p, phi_p, jnp.asarray(y),
                         jnp.asarray(phi))

    net = torch_ffdnet(variables)
    tcfg = tonline.AdaptConfig(lr=2e-6, update_per_iter=2, interval_iter=15, initial_iter=1)
    tonline.make_adapt_fn(tffdnet_prior(net), tcfg)(
        net, torch.from_numpy(rgb), torch.tensor(sigma),
        torch.from_numpy(np.array(y_p)), torch.from_numpy(np.array(phi_p)),
        torch.from_numpy(y), torch.from_numpy(phi))
    got = tconvert.ffdnet_to_flax(net.state_dict())["params"]
    n_far = n_all = 0
    for name, p in jvars["params"].items():
        for leaf in ("kernel", "bias"):
            before = variables["params"][name][leaf]
            d_jax = np.asarray(p[leaf]) - before
            d_torch = got[name][leaf] - before
            assert np.abs(d_jax).max() > 1e-6  # the trigger moved the weights
            diff = np.abs(d_torch - d_jax)
            assert diff.max() <= 2 * 2e-6 + 1e-7
            n_far += int((diff > 0.01 * 2e-6).sum())
            n_all += diff.size
    assert n_far <= 0.01 * n_all, (n_far, n_all)


def test_adaptation_leaves_callers_module_unchanged(rng):
    """The adaptation steps a private copy: the template module and the
    caller's state dict keep their values; the adapted weights come back."""
    _, variables = flax_ffdnet()
    template = torch_ffdnet(variables)
    params = tconvert.ffdnet_from_flax(variables)
    before = {k: v.clone() for k, v in template.state_dict().items()}
    params_before = {k: v.clone() for k, v in params.items()}
    prior = tffdnet_prior(template)
    net = working_copy(prior, params, "cpu")
    rgb, phi, y = _adapt_inputs(rng)
    cfg = tonline.AdaptConfig(lr=1e-3, update_per_iter=2)
    y_p = torch.from_numpy(np.array(bayer.pack(jnp.asarray(y))))
    phi_p = torch.from_numpy(np.array(bayer.pack(jnp.asarray(phi))))
    tonline.make_adapt_fn(prior, cfg)(net, torch.from_numpy(rgb), torch.tensor(0.1),
                                      y_p, phi_p, torch.from_numpy(y), torch.from_numpy(phi))
    for k, v in template.state_dict().items():
        np.testing.assert_array_equal(v, before[k])
        np.testing.assert_array_equal(params[k], params_before[k])
    assert any(not torch.equal(net.state_dict()[k], before[k]) for k in before)


def test_trainable_filter_freezes_other_parameters(rng):
    _, variables = flax_ffdnet()
    prior = tffdnet_prior(torch_ffdnet(variables))
    net = working_copy(prior, None, "cpu")
    before = {k: v.clone() for k, v in net.state_dict().items()}
    rgb, phi, y = _adapt_inputs(rng)
    cfg = tonline.AdaptConfig(lr=1e-3, update_per_iter=1, trainable_filter=("model.0.",))
    y_p = torch.from_numpy(np.array(bayer.pack(jnp.asarray(y))))
    phi_p = torch.from_numpy(np.array(bayer.pack(jnp.asarray(phi))))
    tonline.make_adapt_fn(prior, cfg)(net, torch.from_numpy(rgb), torch.tensor(0.1),
                                      y_p, phi_p, torch.from_numpy(y), torch.from_numpy(phi))
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]) != k.startswith("model.0."), k


def test_schedule_matches_jax():
    sig = (25 / 255, 12 / 255, 6 / 255)
    its = (15, 6, 4)
    for cfg_kw in ({}, {"interval_iter": 15}, {"interval_iter": 3, "update_times": 2}):
        s1, m1 = tonline.make_schedule(sig, its, tonline.AdaptConfig(**cfg_kw))
        s2, m2 = online.make_schedule(sig, its, online.AdaptConfig(**cfg_kw))
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(m1, m2)
    flagship = tonline.AdaptConfig(lr=2e-6, update_per_iter=2, interval_iter=15,
                                   initial_iter=1)
    assert np.nonzero(tonline.make_schedule(sig, its, flagship)[1])[0].tolist() == [15]
    lists = tonline.AdaptConfig(lr=(0.0, 1e-5), update_per_iter=(1, 2))
    assert tonline.resolve_stages(lists) == online.resolve_stages(
        online.AdaptConfig(lr=(0.0, 1e-5), update_per_iter=(1, 2)))
    assert tonline.first_lr(lists) == 1e-5


def test_unported_adaptation_options_raise():
    prior = tffdnet_prior(TFFDNet(nc=8, nb=4))
    # the adaptation crop and the input corruption are ported (their parity:
    # tests/test_torch_pipelines.py, tests/test_torch_train_parts.py); a
    # corruption of an unknown mode raises the JAX package's ValueError
    assert callable(tonline.make_adapt_fn(prior, tonline.AdaptConfig(crop=8)))
    for mode in ("s", "t", "b"):
        assert callable(tonline.make_adapt_fn(prior._replace(adapt_mask=(mode, 0.1)),
                                              tonline.AdaptConfig()))
    with pytest.raises(ValueError):
        tonline.make_adapt_fn(prior._replace(adapt_mask=("q", 0.1)), tonline.AdaptConfig())
