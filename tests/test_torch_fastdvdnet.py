"""Port FastDVDnet, its weight bridge, the FastDVDnet prior and the 'bayer1'
adaptation vs the JAX package, on the trained weights of
``weights/fastdvd.npz`` and the same numpy inputs (CPU).

Float32 bar: 2e-5 absolute on block and model outputs of order 1 (the two
frameworks sum a 3x3xC convolution in different orders). The bf16 bar is
stated in its test.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.adapt import online as tonline
from adaptivepnp_sci_torch.models import common as tcommon
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models import fastdvdnet as tfd
from adaptivepnp_sci_torch.solvers import priors as tpriors
from adaptivepnp_sci_tpu.adapt import online
from adaptivepnp_sci_tpu.models import common, fastdvdnet
from adaptivepnp_sci_tpu.ops import bayer
from adaptivepnp_sci_tpu.solvers import priors
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz

WEIGHTS = Path(__file__).resolve().parent.parent / "weights" / "fastdvd.npz"
ATOL = 2e-5


@pytest.fixture(scope="module")
def variables():
    return load_variables_npz(str(WEIGHTS))


def torch_net(variables, **kw):
    net = tfd.FastDVDnet(**kw)
    net.load_state_dict(tconvert.fastdvdnet_from_flax(variables))
    return net.eval()


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def sub(variables, *path):
    """The Flax variables of one sub-module of the model."""
    out = {}
    for coll in ("params", "batch_stats"):
        node = variables[coll]
        for p in path:
            node = node.get(p, {})
        if node:
            out[coll] = node
    return out


def test_depth_to_space_matches_jax_on_a_non_square_tensor(rng):
    x = rng.random((2, 5, 7, 12), dtype=np.float32)
    got = tcommon.depth_to_space(nchw(x), 2)
    want = common.depth_to_space(jnp.asarray(x), 2)
    assert got.shape == (2, 3, 10, 14)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


def test_npz_reader_matches_the_jax_package(variables):
    mine = tconvert.load_variables_npz(str(WEIGHTS))
    theirs = dict((jax.tree_util.keystr(p), v)
                  for p, v in jax.tree_util.tree_leaves_with_path(variables))
    flat = dict((jax.tree_util.keystr(p), v)
                for p, v in jax.tree_util.tree_leaves_with_path(mine))
    assert len(flat) == len(theirs) == 136
    for k, v in theirs.items():
        np.testing.assert_array_equal(flat[k], v)


def test_bridge_round_trip_is_exact(variables):
    sd = tconvert.fastdvdnet_from_flax(variables)
    assert set(sd) == set(tfd.FastDVDnet().state_dict())
    back = tconvert.fastdvdnet_to_flax(sd)
    a = jax.tree_util.tree_leaves_with_path(variables)
    b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(a) == len(b) == 136
    for path, leaf in a:
        np.testing.assert_array_equal(b[path], leaf)


BLOCKS = {
    # name: (Flax module, path of its variables, port submodule, input shapes NHWC)
    "CvBlock": (fastdvdnet.CvBlock(64), ("temp1", "downc0", "cvblock"),
                lambda n: n.temp1.downc0.convblock[3], [(2, 16, 12, 64)]),
    "InputCvBlock": (fastdvdnet.InputCvBlock(3, 32), ("temp1", "inc"),
                     lambda n: n.temp1.inc, [(2, 16, 12, 12)]),
    "DownBlock": (fastdvdnet.DownBlock(64), ("temp1", "downc0"),
                  lambda n: n.temp1.downc0, [(2, 16, 12, 32)]),
    "DownBlock_odd": (fastdvdnet.DownBlock(128), ("temp2", "downc1"),
                      lambda n: n.temp2.downc1, [(1, 9, 7, 64)]),
    "UpBlock": (fastdvdnet.UpBlock(64), ("temp1", "upc2"),
                lambda n: n.temp1.upc2, [(2, 8, 6, 128)]),
    "OutputCvBlock": (fastdvdnet.OutputCvBlock(3), ("temp2", "outc"),
                      lambda n: n.temp2.outc, [(2, 16, 12, 32)]),
    "DenBlock": (fastdvdnet.DenBlock(), ("temp2",), lambda n: n.temp2,
                 [(2, 32, 24, 3)] * 3 + [(2, 32, 24, 1)]),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_flax(variables, rng, name):
    module, path, pick, shapes = BLOCKS[name]
    xs = [rng.random(s, dtype=np.float32) for s in shapes]
    want = np.asarray(module.apply(sub(variables, *path), *[jnp.asarray(x) for x in xs]))
    with torch.no_grad():
        got = nhwc(pick(torch_net(variables))(*[nchw(x) for x in xs]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("sigma", [0.05, (0.02, 0.1)])
def test_forward_matches_flax(variables, rng, sigma):
    windows = rng.random((2, 5, 32, 24, 3), dtype=np.float32)
    s = np.asarray(sigma, np.float32)
    want = fastdvdnet.FastDVDnet().apply(variables, jnp.asarray(windows), jnp.asarray(s))
    with torch.no_grad():
        got = torch_net(variables)(torch.from_numpy(windows), torch.from_numpy(s))
    assert got.shape == (2, 32, 24, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_train_branch_matches_flax(variables, rng):
    """Train mode: batch statistics per triplet call. Outputs agree to 1e-4
    (normalising by batch statistics amplifies the summation-order noise).
    The running statistics move by momentum 0.1 in both: the means agree to
    1e-4. PyTorch feeds the running variance the unbiased batch variance,
    Flax the biased one, a factor n/(n-1) with as few as n = 2*8*6 values per
    channel at the U-Net's bottom, over up to three updates: rtol 1.5e-2."""
    windows = rng.random((2, 5, 32, 24, 3), dtype=np.float32)
    want, new = fastdvdnet.FastDVDnet().apply(
        variables, jnp.asarray(windows), jnp.float32(0.05), True, mutable=["batch_stats"])
    net = torch_net(variables).train()
    got = net(torch.from_numpy(windows), 0.05)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    stats = tconvert.fastdvdnet_to_flax(net.state_dict())["batch_stats"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(new["batch_stats"]):
        mine = stats
        for p in path:
            mine = mine[p.key]
        before = variables["batch_stats"]
        for p in path:
            before = before[p.key]
        assert np.abs(np.asarray(leaf) - before).max() > 0  # the statistics moved
        rtol = 1.5e-2 if path[-1].key == "var" else 1e-4
        np.testing.assert_allclose(mine, np.asarray(leaf), rtol=rtol, atol=1e-5)


def test_seq_circular_matches_flax_and_per_window_forward(variables, rng):
    frames = rng.random((8, 32, 24, 3), dtype=np.float32)
    want = fastdvdnet.FastDVDnet().apply(variables, jnp.asarray(frames), jnp.float32(0.05),
                                         method="seq_circular")
    net = torch_net(variables)
    x = torch.from_numpy(frames)
    with torch.no_grad():
        got = net.seq_circular(x, 0.05)
        per_window = net(x[tpriors.window_indices(8)], 0.05)
        t1 = net.triplet_stage1(torch.roll(x, 1, 0), x, torch.roll(x, -1, 0), 0.05)
        staged = net.triplet_stage2(torch.roll(t1, 1, 0), t1, torch.roll(t1, -1, 0), 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), per_window.numpy(), rtol=0, atol=ATOL)
    assert torch.equal(staged, got)


def test_forward_rejects_a_wrong_window(variables):
    with pytest.raises(ValueError):
        torch_net(variables)(torch.zeros(2, 3, 8, 8, 3), 0.1)


def test_bf16_mode_matches_jax_bf16_mode(variables, rng):
    """bf16 conv/BN chains with float32 residuals in both packages. Flax
    normalises in bf16 and rounds after every op; the port folds BatchNorm
    into a float32 scale and shift and rounds once per conv and once per
    BN+ReLU. The two differ at bf16 level in the noise estimate, which the
    float32 residual subtracts from frames in [0, 1]: bar max 1e-2 and mean
    1e-3 (found: 2.1e-3 and 1.4e-4), and each is as close to the other as to
    its own float32 model (found: 3.0e-3 and 3.1e-3)."""
    frames = rng.random((8, 32, 24, 3), dtype=np.float32)
    f32 = np.asarray(fastdvdnet.FastDVDnet().apply(
        variables, jnp.asarray(frames), jnp.float32(12 / 255), method="seq_circular"))
    want = np.asarray(fastdvdnet.FastDVDnet(dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(frames), jnp.float32(12 / 255), method="seq_circular"))
    with torch.no_grad():
        got = torch_net(variables, dtype=torch.bfloat16).seq_circular(
            torch.from_numpy(frames), 12 / 255)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    gap = np.abs(got.numpy() - want)
    assert gap.max() <= 1e-2 and gap.mean() <= 1e-3, (gap.max(), gap.mean())
    assert np.abs(got.numpy() - f32).max() <= 1e-2
    assert np.abs(want - f32).max() <= 1e-2


@pytest.mark.parametrize("name", ["InputCvBlock", "DownBlock", "DownBlock_odd", "UpBlock",
                                  "CvBlock", "OutputCvBlock"])
def test_bf16_block_close_to_its_float32_block(variables, rng, name):
    """Each bf16 block in channels-last memory (the grouped input conv, the
    stride-2 conv, the conv pair, the pixel shuffle) against the float32
    block on the same input: relative error at bf16 level, < 2e-2 of the
    output's maximum."""
    _, _, pick, shapes = BLOCKS[name]
    x = nchw(rng.random(shapes[0], dtype=np.float32))
    with torch.no_grad():
        want = pick(torch_net(variables))(x)
        low = x.bfloat16().contiguous(memory_format=torch.channels_last)
        got = pick(torch_net(variables, dtype=torch.bfloat16))(low)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert float((got.float() - want).abs().max()) < 2e-2 * float(want.abs().max())


@pytest.mark.parametrize("n,window", [(8, 5), (3, 5), (6, 3), (1, 5)])
def test_window_indices_match_jax(n, window):
    np.testing.assert_array_equal(tpriors.window_indices(n, window).numpy(),
                                  np.asarray(priors.window_indices(n, window)))
    if n > 1:
        np.testing.assert_array_equal(tpriors.window_indices_mirror(n, window).numpy(),
                                      np.asarray(priors.window_indices_mirror(n, window)))


@pytest.mark.parametrize("kw", [dict(window_chunk=4), dict(window_chunk=8),
                                dict(adapt_window_chunk=2)])
def test_chunked_prior_equals_seq_circular(variables, rng, kw):
    net = torch_net(variables)
    prior = tpriors.fastdvd_prior(net, **kw)
    assert prior.loss_mode == "bayer1" and prior.adapt_noise_std == 5 / 255
    x = torch.from_numpy(rng.random((8, 16, 16, 3), dtype=np.float32))
    sigma = torch.tensor(0.05)
    with torch.no_grad():
        want = net.seq_circular(x, sigma)
        np.testing.assert_allclose(prior.apply(net, x, sigma).numpy(), want.numpy(),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(prior.apply_adapt(net, x, sigma).numpy(), want.numpy(),
                                   rtol=0, atol=ATOL)
    with pytest.raises(ValueError):
        tpriors.fastdvd_prior(net, window_chunk=3).apply(net, x, sigma)


def _adapt_inputs(rng, b=8, h=16, w=16):
    rgb = rng.random((b, h, w, 3), dtype=np.float32)
    phi = (rng.random((b, h, w)) > 0.5).astype(np.float32)
    y = (rng.random((b, h, w), dtype=np.float32) * phi).sum(0)
    return rgb, phi, y


def _packed(y, phi):
    return (torch.from_numpy(np.array(bayer.pack(jnp.asarray(y)))),
            torch.from_numpy(np.array(bayer.pack(jnp.asarray(phi)))))


def test_bayer1_loss_and_gradient_match_jax(variables, rng):
    """The full-resolution measurement loss and its gradient for every
    parameter (conv kernels, BatchNorm scale and bias), remat on in both."""
    rgb, phi, y = _adapt_inputs(rng)
    sigma = np.float32(12 / 255)
    jprior = priors.fastdvd_prior(fastdvdnet.FastDVDnet())
    y_p, phi_p = bayer.pack(jnp.asarray(y)), bayer.pack(jnp.asarray(phi))
    loss = online.measurement_loss_fn(jprior, jnp.asarray(rgb), sigma, y_p, phi_p,
                                      jnp.asarray(y), jnp.asarray(phi))
    jval, jgrads = jax.value_and_grad(loss)(variables)

    net = torch_net(variables)
    tprior = tpriors.fastdvd_prior(net)
    tloss = tonline.measurement_loss_fn(
        tprior, net, torch.from_numpy(rgb), torch.tensor(sigma), *_packed(y, phi),
        torch.from_numpy(y), torch.from_numpy(phi))
    val = tloss()
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    grads = {k: p.grad for k, p in net.named_parameters()}
    grads.update({k: v for k, v in net.state_dict().items() if k not in grads})
    mine = tconvert.fastdvdnet_to_flax(grads)["params"]
    checked = 0
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads["params"]):
        got = mine
        for p in path:
            got = got[p.key]
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())
        checked += 1
    assert checked == 84  # 28 conv kernels + 28 BatchNorm scale/bias pairs


def test_remat_does_not_change_the_gradient(variables, rng):
    rgb, phi, y = _adapt_inputs(rng)
    grads = []
    for remat in (True, False):
        net = torch_net(variables, remat=remat)
        loss = tonline.measurement_loss_fn(
            tpriors.fastdvd_prior(net), net, torch.from_numpy(rgb), torch.tensor(0.05),
            *_packed(y, phi), torch.from_numpy(y), torch.from_numpy(phi))
        loss().backward()
        grads.append([p.grad.clone() for p in net.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _jax_trigger(variables, cfg_kw, rgb_in, sigma, y, phi, noise_std):
    """One JAX adaptation trigger; returns the adapted variables."""
    cfg = online.AdaptConfig(**cfg_kw)
    jprior = priors.fastdvd_prior(fastdvdnet.FastDVDnet())._replace(adapt_noise_std=noise_std)
    opt = online.default_adam(online.first_lr(cfg))
    jadapt = online.make_adapt_fn(jprior, opt, cfg)
    jvars, _, _ = jadapt(variables, opt.init(variables["params"]), jax.random.PRNGKey(0),
                         jnp.asarray(rgb_in), sigma, bayer.pack(jnp.asarray(y)),
                         bayer.pack(jnp.asarray(phi)), jnp.asarray(y), jnp.asarray(phi))
    return jvars


def _assert_same_step(variables, jvars, net, lr, steps):
    """A fresh Adam's step is about lr * sign(g): a weight whose gradient is
    near Adam's eps can move by a different amount in the two frameworks, at
    most ``steps * lr`` apart; everywhere else the updates agree to 2 % of lr."""
    got = tconvert.fastdvdnet_to_flax(net.state_dict())
    n_far = n_all = 0
    for path, want in jax.tree_util.tree_leaves_with_path(jvars["params"]):
        mine, before = got["params"], variables["params"]
        for p in path:
            mine, before = mine[p.key], before[p.key]
        d_jax, d_torch = np.asarray(want) - before, mine - before
        assert np.abs(d_jax).max() > 0.5 * lr  # the trigger moved the weights
        diff = np.abs(d_torch - d_jax)
        assert diff.max() <= steps * lr + 1e-8
        n_far += int((diff > 0.02 * lr).sum())
        n_all += diff.size
    assert n_far <= 0.01 * n_all, (n_far, n_all)
    # BatchNorm's running statistics are bitwise unchanged
    for path, want in jax.tree_util.tree_leaves_with_path(variables["batch_stats"]):
        mine = got["batch_stats"]
        for p in path:
            mine = mine[p.key]
        np.testing.assert_array_equal(mine, want)


def test_adapt_trigger_matches_jax_with_its_noise_injected(variables, rng):
    """One trigger of the slice's AdaptConfig (2 Adam steps, fresh Adam) with
    the adaptation noise on in JAX: the port gets the very draw JAX makes
    (the first split of PRNGKey(0)) added to its input, and its own noise off."""
    rgb, phi, y = _adapt_inputs(rng)
    sigma = np.float32(12 / 255)
    cfg_kw = dict(lr=2e-6, update_per_iter=2, interval_iter=12, initial_iter=1)
    jvars = _jax_trigger(variables, cfg_kw, rgb, sigma, y, phi, 5 / 255)
    _, subkey = jax.random.split(jax.random.PRNGKey(0))
    noise = np.asarray(jax.random.normal(subkey, rgb.shape, jnp.float32))

    net = torch_net(variables)
    tprior = tpriors.fastdvd_prior(net)._replace(adapt_noise_std=0.0)
    tonline.make_adapt_fn(tprior, tonline.AdaptConfig(**cfg_kw))(
        net, torch.from_numpy(rgb + np.float32(5 / 255) * noise), torch.tensor(sigma),
        *_packed(y, phi), torch.from_numpy(y), torch.from_numpy(phi))
    assert not net.training
    _assert_same_step(variables, jvars, net, 2e-6, 2)


def test_adaptation_noise_comes_from_the_generator(variables, rng):
    """The port's own noise: drawn from the generator it is given, with the
    prior's standard deviation; the same seed gives the same adapted weights,
    another seed different ones, and no generator is an error."""
    rgb, phi, y = _adapt_inputs(rng, h=32, w=32)
    seen = []

    def spy(net, x, sigma):
        seen.append(x.detach().clone())
        return net.seq_circular(x, sigma)

    def trigger(seed):
        net = torch_net(variables)
        prior = tpriors.fastdvd_prior(net)._replace(apply_adapt=spy)
        adapt = tonline.make_adapt_fn(prior, tonline.AdaptConfig(lr=2e-6, update_per_iter=1))
        args = (net, torch.from_numpy(rgb), torch.tensor(0.05), *_packed(y, phi),
                torch.from_numpy(y), torch.from_numpy(phi))
        if seed is None:
            with pytest.raises(ValueError):
                adapt(*args)
            return None
        adapt(*args, torch.Generator().manual_seed(seed))
        return net.state_dict()

    a, b, c = trigger(0), trigger(0), trigger(1)
    trigger(None)
    noise = (seen[0] - torch.from_numpy(rgb)).numpy()
    assert abs(noise.std() - 5 / 255) < 0.02 * 5 / 255 and abs(noise.mean()) < 1e-3
    assert torch.equal(seen[0], seen[1]) and not torch.equal(seen[0], seen[2])
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
