"""Port DDnet vs the JAX package on the CPU: the model in float32 and bf16,
the weight bridge, the reference checkpoint layout, the demosaicker wrappers
and the demosaicker's online adaptation (``dm_update``).

Both packages get the same numpy inputs and weights (the trained
``weights/ddnet.npz``, or Flax's init, bridged). Bars: float32 model
<= 5e-5 abs; bf16 as stated at each test.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.adapt import ddnet_online as tdm
from adaptivepnp_sci_torch.models import common as tcommon
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.ddnet import DDnet as TDDnet
from adaptivepnp_sci_torch.solvers import priors as tpriors
from adaptivepnp_sci_tpu.adapt import ddnet_online
from adaptivepnp_sci_tpu.models import common, convert
from adaptivepnp_sci_tpu.models.ddnet import DDnet
from adaptivepnp_sci_tpu.ops import bayer
from adaptivepnp_sci_tpu.solvers import priors
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz
from test_ddnet import TDDnet as OracleDDnet

WEIGHTS = Path(__file__).resolve().parent.parent / "weights" / "ddnet.npz"


@pytest.fixture(scope="module")
def variables():
    return load_variables_npz(str(WEIGHTS))


def port(variables, dtype=None) -> TDDnet:
    net = TDDnet(dtype=dtype)
    net.load_state_dict(tconvert.ddnet_from_flax(variables))
    return net.eval()


def run(net: TDDnet, windows: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return net(torch.from_numpy(windows)).numpy()


def sparse_windows(rng, n, h, w) -> np.ndarray:
    """Windows of sparse-RGB-embedded random mosaics, as the demosaicker feeds them."""
    return np.asarray(bayer.embed_rgb(jnp.asarray(rng.random((n, 5, h, w), dtype=np.float32))))


@pytest.fixture(scope="module")
def init_pair(variables):
    """Weights in Flax's init scheme (LeCun-normal kernels from numpy, unit
    ``weight_tensor_*``) and an input, as ``tests/test_ddnet.py`` tests bf16."""
    gen = np.random.default_rng(0)

    def init(path, leaf):
        if path[-1].key.startswith("weight_tensor"):
            return np.ones_like(leaf)
        kh, kw, cin, _ = leaf.shape
        return (gen.standard_normal(leaf.shape) / np.sqrt(kh * kw * cin)).astype(np.float32)

    x = np.random.default_rng(42).random((1, 5, 16, 16, 3), dtype=np.float32)
    return jax.tree_util.tree_map_with_path(init, variables), x


@pytest.mark.parametrize("hw", [16, 32])
def test_ddnet_matches_jax(variables, rng, hw):
    x = rng.random((2, 5, hw, hw, 3), dtype=np.float32)
    want = np.asarray(DDnet().apply(variables, jnp.asarray(x)))
    got = run(port(variables), x)
    assert got.shape == (2, hw, hw, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_reference_layout_state_dict_loads_as_it_is():
    """The reference checkpoint's layout (``tests/test_ddnet.py``'s oracle),
    with a DataParallel prefix and the unused ``inc`` block the converter drops."""
    torch.manual_seed(1)
    oracle = OracleDDnet().eval()
    with torch.no_grad():
        oracle.weight_tensor_in.normal_(1.0, 0.1)
        oracle.weight_tensor_in2.normal_(1.0, 0.1)
        oracle.weight_tensor_out.normal_(0.5, 0.1)
    sd = {f"module.{k}": v for k, v in oracle.state_dict().items()}
    sd["module.temp1.inc.convblock.0.weight"] = torch.zeros(90, 12, 3, 3)
    net = TDDnet().eval()
    net.load_state_dict(tconvert.ddnet_state_dict_from_reference(sd))  # strict

    x = np.random.default_rng(3).random((2, 5, 16, 16, 3), dtype=np.float32)
    with torch.no_grad():
        want = oracle(torch.from_numpy(x.transpose(0, 1, 4, 2, 3).reshape(2, 15, 16, 16).copy()))
    np.testing.assert_allclose(run(net, x), want.permute(0, 2, 3, 1).numpy(), rtol=0, atol=5e-5)
    jax_vars = convert.ddnet_variables({k: v.numpy() for k, v in oracle.state_dict().items()})
    np.testing.assert_allclose(run(net, x), np.asarray(DDnet().apply(jax_vars, jnp.asarray(x))),
                               rtol=0, atol=5e-5)


def test_state_dict_from_reference_drops_only_inc():
    sd = {"temp1.inc.convblock.0.weight": np.zeros((90, 12, 3, 3), np.float32),
          "temp1.inc_1.convblock.0.weight": np.ones((90, 1, 3, 3), np.float32),
          "weight_tensor_in": np.ones((9, 1, 1, 1, 1), np.float32)}
    out = tconvert.ddnet_state_dict_from_reference(sd)
    assert sorted(out) == ["temp1.inc_1.convblock.0.weight", "weight_tensor_in"]
    assert out["weight_tensor_in"].dtype == torch.float32


def test_bridge_round_trip_is_bit_exact(variables):
    sd = tconvert.ddnet_from_flax(variables)
    assert sum(t.numel() for t in sd.values()) == sum(p.numel() for p in TDDnet().parameters())
    back = tconvert.ddnet_to_flax(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)
    again = tconvert.ddnet_from_flax(back)
    assert all(torch.equal(again[k], sd[k]) for k in sd)


# bf16 against JAX's bf16 mode, measured on the CPU: with init-scheme weights
# the two are bit-equal; with the trained weights the two routes round a few sums
# differently (9.9e-3 max, 5.0e-4 mean measured at 32 x 32)
BF16_BARS = {"init": (1e-6, 1e-7), "trained": (2e-2, 2e-3)}


@pytest.mark.parametrize("weights", list(BF16_BARS))
def test_bf16_mode_matches_jax_bf16_mode(variables, init_pair, rng, weights):
    if weights == "init":
        v, x = init_pair
    else:
        v, x = variables, sparse_windows(rng, 2, 32, 32)
    got = run(port(v, torch.bfloat16), x)
    want = np.asarray(DDnet(dtype=jnp.bfloat16).apply(v, jnp.asarray(x)))
    assert got.dtype == np.float32
    max_bar, mean_bar = BF16_BARS[weights]
    diff = np.abs(got - want)
    assert diff.max() <= max_bar and diff.mean() <= mean_bar, (diff.max(), diff.mean())


def test_bf16_close_to_float32(init_pair):
    """The bars of the JAX package's own bf16 test: 3e-2 max, 5e-3 mean."""
    v, x = init_pair
    ref = run(port(v), x)
    got = run(port(v, torch.bfloat16), x)
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2)
    assert float(np.abs(got - ref).mean()) < 5e-3


def test_upsample_matches_jax(rng):
    x = rng.random((2, 7, 9, 4), dtype=np.float32)
    want = np.asarray(common.upsample_bilinear_align_corners(jnp.asarray(x), 2))
    got = tcommon.upsample_bilinear_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)


def test_forward_rejects_a_wrong_window():
    with pytest.raises(ValueError):
        TDDnet()(torch.zeros(1, 3, 8, 8, 3))


@pytest.mark.parametrize("hw", [(32, 32), (29, 38)])
def test_ddnet_demosaic_matches_jax(variables, rng, hw):
    """``ddnet_demosaic`` and its param form; (29, 38) takes the reflect pad,
    by 3 rows and 2 columns."""
    frames = rng.random((6, *hw), dtype=np.float32)
    want = np.asarray(priors.ddnet_demosaic(DDnet(), variables)(jnp.asarray(frames)))
    template = TDDnet()
    before = {k: v.clone() for k, v in template.state_dict().items()}
    params = tconvert.ddnet_from_flax(variables)
    got = tpriors.ddnet_demosaic(template, params)(torch.from_numpy(frames))
    assert got.shape == (6, *hw, 3) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
    got_p = tpriors.ddnet_demosaic_param(template)(port(variables), torch.from_numpy(frames))
    np.testing.assert_allclose(got_p.detach().numpy(), want, rtol=0, atol=5e-5)
    # neither the template nor the caller's parameters changed
    assert all(torch.equal(template.state_dict()[k], v) for k, v in before.items())
    assert all(torch.equal(params[k], v) for k, v in tconvert.ddnet_from_flax(variables).items())


def test_dm_consistency_loss_matches_jax(variables, rng):
    frames = rng.random((6, 16, 16), dtype=np.float32)
    want = float(ddnet_online.dm_consistency_loss(DDnet(), variables, jnp.asarray(frames)))
    with torch.no_grad():
        got = float(tdm.dm_consistency_loss(port(variables), torch.from_numpy(frames)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("fresh_opt", [False, True])
def test_dm_adapt_fn_matches_jax(variables, rng, fresh_opt):
    """Two Adam steps over every DDnet parameter: the loss, and the weights
    within 2 lr of JAX's everywhere (a first Adam step moves a weight by ~lr
    whatever its gradient) and within 5 % of lr for 99 % of them (0 % off
    measured). About a third of the weights get no gradient on these inputs."""
    lr, steps = 1e-4, 2
    frames = rng.random((6, 16, 16), dtype=np.float32)
    jadapt = ddnet_online.make_dm_adapt_fn(DDnet(), lr, steps, fresh_opt=fresh_opt)
    jvars, _, jloss = jadapt(variables, jadapt.init_opt(variables), jnp.asarray(frames))
    params = tconvert.ddnet_from_flax(variables)
    adapt = tdm.make_dm_adapt_fn(TDDnet(), lr, steps, fresh_opt=fresh_opt)
    sd, opt_state, loss = adapt(params, None, torch.from_numpy(frames))
    assert abs(float(loss) - float(jloss)) <= 1e-6 * max(1.0, abs(float(jloss)))
    assert len(opt_state["state"]) == len(sd)  # every parameter, weight_tensor_* too
    assert all(s["step"] == (1 if fresh_opt else steps) for s in opt_state["state"].values())
    want = tconvert.ddnet_from_flax(jax.tree_util.tree_map(np.asarray, jvars))
    n_far = n_all = moved = 0
    for k, w in want.items():
        diff = (sd[k] - w).abs()
        assert float(diff.max()) <= steps * lr + 1e-8, k
        n_far += int((diff > 0.05 * lr).sum())
        n_all += diff.numel()
        moved += int((sd[k] != params[k]).sum())
    assert moved > 0.5 * n_all and n_far <= 0.01 * n_all, (moved, n_far, n_all)
    # the caller's parameters are untouched
    assert all(torch.equal(params[k], v) for k, v in tconvert.ddnet_from_flax(variables).items())
