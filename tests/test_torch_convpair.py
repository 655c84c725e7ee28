"""The port's plain conv pair (``ops/convpair.py``) vs the JAX A/B script's
``xla_convpair`` and its Pallas kernel in interpret mode, on the CPU.

The script is loaded by path and left as it is; the Pallas call is switched to
interpret mode for the test only. Gate: the script's own, max abs error /
max abs reference < 2e-2 (bf16 level).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from adaptivepnp_sci_torch.ab_convpair import library_pair, make_inputs
from adaptivepnp_sci_torch.ops import convpair as tconvpair

ROOT = Path(__file__).resolve().parent.parent
GATE = 2e-2


@pytest.fixture(scope="module")
def script():
    """``scripts/ab_pallas_convpair.py`` as a module. Importing it points
    JAX's compilation cache at a directory of its own; that is undone."""
    cache_dir = jax.config.jax_compilation_cache_dir
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    spec = importlib.util.spec_from_file_location(
        "ab_pallas_convpair", ROOT / "scripts" / "ab_pallas_convpair.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_secs)
    return mod


def as_jax(args):
    """The port's inputs as the script takes them (scale / shift as (1, C))."""
    x, w1, s1, b1, w2, s2, b2 = (t.float().numpy() for t in args)
    low = [jnp.asarray(t, jnp.bfloat16) for t in (x, w1, w2)]
    vec = [jnp.asarray(t.reshape(1, -1)) for t in (s1, b1, s2, b2)]
    return low[0], low[1], vec[0], vec[1], low[2], vec[2], vec[3]


def rel_err(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref.astype(jnp.float32))
    return float(np.abs(got.float().numpy() - ref).max() / np.abs(ref).max())


def test_plain_convpair_matches_xla_convpair(script):
    args = make_inputs(2, 32, 32, 32, torch.device("cpu"))
    assert args[0].dtype == torch.bfloat16 and args[2].dtype == torch.float32
    got = tconvpair.convpair(*args)
    assert got.shape == (2, 32, 32, 32) and got.dtype == torch.bfloat16
    assert rel_err(got, script.xla_convpair(*as_jax(args))) < GATE


def test_plain_convpair_matches_pallas_kernel_interpreted(script, monkeypatch):
    """The TPU kernel itself, run by the Pallas interpreter on 16x16 tiles."""
    args = make_inputs(2, 32, 32, 32, torch.device("cpu"))
    monkeypatch.setattr(script.pl, "pallas_call",
                        functools.partial(script.pl.pallas_call, interpret=True))
    ref = script.pallas_convpair.__wrapped__(*as_jax(args), th=16, tw=16)
    assert rel_err(tconvpair.convpair(*args), ref) < GATE


def test_border_of_intermediate_is_zero_padded(script):
    """With x = 0 the intermediate is relu(b1) inside the image and must be
    zero outside it: a corner output then sums 4 taps of it, an interior one
    9. A pair that pads the intermediate with relu(b1) fails this."""
    c = 32
    x, w1, _, _, w2, _, _ = make_inputs(1, 12, 12, c, torch.device("cpu"))
    x = torch.zeros_like(x)
    w2 = torch.full_like(w2, 0.01)
    s = torch.ones(c)
    b1, b2 = torch.full((c,), 0.5), torch.zeros(c)
    args = (x, w1, s, b1, w2, s, b2)
    got = tconvpair.convpair(*args).float()
    full = 9 * c * 0.5 * float(w2[0, 0, 0, 0])
    np.testing.assert_allclose(got[0, 5, 5].numpy(), full, rtol=1e-2)
    np.testing.assert_allclose(got[0, 0, 0].numpy(), full * 4 / 9, rtol=1e-2)
    np.testing.assert_allclose(got[0, 0, 5].numpy(), full * 6 / 9, rtol=1e-2)
    assert rel_err(got, script.xla_convpair(*as_jax(args))) < 1e-2


def test_conv2d_lowp_equals_the_cpu_bf16_convolution():
    """On the CPU the low-precision convolution is computed in float32 from
    the bf16 values and rounded once: the arithmetic of a bf16 convolution
    with float32 sums. Against PyTorch's own bf16 CPU convolution the two may
    differ by one rounding of the sum (summation order): 1 bf16 ulp."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 12, 9, 11, generator=g).bfloat16()
    for groups, stride, cout in ((1, 1, 8), (3, 1, 6), (1, 2, 8)):
        w = (torch.randn(cout, 12 // groups, 3, 3, generator=g) * 0.2).bfloat16()
        got = tconvpair.conv2d_lowp(x, w.float(), stride, groups)
        want = F.conv2d(x, w, None, stride, 1, 1, groups)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        ulp = want.float().abs().clamp_min(2.0 ** -6) * 2.0 ** -7
        assert bool(((got.float() - want.float()).abs() <= ulp).all())


def test_fold_bn_is_eval_batchnorm():
    g = torch.Generator().manual_seed(1)
    bn = nn.BatchNorm2d(6).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(6, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(6, generator=g))
        bn.running_mean.copy_(torch.randn(6, generator=g))
        bn.running_var.copy_(torch.rand(6, generator=g) + 0.1)
    x = torch.randn(2, 6, 5, 7, generator=g)
    s, b = tconvpair.fold_bn(bn)
    torch.testing.assert_close(tconvpair.scale_shift_relu(x, s, b), F.relu(bn(x)),
                               rtol=1e-5, atol=1e-6)
    assert s.requires_grad and b.requires_grad  # the adaptation trains gamma and beta


def test_plain_convpair_is_differentiable():
    """The adaptation's forward-with-gradient takes the plain pair: its
    gradients exist for the input, both kernels and both scale/shift pairs,
    and agree with a float32 pair to bf16 accuracy."""
    args = [t.clone().requires_grad_(True)
            for t in make_inputs(1, 8, 8, 32, torch.device("cpu"))]
    tconvpair.convpair(*args).float().square().sum().backward()

    def f32_pair(x, w1, s1, b1, w2, s2, b2):
        v = x.permute(0, 3, 1, 2)
        for w, s, b in ((w1, s1, b1), (w2, s2, b2)):
            v = F.relu(F.conv2d(v, w.permute(3, 2, 0, 1), padding=1)
                       * s.view(1, -1, 1, 1) + b.view(1, -1, 1, 1))
        return v.permute(0, 2, 3, 1)

    ref = [t.detach().float().requires_grad_(True) for t in args]
    f32_pair(*ref).square().sum().backward()
    for got, want in zip(args, ref):
        assert got.grad is not None and got.grad.dtype == got.dtype
        scale = float(want.grad.abs().max())
        assert float((got.grad.float() - want.grad).abs().max()) <= 5e-2 * scale


def test_library_pair_computes_the_same_function():
    """The library formulation that the card's timings use as yardstick."""
    args = make_inputs(2, 10, 12, 32, torch.device("cpu"))
    ref = tconvpair.convpair(*args).float()
    lib = library_pair(*args)().permute(0, 2, 3, 1).float()
    assert float((lib - ref).abs().max() / ref.abs().max()) < GATE
