"""The FastDVDnet task's penalties and the distillation task, port vs the JAX
package on the CPU, with the JAX loss's draws injected (the helpers and bars
of ``tests/test_torch_train_tasks.py``: loss 1e-5 relative, gradients 1e-4 of
each tensor's largest entry, BatchNorm statistics 1e-6 relative).

* Lipschitz: the second train-mode forward leaves the statistics as the
  first left them. On the trained weights the net is contractive here and
  the penalty zero, so ``temp2``'s last conv is scaled by 4 in both packages.
  Gradients held to 2e-4: on these weights JAX's float32 train-mode
  gradients are the less accurate side, 2.3e-5 from a float64 evaluation of
  the same loss against the port's 3.8e-6; the reading here is 9.7e-5.
* Spectral: the power iteration (``spectral_iters=1``) runs on the eval-mode
  operator with the statistics of the start of the step; a target of 0.1
  keeps the penalty active.
* A penalty must add at least 5 % to the loss (against the port's loss
  without it, on the same draws).
* Distillation: one clip noised, one used as it is, and the Jacobian
  matching along a random unit direction (eval-mode operators).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet as TFastDVDnet
from adaptivepnp_sci_torch.solvers.priors import module_copy
from adaptivepnp_sci_torch.train import tasks as ttasks
from adaptivepnp_sci_tpu.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_tpu.train import tasks
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz
from tests.test_torch_train_tasks import (
    Draws,
    _clips,
    fastdvd_case,
    push_jax_draws,
    run_case,
    teacher_fn,
)

WEIGHTS = Path(__file__).resolve().parent.parent / "weights"

PENALTIES = {
    "lipschitz": {"lipschitz_penalty": 0.1, "output_gain": 4.0},
    "spectral": {"spectral_penalty": 0.5, "spectral_iters": 1, "spectral_target": 0.1},
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Small tensors gain nothing from many threads, and the other test
    workers share the cores: two intra-op threads while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fdvd_vars():
    return load_variables_npz(str(WEIGHTS / "fastdvd.npz"))


@pytest.mark.parametrize("case", list(PENALTIES))
def test_fastdvd_penalty_matches_jax(monkeypatch, fdvd_vars, case):
    got, variables, clips = fastdvd_case(monkeypatch, fdvd_vars, PENALTIES[case])
    draws = Draws(monkeypatch)
    push_jax_draws(draws, "fastdvd", jax.random.PRNGKey(5), clips.shape)
    net = module_copy(TFastDVDnet(), tconvert.state_dict_from_flax(variables), "cpu").train()
    with torch.no_grad():
        plain = ttasks.fastdvd_task(TFastDVDnet()).loss_fn(
            net, torch.Generator(), torch.from_numpy(clips)).item()
    assert got["loss"] >= 1.05 * plain, (got["loss"], plain)


def test_fastdvd_distill_task_with_jacobian_matches_jax(monkeypatch, fdvd_vars):
    clips = _clips(4, (2, 5, 16, 16, 3))
    batch = (clips, np.array([0.1, 0.05], np.float32), np.array([1.0, 0.0], np.float32))
    run_case(monkeypatch, "fastdvd_distill",
             tasks.fastdvd_distill_task(FastDVDnet(remat=False), teacher_fn(jax.numpy),
                                        jac_weight=0.3),
             ttasks.fastdvd_distill_task(TFastDVDnet(), teacher_fn(torch), jac_weight=0.3),
             fdvd_vars, batch, jax.random.PRNGKey(6), {"jac_weight": 0.3})
