"""Denoiser trainer (port of ``adaptivepnp_sci_tpu.train.trainer``):
``torch.optim.Adam`` with milestone learning-rate drops, SVD
orthogonalization, checkpoint and resume, validation PSNR.

Reference semantics: the milestone schedule lr -> lr/10 -> lr/1000 with the
orthogonalization off after the last milestone
(``packages/ffdnet/train.py:113-122``); checkpoints of model, optimizer and
step (``packages/DDnet/train_common.py:110-125``) and resume (``:21-64``).

A checkpoint is one ``torch.save`` file (``.pt``), read back with
``weights_only=True``; :func:`save_variables_npz` writes the JAX package's
``/``-keyed ``.npz`` of Flax variables, which both packages read. Orbax
checkpoint directories are refused. Data parallelism (the JAX trainer's
``mesh``) is not ported yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch
from torch import Tensor

from adaptivepnp_sci_torch.models import convert
from adaptivepnp_sci_torch.ops.metrics import psnr
from adaptivepnp_sci_torch.solvers.priors import module_copy
from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32
from adaptivepnp_sci_torch.train.regularizers import svd_orthogonalize
from adaptivepnp_sci_torch.train.tasks import TrainTask
from adaptivepnp_sci_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclass
class TrainerConfig:
    lr: float = 1e-3
    milestones: tuple[int, int] = (50, 60)   # epochs: /10, then /1000 and no orthogonalization
    epochs: int = 80
    steps_per_epoch: int = 1000
    orthogonalize_every: int = 0             # steps; 0 = off
    ckpt_dir: str | None = None
    ckpt_every_epochs: int = 10
    seed: int = 42
    tensorboard_dir: str | None = None       # scalar logging (the reference's tensorboardX)


def _to_device(batch: Any, device: torch.device) -> Any:
    """A batch (an array, or a tuple of arrays) as tensors on ``device``."""
    if isinstance(batch, (tuple, list)):
        return tuple(_to_device(b, device) for b in batch)
    return torch.as_tensor(batch, device=device)


class Trainer:
    """Trains a working copy of ``task.model`` holding ``variables`` (a state
    dict; None: the template's weights) on ``device``. The caller's template
    and ``variables`` are never changed.

    The random draws of the tasks come from ``self.generator``, a
    ``torch.Generator`` on ``device`` seeded with ``config.seed``; assign a
    CPU generator to draw the same numbers on any device."""

    def __init__(self, task: TrainTask, variables: Mapping[str, Tensor] | None,
                 config: TrainerConfig, device: torch.device | str = "cuda"):
        self.task = task
        self.config = config
        self.device = torch.device(device)
        self.net = module_copy(task.model, variables, self.device).train()
        # Adam over the parameters only: BatchNorm's running statistics are buffers
        self.optimizer = torch.optim.Adam(self.net.parameters(), lr=config.lr, eps=1e-8)
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self._tb = None
        if config.tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(config.tensorboard_dir)
            except ImportError:
                log.warning("tensorboard unavailable; scalar logging disabled")

    @property
    def variables(self) -> dict[str, Tensor]:
        """The trained weights: the working copy's state dict."""
        return self.net.state_dict()

    @property
    def epoch(self) -> int:
        return self.step // self.config.steps_per_epoch

    def learning_rate(self, count: int) -> float:
        """The lr of update ``count`` (0-based), as
        ``optax.piecewise_constant_schedule(lr, {(m0+1)*spe: 0.1,
        (m1+1)*spe: 0.01})``: each scale applies from its boundary on."""
        spe = self.config.steps_per_epoch
        m0, m1 = self.config.milestones
        lr = self.config.lr
        for boundary, scale in sorted({(m0 + 1) * spe: 0.1, (m1 + 1) * spe: 0.01}.items()):
            if count >= boundary:
                lr *= scale
        return lr

    def train_step(self, batch: Any) -> Tensor:
        """One Adam step on ``batch`` (an array, or a tuple of arrays); then,
        every ``orthogonalize_every`` steps up to the last milestone's epoch,
        the SVD orthogonalization of the conv weights. Returns the loss as a
        device tensor, not synchronised. TF32 is off for the step."""
        batch = _to_device(batch, self.device)
        for group in self.optimizer.param_groups:
            group["lr"] = self.learning_rate(self.step)
        with full_f32():
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.task.loss_fn(self.net, self.generator, batch)
            loss.backward()
            self.optimizer.step()
            self.step += 1
            cfg = self.config
            if (cfg.orthogonalize_every and self.step % cfg.orthogonalize_every == 0
                    and self.epoch <= cfg.milestones[1]):
                svd_orthogonalize(self.net)
        return loss.detach()

    # ---- checkpoint / resume ---------------------------------------------

    def save(self, path: str | None = None) -> str:
        """Write ``{variables, opt_state, step, generator}`` with
        ``torch.save`` to ``path`` (default ``ckpt_dir/step_{N}.pt``)."""
        path = path or os.path.join(self.config.ckpt_dir, f"step_{self.step}.pt")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save({"variables": {k: v.detach().cpu() for k, v in self.variables.items()},
                    "opt_state": self.optimizer.state_dict(),
                    "step": self.step,
                    "generator": self.generator.get_state(),
                    "generator_device": self.generator.device.type}, path)
        log.info("checkpoint saved -> %s", path)
        return path

    def restore(self, path: str) -> None:
        """Continue from a :meth:`save` file: weights, Adam state, step count
        and, when it was saved on the same device type, the generator."""
        ckpt = read_checkpoint(path)
        self.net.load_state_dict(ckpt["variables"])
        self.optimizer.load_state_dict(ckpt["opt_state"])
        self.step = int(ckpt["step"])
        if ckpt.get("generator_device") == self.generator.device.type:
            self.generator.set_state(ckpt["generator"])
        else:
            log.warning("%s: generator saved on %s, not %s; the draws restart from the "
                        "seed", path, ckpt.get("generator_device"), self.generator.device.type)
        log.info("resumed from %s at step %d", path, self.step)

    # ---- loops ------------------------------------------------------------

    def fit(self, batches: Iterator[Any], max_steps: int,
            val_fn: Callable[[Any], float] | None = None, val_every: int = 0,
            log_every: int = 100) -> list[float]:
        """Steps over ``batches`` until ``max_steps``; returns the losses,
        brought to the host in one transfer at the end."""
        losses: list[Tensor] = []
        for batch in batches:
            losses.append(self.train_step(batch))
            if self.step % log_every == 0:
                loss = float(losses[-1])
                if self._tb:
                    self._tb.add_scalar("train/loss", loss, self.step)
                log.info("step %d epoch %d loss %.6f", self.step, self.epoch, loss)
            if val_every and val_fn and self.step % val_every == 0:
                val = val_fn(self.variables)
                if self._tb:
                    self._tb.add_scalar("val/psnr", val, self.step)
                log.info("step %d val %.3f", self.step, val)
            if (self.config.ckpt_dir
                    and self.step % (self.config.ckpt_every_epochs
                                     * self.config.steps_per_epoch) == 0):
                self.save()
            if self.step >= max_steps:
                break
        if not losses:
            return []
        return torch.stack(losses).cpu().tolist()


def read_checkpoint(path: str) -> dict:
    """A :meth:`Trainer.save` file, read with ``weights_only=True`` onto the
    CPU. An orbax checkpoint directory (the JAX package's) is refused."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an orbax checkpoint of the JAX package); "
                         "this package reads .pt trainer checkpoints and /-keyed .npz files")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "variables" not in ckpt:
        raise ValueError(f"{path}: not a trainer checkpoint (no 'variables')")
    return ckpt


def save_variables_npz(path: str, variables: Mapping[str, Any]) -> None:
    """Write model variables as the JAX package's portable ``.npz``: the Flax
    variables tree flattened with ``/``-joined keys. ``variables`` is a state
    dict of the port's FFDNet, FastDVDnet or DDnet (converted to the Flax
    layout) or a Flax tree of arrays."""
    if variables and all(isinstance(v, Tensor) for v in variables.values()):
        variables = convert.flax_from_state_dict(variables)
    flat: dict[str, np.ndarray] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", variables)
    np.savez(path, **flat)


load_variables_npz = convert.load_variables_npz


def load_checkpoint_variables(path: str) -> dict[str, Tensor]:
    """The model variables of a trainer ``.pt`` checkpoint or a ``/``-keyed
    ``.npz`` of Flax variables, as the state dict of the port's model (on the
    CPU). Orbax directories are refused."""
    if path.endswith(".npz"):
        return convert.state_dict_from_flax(load_variables_npz(path))
    return dict(read_checkpoint(path)["variables"])


def validation_psnr(model_apply: Callable[[Any, Tensor], Tensor], variables: Any,
                    noisy: Tensor, clean: Tensor) -> float:
    """PSNR of ``model_apply(variables, noisy)``, clipped to [0, 1], against
    ``clean``."""
    out = model_apply(variables, noisy)
    return float(psnr(torch.as_tensor(clean, device=out.device), torch.clamp(out, 0, 1)))
