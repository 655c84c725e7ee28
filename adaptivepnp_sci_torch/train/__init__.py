"""Offline denoiser training (port of ``adaptivepnp_sci_tpu.train``): FFDNet,
FastDVDnet and DDnet tasks, Adam with milestone drops, SVD
orthogonalization, ``.pt`` checkpoints and the ``/``-keyed ``.npz`` of Flax
variables."""

from adaptivepnp_sci_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
