"""Multi-process parallelism over ``torch.distributed``
(port of ``adaptivepnp_sci_tpu.parallel``).

The JAX package shards over one ``('data', 'frame')`` device mesh and lets
XLA insert the collectives. Here each device is one process, and the same
two axes are process groups (:mod:`.mesh`):

* **data**: scenes, tiles and training batches split over ranks; the
  gradients and the guard's residuals are all-reduced
  (:func:`~adaptivepnp_sci_torch.parallel.sharded.make_dp_train_step`,
  ``TrainerConfig.mesh``, ``two_stage_admm_tiled(mesh=)``);
* **frame**: the B-frame video cube split over ranks; the sliding-window
  denoiser exchanges ring halos (:mod:`.halo`,
  :func:`~adaptivepnp_sci_torch.parallel.sharded.fastdvd_prior_sharded`).

:mod:`.distributed` joins the processes (``init_process_group`` with an
explicit backend: NCCL for CUDA devices, gloo for the CPU).
"""

from adaptivepnp_sci_torch.parallel.halo import halo_windows  # noqa: F401
from adaptivepnp_sci_torch.parallel.mesh import make_mesh  # noqa: F401
