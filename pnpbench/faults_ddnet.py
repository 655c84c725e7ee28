"""Faults planted in the program's deep demosaicker, beside those of
``faults.py``, for the checks that ``correct`` catches them in the
deep-demosaicking cell (``pnpbench/tests/test_pnpbench_ddnet.py``; on the
card this module's command, which is ``control.py``'s with these faults
added to ``--faults``):

    python3 -m pnpbench.faults_ddnet --workload fastdvdnet_ddnet.ddnet512 \\
        --faults ddnet_on_half_the_windows,ddnet_without_neighbours,ddnet_branch2_left_out \\
        --fault-seeds 1,2

* half of the batch left out: DDnet on the first half of the frames'
  windows, the other frames passed through as their sparse RGB;
* the window gathered wrong: each frame's window holds the frame itself
  five times, so DDnet sees none of its neighbours;
* DDnet's second branch left out: the packed half-resolution RGGB U-Net
  ``temp11`` and its fusion block give zeros to ``temp2``. With the
  repository's weights the branch moves DDnet's output by about as much as
  bf16 rounding does, so only the entry's probe weights see it.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Callable


def ddnet_on_half_the_windows(patch: Callable) -> None:
    from adaptivepnp_sci_torch.ops.bayer import embed_rgb

    from pnpbench.models import fastdvdnet_ddnet

    make = fastdvdnet_ddnet.program_demosaicker

    def broken(config, params, device):
        demosaic = make(config, params, device)

        def half(mosaic):
            out = embed_rgb(mosaic)
            n = mosaic.shape[0] // 2
            out[:n] = demosaic(mosaic)[:n]
            return out

        return half

    patch(fastdvdnet_ddnet, "program_demosaicker", broken)


def ddnet_without_neighbours(patch: Callable) -> None:
    from adaptivepnp_sci_torch.solvers import priors

    indices = priors.window_indices

    def centre(b, window):
        return indices(b, window)[:, window // 2:window // 2 + 1].expand(b, window)

    patch(priors, "window_indices", centre)


def ddnet_branch2_left_out(patch: Callable) -> None:
    import torch

    from adaptivepnp_sci_torch.models.ddnet import DenBlock4ChBayer

    def zeros(self, in0, in1, in2):
        n, _, h, w = in1.shape
        return torch.zeros(n, 3, 2 * h, 2 * w, dtype=torch.float32, device=in1.device)

    patch(DenBlock4ChBayer, "forward", zeros)


DDNET = (ddnet_on_half_the_windows, ddnet_without_neighbours, ddnet_branch2_left_out)


def main(argv: list[str] | None = None) -> int:
    from pnpbench import control, faults

    faults.BY_NAME.update({f.__name__: f for f in DDNET})
    return control.main(argv)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main())
