"""The tiled FastDVDnet run's seam-band reading, the port against the JAX
package's ``two_stage_admm_tiled`` on the CPU.

``chip_smoke.py``'s ``tiled`` snapshot (the smooth scene, seed 42, 2048^2 x 8,
512 px tiles, overlap 0, ``weights/fastdvd.npz`` with adaptation) reads far
higher PSNR on the +-8 px band along the interior tile borders than on the
rest of each tile. The same holds on a 128 x 64 crop of that scene across
its first horizontal tile border (rows 448-575, columns 480-543, so the
crop's own interior border at row 64 is the scene's at row 512), as two
64 px tiles with the 8 px band: error grows towards each tile's centre,
away from its zero-padded edges. The run here is the tiled phase's schedule
in float32 with fixed weights: the card's adaptation (lr 2e-7) is shared
over groups of 4 of its 16 tiles, which two tiles cannot reproduce, and its
noise would come from each package's own generator.

Bar: the full, seam-band and interior PSNR (``measure_tile_seams.seam_psnrs``)
within 1e-4 dB of JAX's, and the result within 1e-4 in x, the float32
drivers' bar (``tests/test_torch_drivers.py``): this loop is not contractive
on the scene (``eval_weights``' sigma_max 1.13 for these weights), so it
amplifies the packages' rounding differences towards the tile centres.
"""

import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from adaptivepnp_sci_torch.measure_tile_seams import seam_psnrs
from adaptivepnp_sci_torch.models import convert as tconvert
from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet as TFastDVDnet
from adaptivepnp_sci_torch.solvers import priors as tpriors
from adaptivepnp_sci_torch.solvers import two_stage_admm as tadmm
from adaptivepnp_sci_tpu.data.synthetic import make_scene
from adaptivepnp_sci_tpu.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_tpu.solvers import ADMMConfig, GapTVConfig, gap_tv
from adaptivepnp_sci_tpu.solvers import priors as jpriors
from adaptivepnp_sci_tpu.train.trainer import load_variables_npz

#: the module (the package's ``two_stage_admm`` is the function)
jadmm = importlib.import_module("adaptivepnp_sci_tpu.solvers.two_stage_admm")
WEIGHTS = Path(__file__).resolve().parent.parent / "weights" / "fastdvd.npz"
#: the tiled phase's schedule
SCHEDULE = dict(sigma=(12 / 255, 6 / 255), iters=(24, 12), denoiser="fastdvd")
#: the crop's rows and columns in the 2048^2 scene
ROWS, COLS = slice(448, 576), slice(480, 544)
TILE, BAND = 64, 8
DB, DX = 1e-4, 1e-4


def test_seam_band_reading_matches_jax():
    sc = make_scene(b=8, h=2048, w=2048, seed=42)
    orig = sc.orig_bayer[:, ROWS, COLS].copy()
    mask = sc.mask[:, ROWS, COLS].copy()
    del sc
    meas = (orig * mask).sum(0)
    warm = np.asarray(gap_tv(jnp.asarray(meas), jnp.asarray(mask),
                             GapTVConfig(iters=40)).x_bayer)
    variables = load_variables_npz(str(WEIGHTS))

    ref = jadmm.two_stage_admm_tiled(
        jnp.asarray(meas), jnp.asarray(mask),
        ADMMConfig(**SCHEDULE), tile=TILE, prior=jpriors.fastdvd_prior(FastDVDnet()),
        variables=variables, orig_bayer=jnp.asarray(orig), x0_bayer=jnp.asarray(warm),
        overlap=0)
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the other test workers share the cores
    try:
        got = tadmm.two_stage_admm_tiled(
            meas, mask, tadmm.ADMMConfig(**SCHEDULE), tile=TILE,
            prior=tpriors.fastdvd_prior(TFastDVDnet(remat=False)),
            params=tconvert.fastdvdnet_from_flax(variables), orig_bayer=orig, x0_bayer=warm,
            overlap=0, device="cpu")
    finally:
        torch.set_num_threads(n)

    want = seam_psnrs(orig, np.asarray(ref.x_bayer), TILE, BAND)
    mine = seam_psnrs(orig, got.x_bayer.numpy(), TILE, BAND)
    dx = float(np.abs(got.x_bayer.numpy() - np.asarray(ref.x_bayer)).max())
    print(f"warm start {seam_psnrs(orig, warm, TILE, BAND)}; full / seam / interior dB: "
          f"port {mine}, JAX {want}; max |dx| {dx:.2e}")
    assert max(abs(a - b) for a, b in zip(mine, want)) <= DB and dx <= DX
    # the card's reading, on JAX's run: the band well above the interior
    assert want[1] > want[2]
