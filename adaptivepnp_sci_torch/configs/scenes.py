"""Per-scene reconstruction schedules for the 6 mid-scale benchmark scenes
(port of ``adaptivepnp_sci_tpu.configs.scenes``; the tables are copied as
they are, on the port's ``AdaptConfig`` and ``ADMMConfig``).

Transcribed verbatim from the reference scripts' hard-coded per-scene blocks —
these tables ARE the paper's reproduction recipe:
  * FFDNet:    the reference's ``two_stage_ADMM_Online_FFD_Warm.py:62-151``
  * FastDVDnet:the reference's ``two_stage_ADMM_Online_FastDVD_Warm.py:61-166``
Each scene has a plain (Malvar demosaic) and a ``deep_demosaic`` (DDnet)
variant. sigma values are /255.
"""

from __future__ import annotations

from dataclasses import dataclass

from adaptivepnp_sci_torch.adapt.online import AdaptConfig
from adaptivepnp_sci_torch.solvers.two_stage_admm import ADMMConfig

SCENE_NAMES = (
    "Beauty", "Bosphorus", "Jockey", "Runner", "ShakeNDry", "Traffic",
)


def _s(*vals: float) -> tuple[float, ...]:
    return tuple(v / 255.0 for v in vals)


@dataclass(frozen=True)
class SceneConfig:
    """One row of a reference script's table."""

    name: str
    sigma: tuple[float, ...]
    iters: tuple[int, ...]
    lr: float
    update_per_iter: int
    interval_iter: int
    update_times: int = -1


# --- FFDNet script (two_stage_ADMM_Online_FFD_Warm.py) ---------------------

FFDNET_SCENES: dict[str, dict[bool, SceneConfig]] = {
    # scene -> {deep_demosaicking: config}
    "Beauty": {
        False: SceneConfig("Beauty", _s(25, 12, 6), (15, 6, 4), 2e-6, 2, 15),
        True: SceneConfig("Beauty", _s(25, 12, 6), (6, 6, 4), 2e-6, 2, 6),
    },
    "Bosphorus": {
        False: SceneConfig("Bosphorus", _s(50, 25, 12, 6), (8, 4, 4, 4), 2e-6, 2, 8),
        True: SceneConfig("Bosphorus", _s(25, 12, 6), (4, 4, 2), 2e-6, 2, 8),
    },
    "Jockey": {
        False: SceneConfig("Jockey", _s(25, 12, 6), (16, 8, 4), 2e-6, 2, 16),
        True: SceneConfig("Jockey", _s(12, 6), (16, 8), 2e-6, 2, 16),
    },
    "Runner": {
        False: SceneConfig("Runner", _s(50, 25, 12, 6), (8, 4, 4, 4), 2e-6, 2, 8),
        True: SceneConfig("Runner", _s(25, 12, 6), (8, 8, 4), 2e-6, 2, 10),
    },
    "ShakeNDry": {
        False: SceneConfig("ShakeNDry", _s(50, 25, 12, 6), (8, 4, 4, 4), 2e-6, 2, 10),
        True: SceneConfig("ShakeNDry", _s(25, 12, 6), (8, 8, 4), 2e-6, 2, 10),
    },
    "Traffic": {
        False: SceneConfig("Traffic", _s(50, 25), (16, 8), 2e-6, 2, 16),
        True: SceneConfig("Traffic", _s(25, 12), (14, 7), 2e-6, 2, 14),
    },
}

# --- FastDVDnet script (two_stage_ADMM_Online_FastDVD_Warm.py) -------------

FASTDVD_SCENES: dict[str, dict[bool, SceneConfig]] = {
    "Beauty": {
        False: SceneConfig("Beauty", _s(8), (18,), 2e-6, 2, 9, update_times=1),
        True: SceneConfig("Beauty", _s(12, 6), (21, 2), 2e-6, 2, 22, update_times=1),
    },
    "Bosphorus": {
        False: SceneConfig("Bosphorus", _s(12, 6), (24, 12), 2e-7, 2, 12),
        True: SceneConfig("Bosphorus", _s(8, 6), (24, 12), 2e-7, 2, 25),
    },
    "Jockey": {
        False: SceneConfig("Jockey", _s(12), (24,), 2e-7, 2, 12),
        True: SceneConfig("Jockey", _s(12, 6), (24, 6), 2e-7, 2, 25),
    },
    "Runner": {
        False: SceneConfig("Runner", _s(14), (24,), 2e-7, 2, 12),
        True: SceneConfig("Runner", _s(12, 6), (40, 15), 2e-7, 2, 41),
    },
    "ShakeNDry": {
        False: SceneConfig("ShakeNDry", _s(10), (15,), 2e-7, 1, 7),
        True: SceneConfig("ShakeNDry", _s(12, 6), (14, 4), 2e-7, 1, 15),
    },
    "Traffic": {
        False: SceneConfig("Traffic", _s(30), (22,), 2e-7, 2, 11),
        True: SceneConfig("Traffic", _s(25, 12, 6), (36, 6, 2), 2e-7, 2, 43),
    },
}

#: GAP-TV warm-start budget (ADMM_TV_Warm_Start_save.py:36-37)
WARM_START_ITERS = 40

#: Rows run with the held-out-CV best-iterate guard
#: (``ADMMConfig.select_best`` + ``select_best_holdout`` — this
#: framework's extension; the schedule columns above stay verbatim).
#: With the repository's distilled FastDVDnet weights some scenes end below
#: their own GAP-TV warm start; ``denoiser_relax`` damping does not rescue
#: them, best-iterate selection does and is ground-truth-free. The raw
#: residual pins every row at its 40-iteration data-consistency warm start,
#: so iterates are ranked by held-out cross-validation with a fair
#: candidate 0 (SCENES.md and AB_RESULTS.md hold the JAX package's A/B runs).
GUARDED_ROWS: frozenset[tuple[str, str]] = frozenset(
    {(s, "fastdvd") for s in SCENE_NAMES}
)

#: held-out pixel fraction for the guard's CV ranking (A/B-validated)
GUARD_HOLDOUT = 0.05


def admm_config_for(
    scene: str,
    denoiser: str = "ffdnet",
    deep_demosaicking: bool = False,
    update: bool = True,
) -> ADMMConfig:
    """Build the solver config for a benchmark scene.

    Mirrors the reference scripts' module-level toggles ``denoiser`` / ``update`` /
    ``deep_demosaicking`` (``two_stage_ADMM_Online_FFD_Warm.py:22-26``).
    """
    table = FFDNET_SCENES if denoiser == "ffdnet" else FASTDVD_SCENES
    row = table[scene][deep_demosaicking]
    adapt = None
    if update:
        adapt = AdaptConfig(
            lr=row.lr,
            update_per_iter=row.update_per_iter,
            initial_iter=1,
            interval_iter=row.interval_iter,
            update_times=row.update_times,
        )
    return ADMMConfig(
        sigma=row.sigma,
        iters=row.iters,
        denoiser=denoiser,
        demosaic_method="ddnet" if deep_demosaicking else "malvar",
        adapt=adapt,
        select_best=(scene, denoiser) in GUARDED_ROWS,
        select_best_holdout=(
            GUARD_HOLDOUT if (scene, denoiser) in GUARDED_ROWS else 0.0
        ),
    )
