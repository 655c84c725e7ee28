#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``adaptivepnp_sci_torch``) on one
NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases build,k1,k2

It builds the CUDA kernels from ``adaptivepnp_sci_torch/csrc/``, holds each
against its plain PyTorch version on the card (both designs of the TV and
conv-pair kernels, timed side by side), holds the kernel paths
against the plain paths on the CPU end to end, and drives three 512x512x8
reconstructions: the flagship (GAP-TV warm start, two-stage ADMM with
FFDNet-color nc = 96, nb = 12 and online adaptation, random weights made
from a seed), the FastDVDnet prior path (trained weights from
``weights/fastdvd.npz``, in float32 and in bf16 with the fused conv-pair
kernel) and the deep-demosaicking row of the scene table (DDnet from
``weights/ddnet.npz`` and FastDVDnet, both in bf16, with the held-out
``select_best`` guard; also once with the demosaicker adapted in the loop).
Then the multi-measurement drivers: each held against its CPU plain path at
small size (``drivers_parity``: tiled, sequence, batched, and ``gap_deep``,
Menon 2007 and the gray solver), a 2048x2048x8 scene cut into 512 tiles
under the bf16 FastDVDnet row with its adaptation shared over the tiles
(``tiled``), and the FFDNet flagship over two measurements with a carried
Adam state (``sequence``). Then the user's entry points: the pipelines'
``run_reconstruction`` and the ground-truth-free selections held against the
CPU plain path at 64x64x8 (``pipeline_parity``), and the command-line chain
``synth`` -> ``warmstart`` -> ``reconstruct`` (FastDVDnet bf16, with and
without ``--ckpt auto --auto-demosaic``) -> ``eval`` -> ``serve`` at
512x512x8 over two measurements, run in this process (``cli``). Then the
offline training: three ``Trainer`` steps of each task (FFDNet, FastDVDnet,
DDnet) on the card against the CPU with the same draws, and the SVD
orthogonalization (``train_parity``); ``cli train`` of each network at its
published width (batch 16, 96x96 patches), ``denoise`` with the trained
FastDVDnet, and a 512x512x8 reconstruction in bf16 from the trained
checkpoint (``train``). Then the six-scene reproduction run
(``run_all_scenes.main``): the card against the CPU on the photograph scenes
at 64x64x8 (``scenes_parity``), one scene in each mode at 512x512x8 with
each row's launches against its table row (``scenes``; ``--phases
...,scenes_full`` runs every scene); and the block zoo,
FFDNet-IPOL, ``SpatialDnCNN``, ``PyramidEncoder``, the VGG19 features and
``imresize`` on the card against the CPU (``models_parity``). Then the
parallel paths of ``adaptivepnp_sci_torch.multihost_validation`` (the ring
halo, the frame-sharded FastDVDnet prior in float32 and bf16, the
data-parallel FFDNet step and FastDVDnet ``Trainer``, the solver with the
sharded prior, the tiled and batched drivers' ``mesh``) on 2 ranks sharing
the card through gloo and at world size 1 through NCCL, against each other
and the CPU plain path at 64x64x8 (``parallel_parity``); at full width on 2
ranks: the bf16 prior at 512^2, the ``tiled`` phase's 2048^2 snapshot with its
tile groups over the ranks against that phase's one-process run, a FastDVDnet
training step (``parallel``, which needs ``tiled``); and
the native ``.npy`` prefetch ring (built with g++, 1 GiB streamed) and a
``torch.profiler`` trace of a flagship step (``host``). Then the weight
tooling (``weights``): ``eval_weights`` on both shipped FastDVDnet sets,
``regenerate_weights`` of FastDVDnet and DDnet, ``harvest_iterates`` with the
bf16 student, ``distill_iterates`` and ``distill_fastdvd``, the first two
also against the CPU at 64x64x8; and ``measure_tile_seams`` at 1024^2 and,
against the CPU, at 64^2, with the seam band of the ``tiled`` snapshot
(``seams``). ``--phases ...,seams_halo`` adds that snapshot at overlap 32.
Then the A/B, sweep and decomposition tools (``studies``): each at 64x64x8
with its schedule cut on the card against the CPU's plain path, with exact
launches per tool and the same picks, FFDNet's mixed and bf16 modes among
them, and a flagship with ``use_kernels=False`` that launches no kernel;
``--phases ...,studies_full`` runs every tool once at its published size.
Then the timing drivers: ``bench.main`` (the port of ``bench.py``) in its
three modes at 512x512x8 with ``bench.py``'s FFDNet variables, timed, and at
128x128x8 against the JAX package's readings of the same calls on the CPU
(``bench``); every row of the benchmark suite and the batched sweep at 1 and
2 measurements at 64x64x8 with cut schedules, card against CPU with exact
launches, and the suite's flagship row against ``bench``'s (``suite``);
``--phases ...,suite_full`` runs the suite and the sweep at their published
sizes. ``--phases ...,profiles`` adds the ``torch.profiler`` traces of the
FastDVDnet, deep-demosaicking and training paths (the flagship's is always
taken). Each phase prints one JSON line (``t_s``: seconds since the start);
any failure exits nonzero. The last line is
``{"ok": true, "device": {...}}``. It exits 1 without printing a result when
no CUDA device is present, and fails when the package is not beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PHASES = ("device", "build", "k1", "k2", "k3", "slice_parity", "flagship",
          "fastdvd_parity", "fastdvd", "ddnet_parity", "ddnet", "drivers_parity", "tiled",
          "sequence", "pipeline_parity", "cli", "train_parity", "train", "scenes_parity",
          "scenes", "models_parity", "parallel_parity", "parallel", "host", "weights", "seams",
          "studies", "bench", "suite", "kernels")
#: phases run only when ``--phases`` names them: the tiled phase's 2048^2
#: snapshot again at overlap 32, for its seam band (~30 s); every A/B, sweep
#: and decomposition tool once at its published size (~10 min); all 24 rows
#: of the six-scene run at 512x512x8 (~55 s); the benchmark suite and the
#: batched sweep at their published sizes; and, named beside the fastdvd,
#: ddnet and train phases, their ``torch.profiler`` traces (device busy and
#: idle share; ~45 s) and the float32 FastDVDnet breakdown without
#: recomputation
EXTRA_PHASES = ("seams_halo", "studies_full", "scenes_full", "suite_full", "profiles")
#: the script's start, on the host clock (each JSON line's ``t_s``)
T0 = time.perf_counter()

#: NVIDIA H100 SXM data-sheet peaks: HBM3 bandwidth, non-tensor fp32 rate and
#: dense bf16 rate of the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
#: flops per pixel per iteration of the TV kernel: divergence 4, out 1,
#: d^2 2, gradient 2, norm 4 (with sqrt), coef 2, dual update 6, norm sum 1
TV_FLOPS_PER_PIXEL_ITER = 22
#: the flagship's launches per reconstruction: 40 GAP + 25 ADMM x-updates,
#: 40 TV proxes (one per warm-start iteration)
FLAGSHIP_LAUNCHES = {"x_update": 65, "tv_chambolle": 40, "convpair": 0}

SIGMA = (25 / 255, 12 / 255, 6 / 255)
ITERS = (15, 6, 4)

#: the FastDVDnet path: the Bosphorus row of the scene table (sigma (12, 6)/255,
#: 24 + 12 iterations, adaptation at k = 12 and 24: 2 Adam steps at lr 2e-7)
FASTDVD_SIGMA = (12 / 255, 6 / 255)
FASTDVD_ITERS = (24, 12)
FASTDVD_ADAPT = dict(lr=2e-7, update_per_iter=2, interval_iter=12, initial_iter=1)
#: its launches per reconstruction: 40 GAP + 36 ADMM x-updates, 40 TV proxes,
#: and in bf16 the 8 CvBlocks of each of the 36 no-grad denoiser calls
FASTDVD_LAUNCHES = {
    "fp32": {"x_update": 76, "tv_chambolle": 40, "convpair": 0},
    "bf16": {"x_update": 76, "tv_chambolle": 40, "convpair": 288},
}
#: the fastdvd phase's runs per scene and mode, the first a warm-up unless
#: it is the only one (the float32 row takes 7.3 s a run; the smooth scene's
#: runs warm the leaves scene's)
FASTDVD_RUNS = {("smooth", "fp32"): 2, ("smooth", "bf16"): 4, ("leaves", "fp32"): 1,
                ("leaves", "bf16"): 2}
#: the conv pair's two shapes on that path, (C, H, W) of the activation with
#: N = 8: half and quarter resolution, 4 CvBlocks per denoiser call each
CONVPAIR_MAIN_SHAPES = {"c64_256": (64, 256, 256), "c128_128": (128, 128, 128)}
#: Parity of the kernel path on the card with the plain path on the CPU at
#: 64x64x8: (iterations, launches, bar on per-frame PSNR in dB, bar on x_bayer,
#: what of x_bayer the bar holds). Float32 differs by summation order only.
#: In bf16 two routes round sums at different places (2e-3 on one denoiser
#: call), and this prior's loop amplifies any such difference once sigma drops
#: to 6/255 at k = 12: every pair of bf16 routes (kernel, library on the card,
#: CPU), and bf16 against float32 on the CPU alone, is 6e-3 apart in the worst
#: pixel (1.2e-3 rms) after 12 iterations, 0.1 after 14 and 0.15-0.25 (0.010-
#: 0.017 rms) after all 36. So bf16 is held tightly over the 12 iterations of
#: the first stage, and by rms over the whole schedule with its two triggers.
FASTDVD_PARITY = {
    "fp32": [(FASTDVD_ITERS, FASTDVD_LAUNCHES["fp32"], 0.05, 1e-3, "max")],
    "bf16": [((12, 0), {"x_update": 52, "tv_chambolle": 40, "convpair": 96}, 0.15, 2e-2, "max"),
             (FASTDVD_ITERS, FASTDVD_LAUNCHES["bf16"], 1.0, 3e-2, "rms")],
}


#: the deep-demosaicking path: ``admm_config_for("Bosphorus", "fastdvd",
#: deep_demosaicking=True)``, sigma (8, 6)/255 x (24, 12) iterations, one
#: trigger at k = 25 (2 Adam steps, lr 2e-7), rho 0.55, the held-out guard at
#: 0.05. Its launches per reconstruction: 40 warm-start + 36 ADMM + 40 masked
#: GAP-TV (the guard's candidate 0) x-updates, 40 + 40 TV proxes, and the 8
#: CvBlocks of each of the 36 no-grad bf16 FastDVDnet calls; DDnet (C = 40,
#: 80) and the trigger's forward launch no conv pair
DDNET_LAUNCHES = {"x_update": 116, "tv_chambolle": 80, "convpair": 288}
#: the ddnet phase's runs per scene, the first a warm-up unless it is the
#: only one (the smooth scene's runs warm the leaves scene's)
DDNET_RUNS = {"smooth": 3, "leaves": 1}
#: the parity run of that row at 64x64x8 in float32: schedule (6, 4), the
#: trigger at k = 5; 40 + 10 + 40 x-updates, 40 + 40 TV proxes
DDNET_PARITY_ITERS = (6, 4)
DDNET_PARITY_LAUNCHES = {"x_update": 90, "tv_chambolle": 80, "convpair": 0}
#: the pipeline's defaults for the in-scan demosaicker adaptation
DM_UPDATE = dict(lr=1e-6, update_per_iter=1)

#: the large-scene path: a 2048x2048x8 scene, its 40-iteration GAP-TV warm
#: start at full size (32 packed planes of 1024^2), then 16 tiles of 512 in 8
#: sequential groups of 2 under the bf16 FastDVDnet path's schedule, the
#: adaptation (k = 12 and 24) shared over each group's tiles and carried from
#: group to group. Launches: 40 + 8 x 36 x-updates (one launch per iteration
#: covers a group), 40 TV proxes, and 8 conv pairs per denoiser call of each
#: tile, 16 x 36 x 8
TILED = dict(size=2048, tile=512, tile_chunk=2)
TILED_LAUNCHES = {2: {"x_update": 40 + 8 * 36, "tv_chambolle": 40, "convpair": 16 * 36 * 8},
                  4: {"x_update": 40 + 4 * 36, "tv_chambolle": 40, "convpair": 16 * 36 * 8}}
#: the sequence path: the FFDNet flagship over T = 2 measurements of one
#: scene, the weights and one Adam carried; both GAP-TV warm starts counted
SEQUENCE_LAUNCHES = {"x_update": 2 * 40 + 2 * 25, "tv_chambolle": 2 * 40, "convpair": 0}
#: card-vs-CPU parity of the drivers: float32, bar on per-frame PSNR (dB) and
#: on max |dx|, the same select_best pick on both sides
DRIVERS_PARITY_BAR = (0.05, 1e-3)

#: card-vs-CPU parity of ``pipelines.run_reconstruction`` at 64x64x8 over 2
#: measurements (the FFDNet flagship schedule, adaptation on, weights carried):
#: bar on per-frame PSNR (dB), on max |dx_bayer| and on the carried weights'
#: gap (in units of the adaptation lr)
PIPELINE_PARITY_BAR = (1e-5, 1e-5, 0.05)
#: the selections' held-out residuals, card vs CPU: relative bar
PIPELINE_RESID_RTOL = 1e-4
#: its runs, each with the GAP-TV warm start inline: per measurement 40 + 25
#: x-updates and 40 TV proxes; tiled (4 windows of 48), one x-update launch
#: per step covers all tiles
PIPELINE_PARITY_RUNS = {"reuse_model": {}, "tiled": dict(tile=32, tile_overlap=8)}
PIPELINE_PARITY_LAUNCHES = {"x_update": 2 * 65, "tv_chambolle": 2 * 40, "convpair": 0}

#: the CLI chain at 512x512x8 over 2 measurements (``synth --n-meas 2``),
#: FastDVDnet in bf16 on the Bosphorus rows, every row guarded (held-out
#: select_best: 40 masked GAP-TV x-updates and TV proxes per measurement).
#: Per subcommand: warmstart 2 x 40 GAP-TV steps; reconstruct from the warm
#: start file, 36 ADMM + 40 masked GAP-TV x-updates a measurement and 8 conv
#: pairs per no-grad denoiser call (288 a measurement); with --ckpt auto and
#: --auto-demosaic first 2 + 2 fixed-weight 36-iteration probe solves of the
#: first measurement (guard and adaptation stripped); serve, 2 files of 2
#: measurements, each with its GAP-TV warm start inline. Then one leaves
#: measurement (``synth --style leaves``), where the guard is expected to pick
#: an ADMM iterate: its warm start (40 GAP-TV steps) and the deep-demosaicking
#: row from that file (36 ADMM + 40 masked GAP-TV x-updates, 288 conv pairs)
CLI_N_MEAS = 2
CLI_SIZE = 512
CLI_LAUNCHES = {
    "synth": {"x_update": 0, "tv_chambolle": 0, "convpair": 0},
    "warmstart": {"x_update": 2 * 40, "tv_chambolle": 2 * 40, "convpair": 0},
    "reconstruct": {"x_update": 2 * 76, "tv_chambolle": 2 * 40, "convpair": 2 * 288},
    "reconstruct_auto": {"x_update": 4 * 36 + 2 * 76, "tv_chambolle": 2 * 40,
                         "convpair": 4 * 288 + 2 * 288},
    "eval": {"x_update": 0, "tv_chambolle": 0, "convpair": 0},
    "serve": {"x_update": 4 * 116, "tv_chambolle": 4 * 80, "convpair": 4 * 288},
    "synth_leaves": {"x_update": 0, "tv_chambolle": 0, "convpair": 0},
    "warmstart_leaves": {"x_update": 40, "tv_chambolle": 40, "convpair": 0},
    "reconstruct_leaves": {"x_update": 76, "tv_chambolle": 40, "convpair": 288},
}


#: card-vs-CPU parity of the trainer: 3 steps of each task at 32x32, batch 2,
#: from the same weights (FastDVDnet's and DDnet's of ``weights/``, FFDNet's
#: in Flax's scheme) with the same draws (a CPU generator on both sides),
#: steps_per_epoch 1 and milestones (0, 1), so the updates run at lr, lr/10,
#: lr/1000; float32, TF32 off. The first step is the numerical parity of a
#: step: its loss (relative) and its gradients (per tensor, against the
#: tensor's largest entry). The three-step trajectory is held looser: Adam
#: moves a weight whose gradient is near zero by about +-lr whatever the size
#: of that gradient, so where two summation orders give such a gradient
#: different signs the weights part by up to 2 lr; on FastDVDnet's trained
#: weights that is a ten-thousandth of them (on an H100 at 700 W: 1.7e-4 at
#: most, 9e-6 of the weights beyond 1e-4, the third loss 1.3e-4 apart). Bars
#: on the trajectory: losses (relative), all but a thousandth of the weights
#: within a tenth of an Adam step at lr 1e-3 and every one within steps x lr,
#: BatchNorm statistics (relative to the collection's largest entry). The
#: SVD orthogonalization, which amplifies such differences further, is held
#: alone, on FastDVDnet's convs (absolute). (At PyTorch's initialisation the
#: gradients of FastDVDnet's bottom blocks are ill-conditioned: a 32x32
#: float32 step on the CPU is 2.8e-2 from float64 in ``temp1.upc2``.)
TRAIN_PARITY = dict(steps=3, patch=32, batch=2, lr=1e-3)
TRAIN_PARITY_BAR = {"step1_loss_rel": 1e-5, "step1_grad_rel": 1e-4, "loss_rel": 1e-3,
                    "params_abs": 1e-4, "params_frac_over": 1e-3, "stats_rel": 1e-4,
                    "svd_abs": 1e-5}
#: the training chain at full width through ``cli.main`` (``train --batch 16
#: --patch 96`` at the published widths: steps per network), a 5-step warm-up
#: before the timed steps; then ``denoise`` of the trained FastDVDnet, and one
#: 512x512x8 measurement (``synth``, ``warmstart``) reconstructed on the bf16
#: Bosphorus row from the trained ``final.pt``. FastDVDnet takes 100 steps:
#: after 40 its eval-mode output beats the noisy input by only 0.3 dB (this
#: cell on the CPU; 100 steps: 3.4 dB), inside the spread of the draws
TRAIN_STEPS = {"fastdvd": 100, "ffdnet": 20, "ddnet": 20}
TRAIN_BATCH, TRAIN_PATCH, TRAIN_WARMUP = 16, 96, 5
TRAIN_SCENE = 512
#: launches per step of that chain: training runs the library's convolutions
#: (train-mode BatchNorm is not folded) and the float32 denoise too; the warm
#: start 40 GAP-TV steps; the guarded solve from the warm-start file 36 ADMM +
#: 40 masked GAP-TV x-updates, 40 TV proxes and 8 conv pairs per no-grad bf16
#: denoiser call (36 calls)
_NONE = {"x_update": 0, "tv_chambolle": 0, "convpair": 0}
TRAIN_LAUNCHES = {
    "train_fastdvd": _NONE, "train_ffdnet": _NONE, "train_ddnet": _NONE, "denoise": _NONE,
    "synth": _NONE,
    "warmstart": {"x_update": 40, "tv_chambolle": 40, "convpair": 0},
    "reconstruct": {"x_update": 76, "tv_chambolle": 40, "convpair": 288},
}

#: the six-scene reproduction run (``run_all_scenes.main``): card vs CPU on the
#: photograph stand-ins at 64x64x8 (Beauty in the ffd mode, Runner in
#: fastdvd-dd) over 2 measurements, float32 (FastDVDnet and
#: DDnet from ``weights/``, FFDNet from PyTorch's seeded init), held to
#: ``PIPELINE_PARITY_BAR`` in warm and final dB and in x, with the same picks
#: (FastDVDnet's adaptation noise on: ``run_reconstruction`` draws it from a
#: CPU generator, the same draws on both sides); then one scene in each mode
#: at 512x512x8 (``scenes_full``: every scene), one measurement (the script's
#: two cut to one for time: the carry across measurements is the ``cli``
#: phase's and the CPU tests'), FastDVDnet and DDnet in bf16 on ``weights/``,
#: the FFDNet modes with ``random_init`` (no FFDNet checkpoint exists, so their
#: dB measure nothing: they give times and launches)
SCENES_PARITY = dict(scenes={"ffd": ["Beauty"], "fastdvd-dd": ["Runner"]}, b=8, size=64,
                     n_meas=2)
SCENES = dict(b=8, size=512, n_meas=1)
#: the default run's scene per mode (one row each, of the three styles:
#: leaves, textured, photograph; Runner's fastdvd-dd row is the one that
#: departs from ``SCENES.md``); the named-only ``scenes_full`` runs all 24
SCENES_DEFAULT = {"ffd": "Jockey", "fastdvd": "Bosphorus", "ffd-dd": "Beauty",
                  "fastdvd-dd": "Runner"}
#: the block zoo, FFDNet-IPOL, SpatialDnCNN, PyramidEncoder, VGG features and
#: imresize on the card vs the CPU: bar on each
#: output against its largest magnitude (float32, TF32 off); their times at
#: full width
MODELS_PARITY_REL = 1e-5

#: the parallel paths (``adaptivepnp_sci_torch.multihost_validation``'s cases
#: at 64x64x8, the tiled ones at 128^2 in tiles of 64) on 2 ranks sharing the
#: card through gloo with CUDA tensors, and at world size 1 through NCCL (two
#: NCCL ranks cannot share a card). Each rank's results are held to the NCCL
#: run's (the same call at world size 1) and to the CPU plain path's, in units
#: of the larger of 1 and the array's largest magnitude
#: (``multihost_validation.compare``); the bf16 prior to bf16's bar. The DP
#: FFDNet step's weights (Adam at lr 1e-3, one step) are held like
#: ``TRAIN_PARITY``'s: a weight whose gradient is near zero can step +-lr on
#: one side and -+lr on the other, so all but a thousandth within a tenth of
#: lr and every one within 2 lr.
#: The adaptation loss's gradients (``frame_loss_grad``: FastDVDnet's 2.5M
#: weights through 8 frames of 64^2) on the card against the CPU's: the norm
#: of the difference over the CPU gradient's (elementwise they part by
#: 1.8e-4 of the largest on an H100); against world size 1, on the
#: same card, elementwise like every other array.
PARALLEL_PARITY_BAR = {"world1": 1e-5, "cpu": 1e-4, "bf16": 2e-2, "dp_lr": 1e-3,
                       "cpu_grad_rel_norm": 1e-3}
_K = ("x_update", "tv_chambolle", "convpair")


def _launches(x_update: int = 0, tv_chambolle: int = 0, convpair: int = 0) -> dict:
    return {"x_update": x_update, "tv_chambolle": tv_chambolle, "convpair": convpair}


#: launches of each case: (each of the 2 ranks, the world-size-1 run). K1 one
#: launch per ADMM iteration on every rank, for all of the rank's tiles or
#: measurements (the solver: 3 iterations from the adjoint; tiled: 5; the
#: guarded tiled run: 40 warm-start x-updates and TV proxes, then 2 groups of
#: 10 iterations and the guard's 40-step masked GAP-TV; tiled with DDnet and
#: batched: 2). K3 in the bf16 prior only: 8 conv pairs per call on each rank's
#: own frames, calls at B = 8 in both forms and at B = 2 in the shared-triplet
#: form (the world-size-1 run adds B = 2 in the per-window form)
PARALLEL_PARITY_LAUNCHES = {
    **{c: (_launches(), _launches()) for c in ("halo", "too_many_shards", "prior",
                                                "prior_grad", "dp_step", "trainer")},
    "prior_bf16": (_launches(convpair=24), _launches(convpair=32)),
    "solver": (_launches(3), _launches(3)), "solver_adapt": (_launches(3), _launches(3)),
    "tiled": (_launches(5), _launches(5)),
    "tiled_guard": (_launches(40 + 2 * 50, 40 + 2 * 40), _launches(40 + 2 * 50, 40 + 2 * 40)),
    "tiled_dm": (_launches(2), _launches(2)), "batched": (_launches(2), _launches(2)),
    # the frame-sharded solve: each rank's x-update in its split form, two
    # launches where one process makes one (ADMM-TV 3 iterations and a
    # 5-iteration GAP-TV; FFDNet 5; FastDVDnet 3; FastDVDnet adapting: a
    # 10-iteration warm start, the guard's 10-iteration masked one and 6; DDnet
    # 2; the dispatch's 10-iteration warm start and 5; gap_deep 3); the TV
    # prox on the rank's planes, the gray solver's on its frames (5 plain, 5
    # accelerated); the refusals' DDnet solve raises after its first
    # x-update; the batched driver's 4 measurements over data = 2 run 3 + 3 +
    # 2 iterations each, the fused form
    "frame_tv": (_launches(16, 8), _launches(8, 8)),
    "frame_ffdnet": (_launches(10), _launches(5)),
    "frame_fastdvd": (_launches(6), _launches(3)),
    "frame_fastdvd_adapt": (_launches(52, 20), _launches(26, 20)),
    "frame_ddnet": (_launches(4), _launches(2)),
    "frame_dispatch": (_launches(30, 10), _launches(15, 10)),
    "frame_gap_deep": (_launches(6), _launches(3)),
    "frame_gray": (_launches(0, 10), _launches(0, 10)),
    "frame_loss_grad": (_launches(), _launches()),
    "frame_loss_grad_all_reduce_sum": (_launches(), _launches()),
    "frame_refusals": (_launches(2), _launches()),
    "batched_adapt": (_launches(16), _launches(32)),
}
#: full width on 2 ranks (gloo, one card): the bf16 prior on 8 frames of 512^2
#: split over a frame axis of 2 (a warm-up, 5 timed calls and a profiled one:
#: 8 conv pairs per call on each rank); the ``tiled`` phase's 2048^2 snapshot with
#: ``tile_chunk=4`` and its groups split over a data axis of 2 (each rank: the
#: full-size warm start's 40 x-updates and TV proxes, one x-update per
#: iteration for its 2 tiles of each group, 8 conv pairs per denoiser call of
#: each of its 8 tiles: K3 over the ranks sums to the one-process 4608); a
#: FastDVDnet training step at batch 16 x 96^2 over a frame axis of 2. The
#: tiled run is timed once, after a warm-up on a 1024^2 scene (one group of
#: the same 4 tiles: the same kernels and shapes) whose collectives are
#: profiled
PARALLEL_LAUNCHES = {"prior_full": _launches(convpair=7 * 8),
                     "tiled_full": _launches(40 + 4 * 36, 40, 8 * 36 * 8),
                     "train_full": _launches(),
                     # a snapshot over frame = 2, each rank: the split x-update's
                     # 2 launches for each of the 40 warm-start and the ADMM
                     # iterations, the TV prox on its 16 planes, 8 conv pairs
                     # per bf16 denoiser call on its 4 frames
                     "frame_flagship_full": _launches(2 * (40 + 25), 40),
                     "frame_fastdvd_full": _launches(2 * (40 + 36), 40, 36 * 8),
                     "frame_fastdvd_fixed_full": _launches(2 * (40 + 36), 40, 36 * 8),
                     "frame_fastdvd_fp32_full": _launches(2 * (40 + 36), 40)}
#: the 2-rank snapshot against the one-process ``tiled`` run (tile_chunk 4):
#: per-frame PSNR (dB), and the adaptation's weight change as a fraction of
#: the one-process change (``||w_rank - w_one|| / ||w_one - w_start||``). A
#: sound 2-rank run read 0.0 dB and bit-identical weights; a run adapting in
#: another direction (the one-process run with tile_chunk 2 against 4) read
#: 0.028 dB, and its weight fraction is printed beside each run
#: (``wrong_run``). Adam moves a weight by about its lr whatever the
#: gradient's size, so a summation order that flips a near-zero gradient's
#: sign parts single weights by 2 lr a step; a fraction of the norm holds the
#: direction and leaves room for such weights
PARALLEL_TILED_DB = 1e-3
PARALLEL_TILED_DW_FRACTION = 1e-3
#: the frame-sharded 512^2 snapshots against the one-process runs of the
#: ``flagship`` and ``fastdvd`` phases (which ``parallel`` needs), at the tiled
#: snapshot's bars: the FFDNet flagship, the float32 FastDVDnet row, and the
#: bf16 row without adaptation (against a one-process run made here). The
#: bf16 row with adaptation cannot hold them: each rank's adaptation gradient
#: is its frames' share, rounded to bf16 by the convolutions' backward
#: before the ranks sum it, where one process rounds the whole sum once; the
#: weights part, and the bf16 loop amplifies any difference
#: (``FASTDVD_PARITY``). It is held to the bf16 routes' bar of
#: ``FASTDVD_PARITY`` (1.0 dB per frame, rms |dx| 3e-2), its distances printed
PARALLEL_FRAME_DB = 1e-3
PARALLEL_FRAME_DW_FRACTION = 1e-3
#: The float32 FastDVDnet row's weights are held weight by weight to Adam's
#: opposite-sign bound, 2 lr a step (lr 2e-7, 4 steps): its 2.5M weights hold
#: more near-zero gradients whose sign a summation order flips than the
#: flagship's 0.85M, and their distance read 1.09e-3 of the adaptation's
#: change on an H100, above PARALLEL_FRAME_DW_FRACTION; it is printed
PARALLEL_FRAME_FP32_DW = 2 * 2e-7 * 4
#: the weight tooling. ``eval_weights`` on both shipped FastDVDnet sets at
#: 512^2: the 40-iteration warm start once (K1 and K2 40 each), then each
#: set's 36 ADMM x-updates (float32 FastDVDnet: no conv pair; the Jacobian's
#: power iteration and the standalone call run no kernel); the same on the
#: card and the CPU at 64^2, each set's standalone and in-loop dB within
#: ``db`` and its sigma_max within ``sigma_max_rel`` of the CPU's (the
#: adaptation noise comes from a CPU generator on both)
WEIGHT_SETS = ("weights/fastdvd.npz", "weights/fastdvd_smooth.npz")
EVAL_WEIGHTS_LAUNCHES = _launches(40 + 36 * len(WEIGHT_SETS), 40)
EVAL_WEIGHTS_PARITY = {"db": 0.05, "sigma_max_rel": 1e-3}
#: ``regenerate_weights`` of FastDVDnet and DDnet at their published widths
#: (batch 32 of 64x64 crops of 256 and 512 px videos); training runs no kernel
REGEN = dict(steps=3, n_clips=64)
#: ``harvest_iterates`` on one style and seed at 512^2, the teacher (this
#: script's Flax-scheme FFDNet, numpy seed 0) and the bf16 student
#: (``weights/fastdvd.npz``): the warm start, 32 x-updates a loop, the
#: student's 8 conv pairs a call (4 at each main-path shape); card vs CPU at
#: 64^2: the teacher loop's crops (float32) within ``teacher`` of the largest
#: magnitude, the student's (bf16, the loop feeding its rounding back) to the
#: bf16 routes' rms bar (``FASTDVD_PARITY``)
HARVEST = dict(size=512, styles=("leaves",), seeds=(11,))
HARVEST_LAUNCHES = _launches(40 + 2 * 32, 40, 8 * 32)
HARVEST_PARITY = {"teacher": 1e-4, "student_rms": 3e-2}
#: ``measure_tile_seams`` at its defaults (1024^2, tile 512, band 8): the
#: warm start on the whole scene (K2 on 512^2 planes), then per solve (two
#: per overlap 0, 16, 32) one x-update an iteration for the 4 tiles
SEAMS_LAUNCHES = _launches(40 + 6 * 25, 40)
#: the table at 64^2 (32 px tiles, overlaps 0 and 16: the CPU's time grows
#: with the halo) on the card and the CPU: each overlap's full, seam-band and
#: interior dB within ``SEAMS_PARITY_DB`` (the fixed-weight float32 FFDNet loop)
SEAMS_SMALL = dict(h=64, tile=32, band=8, overlaps=(0, 16))
SEAMS_PARITY_DB = 1e-3
#: host plumbing: ~1 GiB of .npy clips streamed through the native ring
HOST_NPY = dict(files=64, shape=(4, 1024, 1024))
#: the A/B, sweep and decomposition tools (``studies``): each at 64x64x8 with
#: its schedule cut (the flagship's to (2, 1, 1), the FastDVDnet row's to
#: (2, 1), each with a trigger at k = 2; the scene tables' stages to at most
#: 2 iterations), one scene or style of each table, FFDNet narrowed to nc 16,
#: nb 4 (``slice_parity``'s), a warm-up and one timed run (n = 0); the card
#: against the CPU's plain path, launches per tool as ``studies_launches``
#: works them out. Every solve a tool reports is held by its per-frame mean
#: dB and by its x: float32 solves by the worst pixel (``STUDIES_F32``);
#: solves through bf16 FFDNet or DDnet (``STUDIES_BF16``) by the rms and
#: the worst pixel; solves through bf16 FastDVDnet (``STUDIES_BF16_LOOP``,
#: whose cut schedule reaches sigma 6/255 at k = 2, where the loop amplifies
#: bf16 rounding: ``FASTDVD_PARITY``) by the rms. One sum that rounds to the
#: neighbouring bf16 value moves a pixel by a bf16 step (3.9e-3 on [0.5,
#: 1)), and the loop carries it on, as far as the mode itself moves x: no
#: loop-level bar in x tells bf16 from float32, and the line prints what a
#: float32 run would read (``float32_reads``: the card's float32 row
#: against the CPU's reduced one) beside it. What shows that the reduced
#: modes ran is one FFDNet apply at colour width (nc 96, nb 12;
#: ``STUDIES_APPLY``) per mode, card against CPU (the reduced modes at the
#: CPU parity test's max and mean |dx| bars), with the types of every
#: convolution's input on the card, and the bf16 conv pair's launches for
#: FastDVDnet. Held-out residuals within ``STUDIES_RESID_REL`` (``_LOOP``
#: through bf16 FastDVDnet), and a pick held to the CPU's where its two
#: statistics differ by more than that; sigma_max and the teacher-student
#: distance within ``STUDIES_SIGMA_REL``. Every bar is a small multiple of
#: the largest reading on the card (2.2x to 16x; the apply's reduced modes
#: 1.2x to 1.4x, where the float32 reading sits 1.6x above). Every tool is
#: compared and reported before the phase
#: fails on any of them
STUDIES = dict(size=64, nc=16, nb=4, flag_iters=(2, 1, 1), fastdvd_iters=(2, 1), cut=2,
               interval=2, cv_pair=(202, "textured"), select_style="smooth",
               demosaic_scene="Jockey", relax_scene="Bosphorus", combos=("2:", "2:16"),
               clips=32)
#: a solve's per-frame mean dB, and the max or rms of its x. On the card
#: (H100, 700 W) the float32 rows read <= 3.8e-6 dB (one float32 step at
#: 30 dB) and <= 9.4e-6 in x (FastDVDnet adapting; FFDNet <= 8e-7); the
#: bf16 FFDNet and DDnet rows <= 8.3e-5 dB, 7.5e-4 rms and 5.8e-3 max (a
#: float32 run reads 9.5e-6 to 7.6e-4 dB, 5.3e-4 to 8.4e-4 rms and 4.2e-3
#: to 7.6e-3 max there); the bf16 FastDVDnet loops <= 7.1e-3 dB and 5.7e-3
#: rms (a float32 run: 0.42 dB, 5.4e-3 rms)
STUDIES_F32 = {"db": 2e-5, "max": 3e-5}
STUDIES_BF16 = {"db": 3e-4, "rms": 2e-3, "max": 1.5e-2}
STUDIES_BF16_LOOP = {"db": 3e-2, "rms": 1.5e-2}
#: FFDNet-color, one apply of 1x64x64x3 at sigma 25/255 per mode: max, mean
#: |dx| (the card read 6.3e-8 / 1.1e-8, 2.2e-4 / 3.6e-5 mixed and 2.6e-4 /
#: 4.1e-5 bf16; its float32 apply against the CPU's mixed and bf16 ones
#: 3.7e-4 / 6.4e-5 and 3.3e-4 / 6.9e-5)
STUDIES_APPLY = {"fp32": (1e-6, 1e-7), "mixed": (3e-4, 5e-5), "bf16": (3e-4, 5e-5)}
#: relative; read 1.5e-4 (DDnet probe), 1.35e-2 through bf16 FastDVDnet, and
#: 7.5e-8 for sigma_max
STUDIES_RESID_REL = 1e-3
STUDIES_RESID_REL_LOOP = 3e-2
STUDIES_SIGMA_REL = 1e-6
#: ``bench_2048_adaptive``'s combinations in ``studies_full``: its two
#: defaults and all 16 tiles at once, which the JAX docstring reports out of
#: memory on the TPU
STUDIES_FULL_COMBOS = ("4:", "4:256", "16:")

#: the timing drivers (``bench``): ``bench.main``'s three modes at bench.py's
#: 512x512x8 (FFDNet-color with bench.py's fallback variables,
#: ``adaptivepnp_sci_torch/weights/ffdnet_color_init0.npz``), timed; and the
#: same calls at 128x128x8, where JAX's readings on the CPU are known (full
#: width is not run on a CPU here): each mode's mean per-frame PSNR, and the
#: flagship's on the dead-leaves scene, from
#: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_bench.py -m slow -s``
#: (``test_bench_jax_readings``, which holds these constants to JAX's calls)
BENCH_SIZE = 512
BENCH_JAX_SIZE = 128
BENCH_JAX_DB = {"warmstart": 45.195836544036865, "fixed": 5.754814863204956,
                "flagship": 5.760444521903992, "flagship_natural": 5.68152129650116}
#: the card's readings against JAX's: the first on the card (H100, 700 W)
#: read at most 5.2e-6 dB (the warm start; the flagship 1.2e-7, on leaves
#: 1.3e-6), so the bar, first the north star's 0.1 dB, is 3e-5
BENCH_JAX_BAR_DB = 3e-5
#: launches of one reconstruction per mode (warmstart: 40 GAP-TV iterations
#: and one ADMM-TV step, each an x-update and a TV prox)
BENCH_LAUNCHES = {"flagship": FLAGSHIP_LAUNCHES, "fixed": FLAGSHIP_LAUNCHES,
                  "warmstart": {"x_update": 41, "tv_chambolle": 41, "convpair": 0}}
#: the suite (``suite``): every row of ``run_benchmark_suite`` and
#: ``bench_batched`` at 1 and 2 measurements, at ``STUDIES``' size, FFDNet
#: width and cut schedules, once each (``n = 0``), the card against the CPU's
#: plain path: float32 rows at ``STUDIES_F32``, DDnet in bf16 at
#: ``STUDIES_BF16``, FastDVDnet in bf16 at ``STUDIES_BF16_LOOP``; and row 4
#: uncut at 512^2 against the ``bench`` flagship's reading (the same call)
SUITE_BATCHES = (1, 2)
SUITE_BF16 = {"5a", "5c"}
SUITE_BF16_LOOP = {"3", "3b"}
SUITE_ROW4_DB = 1e-3


def scenes_launches(name: str, mode: str, n_meas: int, lowp: bool) -> dict:
    """K1/K2/K3 launches of one row of the six-scene run, worked out from the
    scene's ``admm_config_for`` row: per measurement one x-update per ADMM
    iteration; on a guarded row (every FastDVDnet row) the 40 x-updates and 40
    TV proxes of the guard's masked GAP-TV; with bf16 FastDVDnet the 8 conv
    pairs of each iteration's no-grad denoiser call. The warm start (40 + 40
    per measurement) is counted apart."""
    from adaptivepnp_sci_torch.configs.scenes import admm_config_for
    from adaptivepnp_sci_torch.run_all_scenes import MODES

    denoiser, deep_dd = MODES[mode]
    cfg = admm_config_for(name, denoiser, deep_dd, True)
    iters, guard = sum(cfg.iters), 40 if cfg.select_best else 0
    pairs = 8 * iters if lowp and denoiser == "fastdvd" else 0
    return {"x_update": n_meas * (iters + guard), "tv_chambolle": n_meas * guard,
            "convpair": n_meas * pairs}


def studies_launches(tool: str) -> dict:
    """K1/K2/K3 launches of one tool of the ``studies`` phase on the card,
    worked out from its runs: every timed row is two runs (the warm-up and
    the final one, n = 0); a 40-iteration GAP-TV warm start is 40 + 40; a
    solve of T iterations T x-updates, and with the held-out guard its
    masked GAP-TV 40 + 40; bf16 FastDVDnet 8 conv pairs an iteration (the
    trigger's forward needs a gradient and runs the plain pair); float32
    FastDVDnet, FFDNet and DDnet none; ``use_kernels=False`` arms none."""
    from adaptivepnp_sci_torch import bench_2048_adaptive
    from adaptivepnp_sci_torch.configs.scenes import (
        FASTDVD_SCENES,
        FFDNET_SCENES,
        admm_config_for,
    )

    def cut(iters):
        return sum(min(n, STUDIES["cut"]) for n in iters)

    def add(*runs):
        return {k: sum(r[k] for r in runs) for k in _K}

    tf, td, w = sum(STUDIES["flag_iters"]), sum(STUDIES["fastdvd_iters"]), 40
    warm = _launches(w, w)
    flag_run = _launches(w + tf, w)

    def fd_solve(it, guard=False, pairs=True):
        return _launches(it + w * guard, w * guard, 8 * it * pairs)

    if tool == "ab_ffdnet_precision":
        return add(*[flag_run] * 6)
    if tool == "ab_kernels_adapt":
        return add(warm, warm, *[flag_run] * 8, *[_launches(w + td, w)] * 4)
    if tool == "decompose_flagship_floor":
        return add(*[flag_run] * 3)
    if tool == "decompose_fastdvd_floor":
        return add(_launches(convpair=8 * td), _launches(w + td, w), _launches(w + td, w, 8 * td))
    if tool == "bench_fastdvd_bf16":
        return add(*[_launches(w + td, w)] * 2, *[_launches(w + td, w, 8 * td)] * 2)
    if tool == "ab_ddnet_precision":
        return add(*[flag_run] * 8)
    if tool == "ab_cv_guard":
        return add(warm, fd_solve(td), fd_solve(td), fd_solve(td, guard=True))
    if tool == "ab_weight_select":
        t = cut(FASTDVD_SCENES["Beauty"][False].iters)
        return add(warm, *[fd_solve(t)] * 4)
    if tool == "ab_demosaic_select":
        rows = FFDNET_SCENES[STUDIES["demosaic_scene"]]
        return add(warm, *[_launches(cut(rows[False].iters) + cut(rows[True].iters))] * 2)
    if tool == "sweep_fastdvd_relax":
        t = cut(admm_config_for(STUDIES["relax_scene"], "fastdvd").iters)
        return add(warm, *[fd_solve(t)] * 4, fd_solve(t, guard=True))
    if tool == "sweep_fidelity":
        return _launches(w + td, w, 8 * td)
    if tool == "bench_2048_adaptive":
        tile = min(bench_2048_adaptive.TILE, STUDIES["size"] // 2)
        groups = (STUDIES["size"] // tile) ** 2 // 2
        return add(warm, *[_launches(groups * tf)] * (2 * len(STUDIES["combos"])))
    if tool == "diag_teacher_sigma":
        return _launches()
    if tool == "eval_teacher_inloop":
        return add(warm, _launches(td))
    raise KeyError(tool)


def suite_launches(key: str) -> dict:
    """K1/K2/K3 launches of one row of the ``suite`` phase on the card (one
    run each; row 1 also its metrics run), worked out from the rows: a
    40-iteration GAP-TV warm start 40 + 40 per measurement; a solve of T
    iterations T x-updates (the batched and tiled drivers one launch a step
    for all measurements or tiles); bf16 FastDVDnet 8 conv pairs an
    iteration; ``"t1"``, ``"t2"``: ``bench_batched`` at 1 and 2 measurements."""
    from adaptivepnp_sci_torch import run_benchmark_suite as suite

    cfg = suite.suite_configs(STUDIES["cut"], STUDIES["interval"])
    w = 40
    if key == "1":
        return _launches(2 * w, 2 * w)
    if key in ("t1", "t2"):
        t = int(key[1])
        return _launches(t * w + sum(cfg["2"].iters), t * w)
    it = sum(cfg[key].iters)
    if key == "5b":
        return _launches(suite.N_BATCHED * w + it, suite.N_BATCHED * w)
    return _launches(w + it, w, 8 * it if key in SUITE_BF16_LOOP else 0)


class SmokeFailure(RuntimeError):
    pass


def _flat_variables(variables: dict) -> np.ndarray:
    """The floating-point entries of a state dict, by sorted key, as one
    float32 vector (the order of ``multihost_validation``'s results)."""
    return np.concatenate([variables[k].reshape(-1).float().cpu().numpy()
                           for k in sorted(variables) if variables[k].is_floating_point()])


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "t_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def quiet(run):
    """``run()``'s result and what it printed."""
    with contextlib.redirect_stdout(io.StringIO()) as text:
        out = run()
    return out, text.getvalue()


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def flagship_breakdown(torch, sc, prior, params) -> dict:
    """Device time of the flagship's parts, each alone at the flagship's
    shapes (CUDA events, median): the whole warm start, one FFDNet forward,
    one Malvar demosaic, one adaptation trigger; and what TF32 would change
    in one FFDNet forward."""
    from adaptivepnp_sci_torch.ab_convpair import time_ms
    from adaptivepnp_sci_torch.adapt.online import AdaptConfig, make_adapt_fn
    from adaptivepnp_sci_torch.ops import bayer, demosaic
    from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, gap_tv
    from adaptivepnp_sci_torch.solvers.priors import working_copy
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32

    dev = torch.device("cuda")
    y = torch.from_numpy(sc.meas).to(dev)
    phi = torch.from_numpy(sc.mask).to(dev)
    orig = torch.from_numpy(sc.orig_bayer).to(dev)
    rgb = torch.from_numpy(sc.orig_rgb).to(dev)
    sigma = torch.tensor(25 / 255, device=dev)
    net = working_copy(prior, params, dev)
    adapt = make_adapt_fn(prior, AdaptConfig(lr=2e-6, update_per_iter=2))
    y_p, phi_p = bayer.pack(y), bayer.pack(phi)
    with full_f32(), torch.no_grad():
        out = {
            "warm_start_40_ms": time_ms(
                lambda: gap_tv(y, phi, GapTVConfig(iters=40), device=dev), n=3),
            "ffdnet_forward_ms": time_ms(lambda: net(rgb, sigma), n=5),
            "malvar_ms": time_ms(lambda: demosaic.malvar2004(orig), n=5),
            "adapt_trigger_ms": time_ms(
                lambda: adapt(net, rgb, sigma, y_p, phi_p, y, phi), n=3),
        }
        ref = net(rgb, sigma)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            out["ffdnet_forward_tf32_ms"] = time_ms(lambda: net(rgb, sigma), n=5)
            out["ffdnet_tf32_max_abs_delta"] = float((net(rgb, sigma) - ref).abs().max())
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return out


def fastdvd_breakdown(torch, sc, params, dtype, remat: bool) -> dict:
    """Device time of the FastDVDnet path's parts in one mode, each alone at
    512x512x8 (CUDA events, median): one no-grad denoiser call, one
    adaptation trigger (2 Adam steps), and the trigger's peak memory."""
    from adaptivepnp_sci_torch import AdaptConfig, FastDVDnet, fastdvd_prior
    from adaptivepnp_sci_torch.ab_convpair import time_ms
    from adaptivepnp_sci_torch.adapt.online import make_adapt_fn
    from adaptivepnp_sci_torch.ops import bayer
    from adaptivepnp_sci_torch.solvers.priors import working_copy
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32

    dev = torch.device("cuda")
    y = torch.from_numpy(sc.meas).to(dev)
    phi = torch.from_numpy(sc.mask).to(dev)
    rgb = torch.from_numpy(sc.orig_rgb).to(dev)
    sigma = torch.tensor(12 / 255, device=dev)
    prior = fastdvd_prior(FastDVDnet(dtype=dtype, remat=remat))
    net = working_copy(prior, params, dev)
    adapt = make_adapt_fn(prior, AdaptConfig(**FASTDVD_ADAPT))
    gen = torch.Generator(device=dev).manual_seed(0)
    y_p, phi_p = bayer.pack(y), bayer.pack(phi)
    with full_f32(), torch.no_grad():
        out = {"denoiser_forward_ms": time_ms(lambda: prior.apply(net, rgb, sigma), n=5)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out["adapt_trigger_ms"] = time_ms(
            lambda: adapt(net, rgb, sigma, y_p, phi_p, y, phi, gen), n=3)
        out["adapt_trigger_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return out


def ddnet_breakdown(torch, sc, ddnet_params, row) -> dict:
    """Device time of the deep-demosaicking row's own parts at 512x512x8
    (CUDA events, median): one bf16 DDnet demosaic call (and one in float32),
    and the guard's masked 40-iteration GAP-TV."""
    from adaptivepnp_sci_torch import DDnet, ddnet_demosaic
    from adaptivepnp_sci_torch.ab_convpair import time_ms
    from adaptivepnp_sci_torch.ops import bayer, physics
    from adaptivepnp_sci_torch.solvers.gap_tv import GapTVConfig, _gap_tv_packed
    from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32, holdout_mask

    dev = torch.device("cuda")
    mosaic = torch.from_numpy(sc.orig_bayer).to(dev)
    y = torch.from_numpy(sc.meas).to(dev)
    phi = torch.from_numpy(sc.mask).to(dev)
    keep = 1.0 - holdout_mask(row.select_best_seed, row.select_best_holdout, tuple(y.shape), dev)
    y_p, phi_p = bayer.pack(y * keep), bayer.pack(phi * keep[None])
    dm16 = ddnet_demosaic(DDnet(dtype=torch.bfloat16), ddnet_params)
    dm32 = ddnet_demosaic(DDnet(), ddnet_params)
    with full_f32(), torch.no_grad():
        return {
            "ddnet_bf16_ms": time_ms(lambda: dm16(mosaic), n=5),
            "ddnet_fp32_ms": time_ms(lambda: dm32(mosaic), n=5),
            "masked_gap_tv_40_ms": time_ms(lambda: _gap_tv_packed(
                y_p, phi_p, physics.adjoint(y_p, phi_p), None,
                GapTVConfig(iters=row.select_best_warm_iters)), n=3),
        }


def guard_pick(res) -> dict:
    """The guard's chosen candidate (0 = the warm start, k + 1 = iterate k)
    and the gap from its ranking statistic to the next best."""
    r = res.resid_trace.cpu()
    order = r.sort(stable=True).indices
    return {"pick": int(order[0]), "resid_best": float(r[order[0]]),
            "resid_gap_to_second": float(r[order[1]] - r[order[0]])}


def flagship_profile(torch, run, trace: str | None) -> dict:
    """One reconstruction under ``torch.profiler``: device busy time (the sum
    of device self time; one stream, so nothing overlaps), the wall time,
    the idle share, and the kernels that take the most device time. With
    ``trace``, the Chrome trace is written there."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace:
        Path(trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(trace)

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies); the host ops that launched
    # them carry the same time again
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:10]
    # every design of a kernel: x_update_kernel, tv_chambolle[_cluster]_kernel,
    # convpair[_wgmma]_kernel
    ours = {name: sum(dev_us(e) for e in events
                      if name in e.key and "_kernel" in e.key) / 1e3
            for name in ("x_update", "tv_chambolle", "convpair")}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms if events else "not measured",
            "idle_share": 1 - busy_ms / wall_ms if events else "not measured",
            "port_kernels_ms": ours,
            "top_device": [{"name": e.key[:80], "count": e.count, "ms": dev_us(e) / 1e3}
                           for e in top]}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)} (the default), "
                         f"with {','.join(EXTRA_PHASES)}")
    ap.add_argument("--trace", help="write the flagship's profiler trace (Chrome JSON) here")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    unknown = phases - set(PHASES) - set(EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    needed = {"k1", "k2", "k3", "flagship", "fastdvd", "ddnet", "tiled", "sequence", "cli",
              "train", "scenes", "parallel", "weights", "seams", "studies", "bench", "suite"}
    if "kernels" in phases and not needed <= phases:
        ap.error(f"the kernels phase needs the {', '.join(sorted(needed))} phases")
    if "seams" in phases and "tiled" not in phases:
        ap.error("the seams phase needs the tiled phase (its 2048^2 snapshot)")
    if "seams_halo" in phases and not {"tiled", "seams"} <= phases:
        ap.error("the seams_halo phase needs the tiled and seams phases")
    if "suite" in phases and "bench" not in phases:
        ap.error("the suite phase needs the bench phase (its flagship's reading)")
    if "parallel" in phases and not {"tiled", "flagship", "fastdvd"} <= phases:
        ap.error("the parallel phase needs the tiled, flagship and fastdvd phases (its "
                 "one-process references)")
    from adaptivepnp_sci_torch import (
        ADMMConfig,
        AdaptConfig,
        DDnet,
        FastDVDnet,
        GapDeepConfig,
        GapTVConfig,
        GrayConfig,
        admm_config_for,
        ddnet_demosaic,
        fastdvd_prior,
        ffdnet_prior,
        gap_deep,
        gap_denoise_gray,
        gap_tv,
        make_dm_spec,
        reconstruct_single_dispatch,
        two_stage_admm,
        two_stage_admm_batched,
        two_stage_admm_sequence,
        two_stage_admm_tiled,
    )
    from adaptivepnp_sci_torch.ab_convpair import library_pair, make_inputs, time_ms
    from adaptivepnp_sci_torch.adapt.online import make_schedule
    from adaptivepnp_sci_torch.data.synthetic import make_scene
    from adaptivepnp_sci_torch.models.convert import (
        ddnet_from_flax,
        fastdvdnet_from_flax,
        ffdnet_from_flax,
        load_variables_npz,
    )
    from adaptivepnp_sci_torch.models.ffdnet import FFDNet
    from adaptivepnp_sci_torch import multihost_validation as mv
    from adaptivepnp_sci_torch.multihost_validation import flax_style_ffdnet_params
    from adaptivepnp_sci_torch.ops import bayer, cuda_kernels, physics, tv
    from adaptivepnp_sci_torch.ops import convpair as convpair_ops

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    card = {"nvidia_smi": smi}
    emit("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    build_s = cuda_kernels.build()
    ptxas = {name: [ln.strip()[:200] for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for name, log in cuda_kernels.build_log.items()}
    emit("build", seconds=build_s, ptxas=ptxas)

    flush = torch.zeros(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    report: dict[str, dict] = {}

    # ------------------------------------------------------------------ k1
    if "k1" in phases:
        g = torch.Generator().manual_seed(0)
        nb, h2, w2 = 8, 256, 256
        theta = torch.rand(nb, 4, h2, w2, generator=g).to(dev)
        bd = ((torch.rand(nb, 4, h2, w2, generator=g) - 0.5) * 0.2).to(dev)
        phi = (torch.rand(nb, 4, h2, w2, generator=g) > 0.5).float().to(dev)
        y = (torch.rand(nb, 4, h2, w2, generator=g).to(dev) * phi).sum(0)
        phis = physics.phi_sum(phi)
        cases = {
            "admm": (lambda: cuda_kernels.admm_x_update(theta, bd, y, phi, phis, 1.0, 1.0),
                     lambda: physics.admm_x_update(theta, bd, y, phi, phis, 1.0, 1.0)),
            "gap": (lambda: cuda_kernels.gap_x_update(theta, bd, y, phi, phis, 1.0, 0.01),
                    lambda: physics.gap_x_update(theta, bd, y, phi, phis, 1.0, 0.01)),
            "gap_lam0.5": (lambda: cuda_kernels.gap_x_update(theta, bd, y, phi, phis, 0.5, 0.01),
                           lambda: physics.gap_x_update(theta, bd, y, phi, phis, 0.5, 0.01)),
        }
        # the item axis at the tiled path's group shape: 2 tiles of 512^2,
        # each with its own masks, in one launch; and 2 items under one mask
        thetas = torch.rand(2, nb, 4, h2, w2, generator=g).to(dev)
        bds = ((torch.rand(2, nb, 4, h2, w2, generator=g) - 0.5) * 0.2).to(dev)
        phis_i = (torch.rand(2, nb, 4, h2, w2, generator=g) > 0.5).float().to(dev)
        ys = (torch.rand(2, nb, 4, h2, w2, generator=g).to(dev) * phis_i).sum(1)
        psum_i = physics.phi_sum(phis_i, physics.PACKED_FRAME_AXIS)
        ys_shared = (thetas * phi).sum(1)
        item_cases = {
            "admm_items2": (
                lambda: cuda_kernels.admm_x_update(thetas, bds, ys, phis_i, psum_i, 0.55, 1.0),
                lambda: physics.admm_x_update(thetas, bds, ys, phis_i, psum_i, 0.55, 1.0)),
            "gap_items2_shared_phi": (
                lambda: cuda_kernels.gap_x_update(thetas, bds, ys_shared, phi, phis, 0.5, 0.01),
                lambda: physics.gap_x_update(thetas, bds, ys_shared, phi, phis, 0.5, 0.01)),
        }
        cases.update(item_cases)
        byts = (4 * theta.numel() + 2 * y.numel()) * 4
        bound_ms = byts / HBM_BYTES_PER_S * 1e3
        byts_items = (4 * thetas.numel() + 2 * ys.numel()) * 4
        per = {}
        for name, (kern, plain) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            rel = float((diff / want.abs().clamp_min(1e-30)).max())
            ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6))
            require(bool(torch.isfinite(got).all()), f"k1 {name}: non-finite output")
            require(ok, f"k1 {name}: kernel disagrees with plain (max abs {float(diff.max())})")
            per[name] = {"max_abs": float(diff.max()), "max_rel": rel,
                         "ms": time_ms(kern, flush=flush),
                         "warm_l2_ms": time_ms(kern),
                         "plain_ms": time_ms(plain, flush=flush)}
        # one item-axis launch against one launch per item
        one_by_one = [cuda_kernels.admm_x_update(thetas[i], bds[i], ys[i], phis_i[i], psum_i[i],
                                                 0.55, 1.0) for i in range(2)]
        require(bool(torch.equal(torch.stack(one_by_one), item_cases["admm_items2"][0]())),
                "k1: the item-axis launch differs from one launch per item")
        emit("k1", shape=[nb, 4, h2, w2], items_shape=[2, nb, 4, h2, w2],
             tolerance="rtol 1e-5, atol 1e-6", cases=per, bytes=byts, bound_us=bound_ms * 1e3,
             items_bytes=byts_items, items_bound_us=byts_items / HBM_BYTES_PER_S * 1e6,
             bound_basis="bytes / 3.35 TB/s (H100 SXM HBM3 data sheet)", **card)
        report["x_update"] = {
            "max_abs_err": max(c["max_abs"] for c in per.values()),
            "ms": per["gap"]["ms"], "plain_ms": per["gap"]["plain_ms"],
            "bound_ms": bound_ms, "bound_by": "bytes",
            "items2_ms": per["admm_items2"]["ms"], "items2_plain_ms": per["admm_items2"]["plain_ms"],
            "items2_bound_ms": byts_items / HBM_BYTES_PER_S * 1e3}

        # the split form of a frame-sharded solve: a rank's 4 of the 8 frames
        # (the first), the other rank's terms of the frame sum put beside this
        # rank's where the solve all-gathers them; with 2 items; and one rank
        # holding all 8 frames against the fused kernel, bit for bit
        class Beside:
            """``gather`` of the split form: the other rank's terms after these."""

            def __init__(self, other):
                self.other = other

            def gather(self, t, dim):
                return torch.cat([t, self.other], dim)

        class Whole:
            """``gather`` that hands back every frame's terms, made beforehand
            (the timed runs: the two launches without the collective)."""

            def __init__(self, terms):
                self.terms = terms

            def gather(self, t, dim):
                return self.terms

        class Alone:
            """``gather`` of a rank that holds every frame."""

            def gather(self, t, dim):
                return t

        fa = physics.PACKED_FRAME_AXIS
        bl = nb // 2
        split_cases = {}
        for name, sign, rho, c, lam, items in (("admm", -1.0, 0.55, 0.55, 1.0, False),
                                                ("gap_lam0.5", 1.0, 1.0, 0.01, 0.5, False),
                                                ("admm_items2", -1.0, 0.55, 0.55, 1.0, True)):
            th, bb, ph = ((thetas, bds, phis_i) if items else (theta, bd, phi))
            yy, ps = (ys, psum_i) if items else (y, phis)
            other = physics.x_update_partial(th[..., bl:, :, :, :], bb[..., bl:, :, :, :],
                                             ph[..., bl:, :, :, :], sign, rho)[1]
            inputs = (th[..., :bl, :, :, :].contiguous(), bb[..., :bl, :, :, :].contiguous(), yy,
                    ph[..., :bl, :, :, :].contiguous(), ps)
            if sign < 0:
                kern = lambda f, a=inputs: cuda_kernels.admm_x_update(*a, 0.55, 1.0, frame=f)
            else:
                kern = lambda f, a=inputs: cuda_kernels.gap_x_update(*a, 0.5, 0.01, frame=f)

            def plain(a=inputs, o=other, sg=sign, r=rho, cc=c, lm=lam):
                p_, t_ = physics.x_update_partial(a[0], a[1], a[3], sg, r)
                return physics.x_update_finish(p_, torch.cat([t_, o], fa), a[2], a[3], a[4], cc,
                                               lm)

            got, want = kern(Beside(other)), plain()
            torch.cuda.synchronize()
            diff = float((got - want).abs().max())
            require(bool(torch.isfinite(got).all()), f"k1 split {name}: non-finite output")
            require(bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6)),
                    f"k1 split {name}: kernel disagrees with plain (max abs {diff})")
            whole = Whole(torch.cat([physics.x_update_partial(inputs[0], inputs[1], inputs[3], sign,
                                                              rho)[1], other], fa).contiguous())
            split_cases[name] = {"max_abs": diff, "ms": time_ms(lambda: kern(whole), flush=flush),
                                 "warm_l2_ms": time_ms(lambda: kern(whole)),
                                 "plain_ms": time_ms(plain, flush=flush)}
        one_rank = {}
        for name, fused, split in (
                ("admm", lambda: cuda_kernels.admm_x_update(theta, bd, y, phi, phis, 0.55, 1.0),
                 lambda f: cuda_kernels.admm_x_update(theta, bd, y, phi, phis, 0.55, 1.0,
                                                      frame=f)),
                ("gap_lam0.5", lambda: cuda_kernels.gap_x_update(theta, bd, y, phi, phis, 0.5),
                 lambda f: cuda_kernels.gap_x_update(theta, bd, y, phi, phis, 0.5, frame=f)),
                ("admm_items2", item_cases["admm_items2"][0],
                 lambda f: cuda_kernels.admm_x_update(thetas, bds, ys, phis_i, psum_i, 0.55, 1.0,
                                                      frame=f))):
            one_rank[name] = bool(torch.equal(split(Alone()), fused()))
        require(all(one_rank.values()),
                f"k1 split: one rank's partial and finish differ from the fused kernel {one_rank}")
        # bytes of a rank's two launches: the partial reads theta, b and phi and
        # writes p and the terms; the finish reads every frame's terms, p, phi,
        # y and phi_sum and writes x
        local = 4 * bl * 4 * h2 * w2
        split_byts = (5 * local + (nb * 4 * h2 * w2 * 4) + 3 * local + 2 * 4 * h2 * w2 * 4)
        split_bound_ms = split_byts / HBM_BYTES_PER_S * 1e3
        emit("k1_split", shape=[nb, 4, h2, w2], rank_frames=bl, items_shape=[2, bl, 4, h2, w2],
             tolerance="rtol 1e-5, atol 1e-6 against the plain split; one rank holding every "
             "frame bit for bit against the fused kernel", cases=split_cases,
             one_rank_equals_fused=one_rank, bytes=split_byts, bound_us=split_bound_ms * 1e3,
             timed="both launches, the gather left out",
             bound_basis="bytes / 3.35 TB/s (H100 SXM HBM3 data sheet)", **card)
        report["x_update_split"] = {
            "max_abs_err": max(c["max_abs"] for c in split_cases.values()),
            "ms": split_cases["admm"]["ms"], "warm_l2_ms": split_cases["admm"]["warm_l2_ms"],
            "plain_ms": split_cases["admm"]["plain_ms"], "bound_ms": split_bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "items2_ms": split_cases["admm_items2"]["ms"]}

    # ------------------------------------------------------------------ k2
    if "k2" in phases:
        golden = np.load(ROOT / "tests" / "goldens" / "tv_chambolle_golden.npz")
        got = cuda_kernels.tv_chambolle_fused(torch.from_numpy(golden["cube"]).to(dev), 0.1)
        golden_err = float(np.abs(got.cpu().numpy() - golden["out"]).max())
        require(golden_err <= 1e-5, f"k2: golden max abs err {golden_err} > 1e-5")

        g = torch.Generator().manual_seed(1)
        rand = torch.rand(32, 256, 256, generator=g).to(dev)
        # realistic inputs: the 40 TV-prox inputs of a plain-path GAP-TV warm
        # start on the flagship's smooth scene
        sc = make_scene(b=8, h=512, w=512, seed=42)
        y_p = bayer.pack(torch.from_numpy(sc.meas).to(dev))
        phi_p = bayer.pack(torch.from_numpy(sc.mask).to(dev))
        phi_s = physics.phi_sum(phi_p)
        x0 = physics.adjoint(y_p, phi_p)
        theta_w, b_w = x0, torch.zeros_like(x0)
        inputs = [rand]
        for _ in range(40):
            x = physics.gap_x_update(theta_w, b_w, y_p, phi_p, phi_s, 1.0, 0.01)
            xb = x - b_w
            inputs.append(xb.reshape(32, 256, 256).contiguous())
            theta_w = torch.clamp(tv.tv_chambolle_multichannel(xb, 0.1, max_iter=5), 0, 1)
            b_w = b_w - (x - theta_w)
        design, cluster, strip_h = cuda_kernels.tv_plan(256, 256)
        require(design == "cluster", f"k2: 256 x 256 planes planned as {design}")
        err, flips, planes, iters_hist = 0.0, 0, 0, {}
        for inp in inputs:
            k_out, k_it = cuda_kernels.tv_chambolle_planes_cuda(inp, 0.1, 2e-4, 5)
            p_out, p_it = tv.tv_chambolle_planes(inp, 0.1, 2e-4, 5)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(k_out).all()), "k2: non-finite output")
            flips += int((k_it != p_it).sum())
            planes += inp.shape[0]
            for v in k_it.tolist():
                iters_hist[v] = iters_hist.get(v, 0) + 1
            err = max(err, float((k_out - p_out).abs().max()))
            require(bool(torch.allclose(k_out, p_out, rtol=1e-5, atol=1e-6)),
                    f"k2: kernel disagrees with plain (max abs {err})")
        require(flips == 0, f"k2: {flips} of {planes} stop decisions differ from the plain version")
        real = inputs[1]
        # the one-block-per-plane design on the same planes, and on planes that
        # only it takes; the cluster design twice on one input (no atomics)
        large = torch.rand(2, 512, 512, generator=g).to(dev)
        require(cuda_kernels.tv_plan(512, 512)[0] == "block", "k2: 512 x 512 not planned as block")
        others = {}
        for name, inp, kw in (("block_rand", rand, dict(design="block")),
                              ("block_real", real, dict(design="block")),
                              ("large_plane_512", large, {})):
            k_out, k_it = cuda_kernels.tv_chambolle_planes_cuda(inp, 0.1, 2e-4, 5, **kw)
            p_out, p_it = tv.tv_chambolle_planes(inp, 0.1, 2e-4, 5)
            others[name] = float((k_out - p_out).abs().max())
            require(bool(torch.allclose(k_out, p_out, rtol=1e-5, atol=1e-6))
                    and bool(torch.equal(k_it, p_it)), f"k2 {name}: disagrees with plain")
        # the drivers' plane shapes: the 32 packed planes of a 2048^2 warm
        # start (1024^2, the block design), and the 64 planes of a group of two
        # 512 tiles with 32 px of overlap (288^2, a cluster of 8 strips of 36)
        driver_shapes = {}
        for name, shape, want_plan in (("warm_start_1024", (32, 1024, 1024), ("block", 1, 1024)),
                                       ("window_288", (64, 288, 288), ("cluster", 8, 36))):
            require(cuda_kernels.tv_plan(*shape[1:]) == want_plan,
                    f"k2 {name}: planned {cuda_kernels.tv_plan(*shape[1:])}")
            noise = torch.rand(*shape, generator=g)
            inp = torch.nn.functional.avg_pool2d(noise[None], 5, 1, 2)[0].contiguous().to(dev)
            k_out, k_it = cuda_kernels.tv_chambolle_planes_cuda(inp, 0.1, 2e-4, 5)
            p_out, p_it = tv.tv_chambolle_planes(inp, 0.1, 2e-4, 5)
            torch.cuda.synchronize()
            d_err = float((k_out - p_out).abs().max())
            require(bool(torch.allclose(k_out, p_out, rtol=1e-5, atol=1e-6))
                    and bool(torch.equal(k_it, p_it)), f"k2 {name}: disagrees with plain ({d_err})")
            n_it = int(k_it.sum())
            d_byts = 2 * inp.numel() * 4
            d_flops = n_it * shape[1] * shape[2] * TV_FLOPS_PER_PIXEL_ITER
            driver_shapes[name] = {
                "shape": list(shape), "plan": list(want_plan), "max_abs": d_err,
                "plane_iterations": n_it,
                "ms": time_ms(lambda: cuda_kernels.tv_chambolle_fused(inp, 0.1), flush=flush),
                "plain_ms": time_ms(lambda: tv.tv_chambolle_multichannel(inp, 0.1), n=5,
                                    flush=flush),
                "bound_us": max(d_byts / HBM_BYTES_PER_S, d_flops / FP32_FLOPS) * 1e6}
            others[name] = d_err
        again = [cuda_kernels.tv_chambolle_planes_cuda(real, 0.1, 2e-4, 5)[0] for _ in range(2)]
        require(bool(torch.equal(*again)), "k2: two calls on one input differ")
        sms_used = cuda_kernels.tv_sms_used(*real.shape)
        require(sms_used > 32, f"k2: the cluster design ran on {sms_used} SMs")
        _, it_real = cuda_kernels.tv_chambolle_planes_cuda(real, 0.1, 2e-4, 5)
        n_iter = int(it_real.sum())
        byts = 2 * real.numel() * 4
        flops = n_iter * 256 * 256 * TV_FLOPS_PER_PIXEL_ITER
        bound_ms = max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3

        def run_new():
            return cuda_kernels.tv_chambolle_fused(real, 0.1)

        def run_old():
            return cuda_kernels.tv_chambolle_planes_cuda(real, 0.1, design="block")

        # new, old, old, new within one run on one card
        cold = [time_ms(f, flush=flush) for f in (run_new, run_old, run_old, run_new)]
        ms, previous_ms = min(cold[0], cold[3]), min(cold[1], cold[2])
        warm_ms, previous_warm_ms = time_ms(run_new), time_ms(run_old)
        require(ms < previous_ms, f"k2: cluster design {ms} ms, block design {previous_ms} ms")
        plain_ms = time_ms(lambda: tv.tv_chambolle_multichannel(real, 0.1), n=10,
                           flush=flush)
        emit("k2", shape=[32, 256, 256], tolerance="rtol 1e-5, atol 1e-6",
             design=design, cluster_size=cluster, strip_rows=strip_h,
             golden_max_abs=golden_err, max_abs=err, planes_compared=planes,
             stop_iteration_flips=flips, kernel_iterations_histogram=iters_hist,
             other_checks_max_abs=others, repeated_call_identical=True,
             timed_input="first warm-start TV input", timed_plane_iterations=n_iter,
             ms=ms, warm_l2_ms=warm_ms, previous_design="block", previous_ms=previous_ms,
             previous_warm_l2_ms=previous_warm_ms, cold_runs_new_old_old_new=cold,
             plain_ms=plain_ms, bytes=byts, flops=flops, bound_us=bound_ms * 1e3,
             bound_basis="max(bytes / 3.35 TB/s, flops / 67 TFLOP/s fp32)",
             sms_used=sms_used, driver_shapes=driver_shapes, **card)
        report["tv_chambolle"] = {"max_abs_err": max(err, *others.values()), "ms": ms,
                                  "previous_ms": previous_ms,
                                  "ms_1024": driver_shapes["warm_start_1024"]["ms"],
                                  "ms_288": driver_shapes["window_288"]["ms"],
                                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "bound_by": "bytes" if byts / HBM_BYTES_PER_S
                                  >= flops / FP32_FLOPS else "operations"}

    # ------------------------------------------------------------------ k3
    fastdvd_params = fastdvdnet_from_flax(
        load_variables_npz(str(ROOT / "weights" / "fastdvd.npz")))
    if "k3" in phases:
        trained = FastDVDnet()
        trained.load_state_dict(fastdvd_params)
        trained.to(dev)

        def trained_case(block, hw):
            """A CvBlock of the trained model, folded, on a random input."""
            conv0, bn0, _, conv1, bn1, _ = block.convblock
            with torch.no_grad():
                folded = [t.contiguous() for t in (
                    conv0.weight.bfloat16().permute(2, 3, 1, 0), *convpair_ops.fold_bn(bn0),
                    conv1.weight.bfloat16().permute(2, 3, 1, 0), *convpair_ops.fold_bn(bn1))]
            return (make_inputs(8, hw, hw, conv0.in_channels, dev, seed=1)[0], *folded)

        cases = {
            "c64_256": make_inputs(8, 256, 256, 64, dev),
            "c32_512": make_inputs(8, 512, 512, 32, dev),
            "c128_128": make_inputs(8, 128, 128, 128, dev),
            "c32_odd_2x70x94": make_inputs(2, 70, 94, 32, dev),
            "c64_256_trained_downc0": trained_case(trained.temp1.downc0.convblock[3], 256),
            "c128_128_trained_upc2": trained_case(trained.temp2.upc2.convblock[0], 128),
        }
        per = {}
        for name, pair in cases.items():
            n, h, w, c = pair[0].shape
            want = convpair_ops.convpair(*pair)
            scale = float(want.float().abs().max()) or 1.0
            designs = [cuda_kernels.CONVPAIR_DESIGN[c]]
            designs += [d for d, (_, _, chans) in cuda_kernels.CONVPAIR_DESIGNS.items()
                        if c in chans and d not in designs]
            errs = {}
            for d in designs:  # the default design first, then the kept earlier one
                got = cuda_kernels.convpair(*pair, design=d)
                torch.cuda.synchronize()
                require(bool(torch.isfinite(got.float()).all()),
                        f"k3 {name} {d}: non-finite output")
                errs[d] = float((got.float() - want.float()).abs().max())
                require(errs[d] / scale < 2e-2,
                        f"k3 {name} {d}: rel err {errs[d] / scale} >= 2e-2")
            err = errs[designs[0]]
            flops = 2 * 2 * 9 * c * c * n * h * w
            byts = 2 * pair[0].numel() * 2 + 2 * 9 * c * c * 2 + 4 * c * 4
            per[name] = {"shape": [n, h, w, c], "design": designs[0], "max_abs": err,
                         "max_abs_ref": scale, "rel_err": err / scale,
                         "rel_err_by_design": {d: e / scale for d, e in errs.items()},
                         "flops": flops, "bytes": byts,
                         "bound_us": max(flops / BF16_FLOPS, byts / HBM_BYTES_PER_S) * 1e6,
                         "bound_by": "operations" if flops / BF16_FLOPS
                         >= byts / HBM_BYTES_PER_S else "bytes"}
            if "trained" in name or "odd" in name:
                continue
            lib = library_pair(*pair)

            def run_new():
                return cuda_kernels.convpair(*pair)

            def run_old():
                return cuda_kernels.convpair(*pair, design="mma")

            # new, old, old, new within one run on one card
            cold = [time_ms(f, flush=flush) for f in (run_new, run_old, run_old, run_new)]
            per[name].update(
                ms=min(cold[0], cold[3]), previous_design="mma",
                previous_ms=min(cold[1], cold[2]), cold_runs_new_old_old_new=cold,
                warm_l2_ms=time_ms(run_new), previous_warm_l2_ms=time_ms(run_old),
                plain_ms=time_ms(lambda: convpair_ops.convpair(*pair), n=10, flush=flush),
                library_ms=time_ms(lib, n=10, flush=flush))
            per[name]["tflops"] = flops / (per[name]["ms"] * 1e-3) / 1e12
            if name in CONVPAIR_MAIN_SHAPES:
                require(per[name]["ms"] <= per[name]["previous_ms"],
                        f"k3 {name}: {per[name]['ms']} ms, earlier design "
                        f"{per[name]['previous_ms']} ms")
        emit("k3", tolerance="max abs err / max abs reference < 2e-2", cases=per,
             bound_basis="max(flops / 989 TFLOP/s bf16 dense, bytes / 3.35 TB/s)",
             library="two channels-last bf16 F.conv2d with folded scale and bias, ReLU in place",
             **card)
        for name in CONVPAIR_MAIN_SHAPES:
            case = per[name]
            report[f"convpair_{name}"] = {
                "max_abs_err": max(c["max_abs"] for c in per.values()
                                   if c["shape"][3] == case["shape"][3]),
                "ms": case["ms"], "previous_ms": case["previous_ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_us"] / 1e3,
                "bound_by": case["bound_by"], "library_ms": case["library_ms"]}
        del cases, trained

    def run_flagship(scene, prior, params, device, warm_iters=40):
        return reconstruct_single_dispatch(
            scene.meas, scene.mask, GapTVConfig(iters=warm_iters),
            ADMMConfig(sigma=SIGMA, iters=ITERS,
                       adapt=AdaptConfig(lr=2e-6, update_per_iter=2, interval_iter=15,
                                         initial_iter=1)),
            prior, params, orig=scene.orig_bayer, device=device)

    # -------------------------------------------------------- slice parity
    if "slice_parity" in phases:
        sc = make_scene(b=8, h=64, w=64, seed=42)
        params = ffdnet_from_flax(flax_style_ffdnet_params(16, 4, seed=0))
        prior = ffdnet_prior(FFDNet(nc=16, nb=4))
        cpu = run_flagship(sc, prior, params, "cpu")
        cuda_kernels.reset_launches()
        gpu = run_flagship(sc, prior, params, "cuda")
        torch.cuda.synchronize()
        counts = dict(cuda_kernels.launches)
        require(counts == FLAGSHIP_LAUNCHES, f"slice_parity: launches {counts}")
        dpsnr = float((gpu.psnr_per_frame.cpu() - cpu.psnr_per_frame).abs().max())
        dx = float((gpu.x_bayer.cpu() - cpu.x_bayer).abs().max())
        require(bool(torch.isfinite(gpu.x_bayer).all()), "slice_parity: non-finite")
        require(dpsnr <= 0.05 and dx <= 1e-3,
                f"slice_parity: dPSNR {dpsnr} dB, max |dx| {dx}")
        emit("slice_parity", shape=[8, 64, 64], ffdnet={"nc": 16, "nb": 4},
             max_dpsnr_db=dpsnr, max_abs_dx_bayer=dx, bar="0.05 dB, 1e-3",
             psnr_cuda=gpu.psnr_per_frame.mean().item(),
             psnr_cpu=cpu.psnr_per_frame.mean().item(), launches=counts)

    # ------------------------------------------------------------ flagship
    if "flagship" in phases:
        params = ffdnet_from_flax(flax_style_ffdnet_params(96, 12, seed=0))
        prior = ffdnet_prior(FFDNet(nc=96, nb=12))
        for style in ("smooth", "leaves"):
            sc = make_scene(b=8, h=512, w=512, seed=42, style=style)
            secs = []
            for rep in range(4):  # one warm-up, then three timed
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                cuda_kernels.reset_launches()
                t0 = time.perf_counter()
                res = run_flagship(sc, prior, params, "cuda")
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                counts = dict(cuda_kernels.launches)
                require(counts == FLAGSHIP_LAUNCHES, f"flagship {style}: launches {counts}")
                report.setdefault("launches", counts)  # the first main-path run
                if rep:
                    secs.append(dt)
            peak = torch.cuda.max_memory_allocated()
            require(tuple(res.x_bayer.shape) == (8, 512, 512)
                    and tuple(res.x_rgb.shape) == (8, 512, 512, 3), "flagship: shapes")
            require(bool(torch.isfinite(res.x_bayer).all() & torch.isfinite(res.x_rgb).all()),
                    "flagship: non-finite output")
            med = statistics.median(secs)
            if style == "smooth":  # the parallel phase's one-process reference
                report["flagship_ref"] = {"psnr": res.psnr_per_frame.cpu().numpy(),
                                          "variables": _flat_variables(res.variables),
                                          "seconds": med}
            emit("flagship", scene=style, shape=[8, 512, 512], ffdnet={"nc": 96, "nb": 12},
                 weights="random, Flax default init from numpy seed 0",
                 seconds_per_snapshot=med, seconds_runs=secs, frames_per_s=8 / med,
                 psnr_db=res.psnr_per_frame.mean().item(),
                 ssim=res.ssim_per_frame.mean().item(),
                 peak_mem_bytes=peak, launches_per_reconstruction=counts, **card)
            if style == "smooth":
                emit("flagship_breakdown", **flagship_breakdown(torch, sc, prior, params),
                     **card)
                cuda_kernels.reset_launches()
                emit("flagship_profile",
                     **flagship_profile(torch, lambda: run_flagship(sc, prior, params, "cuda"),
                                        args.trace),
                     **card)
                counts = dict(cuda_kernels.launches)
                require(counts == FLAGSHIP_LAUNCHES, f"flagship profile: launches {counts}")

    def run_fastdvd(scene, prior, device, generator=None, params=fastdvd_params,
                    iters=FASTDVD_ITERS):
        return reconstruct_single_dispatch(
            scene.meas, scene.mask, GapTVConfig(iters=40),
            ADMMConfig(sigma=FASTDVD_SIGMA, iters=iters, denoiser="fastdvd",
                       adapt=AdaptConfig(**FASTDVD_ADAPT)),
            prior, params, orig=scene.orig_bayer, device=device, generator=generator)

    modes = {"fp32": dict(dtype=None, remat=True), "bf16": dict(dtype=torch.bfloat16, remat=False)}

    # ------------------------------------------------------ fastdvd parity
    if "fastdvd_parity" in phases:
        sc = make_scene(b=8, h=64, w=64, seed=42)
        for mode, kw in modes.items():
            prior = fastdvd_prior(FastDVDnet(**kw))
            for iters, want_counts, db_bar, dx_bar, dx_kind in FASTDVD_PARITY[mode]:
                # one CPU generator per run: the same adaptation noise on both devices
                cpu = run_fastdvd(sc, prior, "cpu", torch.Generator().manual_seed(0), iters=iters)
                cuda_kernels.reset_launches()
                gpu = run_fastdvd(sc, prior, "cuda", torch.Generator().manual_seed(0),
                                  iters=iters)
                torch.cuda.synchronize()
                counts = dict(cuda_kernels.launches)
                require(counts == want_counts, f"fastdvd_parity {mode} {iters}: launches {counts}")
                require(bool(torch.isfinite(gpu.x_bayer).all()),
                        f"fastdvd_parity {mode} {iters}: non-finite")
                dpsnr = float((gpu.psnr_per_frame.cpu() - cpu.psnr_per_frame).abs().max())
                delta = gpu.x_bayer.cpu() - cpu.x_bayer
                dx = {"max": float(delta.abs().max()), "rms": float(delta.square().mean().sqrt())}
                require(dpsnr <= db_bar and dx[dx_kind] <= dx_bar,
                        f"fastdvd_parity {mode} {iters}: dPSNR {dpsnr} dB, |dx| {dx}")
                emit("fastdvd_parity", mode=mode, shape=[8, 64, 64], iters=list(iters),
                     weights="weights/fastdvd.npz", max_dpsnr_db=dpsnr,
                     max_abs_dx_bayer=dx["max"], rms_dx_bayer=dx["rms"],
                     bar=f"{db_bar} dB, {dx_kind} |dx| {dx_bar}",
                     psnr_cuda=gpu.psnr_per_frame.mean().item(),
                     psnr_cpu=cpu.psnr_per_frame.mean().item(), launches=counts)
        # the solvers' default generator (generator=None) is a CPU generator:
        # the card draws the CPU's adaptation noise
        prior = fastdvd_prior(FastDVDnet(**modes["fp32"]))
        (iters, want_counts, db_bar, dx_bar, _), = FASTDVD_PARITY["fp32"]
        cpu = run_fastdvd(sc, prior, "cpu", iters=iters)
        cuda_kernels.reset_launches()
        gpu = run_fastdvd(sc, prior, "cuda", iters=iters)
        torch.cuda.synchronize()
        counts = dict(cuda_kernels.launches)
        dpsnr = float((gpu.psnr_per_frame.cpu() - cpu.psnr_per_frame).abs().max())
        dx_max = float((gpu.x_bayer.cpu() - cpu.x_bayer).abs().max())
        emit("fastdvd_parity_default_generator", mode="fp32", shape=[8, 64, 64],
             iters=list(iters), generator="None on both devices", max_dpsnr_db=dpsnr,
             max_abs_dx_bayer=dx_max, bar=f"{db_bar} dB, max |dx| {dx_bar}", launches=counts)
        require(counts == want_counts, f"fastdvd_parity default generator: launches {counts}")
        require(dpsnr <= db_bar and dx_max <= dx_bar,
                f"fastdvd_parity default generator: dPSNR {dpsnr} dB, max |dx| {dx_max}")

    # ------------------------------------------------------------- fastdvd
    if "fastdvd" in phases:
        for style in ("smooth", "leaves"):
            sc = make_scene(b=8, h=512, w=512, seed=42, style=style)
            warm = gap_tv(sc.meas, sc.mask, GapTVConfig(iters=40), orig_bayer=sc.orig_bayer,
                          device="cuda")
            warm_psnr = warm.psnr_per_frame.mean().item()
            results = {}
            for mode, kw in modes.items():
                prior = fastdvd_prior(FastDVDnet(**kw))
                secs = []
                for rep in range(FASTDVD_RUNS[style, mode]):  # one warm-up, then timed
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    cuda_kernels.reset_launches()
                    t0 = time.perf_counter()
                    res = run_fastdvd(sc, prior, "cuda")
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    counts = dict(cuda_kernels.launches)
                    require(counts == FASTDVD_LAUNCHES[mode],
                            f"fastdvd {mode} {style}: launches {counts}")
                    report.setdefault(f"launches_fastdvd_{mode}", counts)
                    if mode == "bf16":
                        by_shape = dict(cuda_kernels.convpair_launches)
                        require(by_shape == {shp: 144 for shp in CONVPAIR_MAIN_SHAPES.values()},
                                f"fastdvd bf16 {style}: conv pair launches {by_shape}")
                        report.setdefault("launches_convpair", by_shape)
                    if rep or FASTDVD_RUNS[style, mode] == 1:
                        secs.append(dt)
                    if not rep:
                        first = _flat_variables(res.variables)
                # the same call's adapted weights, first run against last: how
                # far one process is from itself (cuDNN's backward algorithms)
                start = _flat_variables(fastdvd_params)
                last = _flat_variables(res.variables)
                repeat_dw = (float(np.linalg.norm(last - first) / np.linalg.norm(last - start))
                             if FASTDVD_RUNS[style, mode] > 1 else None)
                peak = torch.cuda.max_memory_allocated()
                require(tuple(res.x_bayer.shape) == (8, 512, 512)
                        and tuple(res.x_rgb.shape) == (8, 512, 512, 3), "fastdvd: shapes")
                require(bool(torch.isfinite(res.x_bayer).all() & torch.isfinite(res.x_rgb).all()),
                        f"fastdvd {mode} {style}: non-finite output")
                med = statistics.median(secs)
                results[mode] = res
                if style == "smooth":  # the parallel phase's one-process references
                    report[f"fastdvd_ref_{mode}"] = {
                        "psnr": res.psnr_per_frame.cpu().numpy(),
                        "x_bayer": res.x_bayer.cpu().numpy(),
                        "variables": _flat_variables(res.variables), "seconds": med}
                emit("fastdvd", scene=style, mode=mode, shape=[8, 512, 512],
                     weights="weights/fastdvd.npz", seconds_per_snapshot=med, seconds_runs=secs,
                     frames_per_s=8 / med, warm_start_psnr_db=warm_psnr,
                     warm_start_ssim=warm.ssim_per_frame.mean().item(),
                     psnr_db=res.psnr_per_frame.mean().item(),
                     ssim=res.ssim_per_frame.mean().item(),
                     gain_over_warm_start_db=res.psnr_per_frame.mean().item() - warm_psnr,
                     repeat_dw_fraction=repeat_dw,
                     peak_mem_bytes=peak, launches_per_reconstruction=counts, **card)
            emit("fastdvd_modes", scene=style,
                 bf16_minus_fp32_psnr_db=(results["bf16"].psnr_per_frame.mean()
                                          - results["fp32"].psnr_per_frame.mean()).item(),
                 max_abs_dx_bayer=float((results["bf16"].x_bayer
                                         - results["fp32"].x_bayer).abs().max()))
            if style == "smooth":
                # the repository's second checkpoint, trained on this scene family
                smooth = run_fastdvd(
                    sc, fastdvd_prior(FastDVDnet()), "cuda",
                    params=fastdvdnet_from_flax(
                        load_variables_npz(str(ROOT / "weights" / "fastdvd_smooth.npz"))))
                emit("fastdvd_smooth_weights", scene=style, mode="fp32",
                     weights="weights/fastdvd_smooth.npz", warm_start_psnr_db=warm_psnr,
                     psnr_db=smooth.psnr_per_frame.mean().item(),
                     ssim=smooth.ssim_per_frame.mean().item())
                with torch.no_grad():
                    warm_ms = time_ms(lambda: gap_tv(
                        sc.meas, sc.mask, GapTVConfig(iters=40), device="cuda"), n=3)
                extra = ({"fp32_no_remat": fastdvd_breakdown(torch, sc, fastdvd_params, None,
                                                             False)}
                         if "profiles" in phases else {})
                emit("fastdvd_breakdown", warm_start_40_ms=warm_ms,
                     fp32_remat=fastdvd_breakdown(torch, sc, fastdvd_params, None, True),
                     bf16_no_remat=fastdvd_breakdown(torch, sc, fastdvd_params,
                                                     torch.bfloat16, False),
                     **extra, **card)
                if "profiles" in phases:
                    prior = fastdvd_prior(FastDVDnet(**modes["bf16"]))
                    cuda_kernels.reset_launches()
                    emit("fastdvd_profile", mode="bf16",
                         **flagship_profile(torch, lambda: run_fastdvd(sc, prior, "cuda"), None),
                         **card)
                    require(dict(cuda_kernels.launches) == FASTDVD_LAUNCHES["bf16"],
                            f"fastdvd profile: launches {cuda_kernels.launches}")

    # ---------------------------------------------- deep demosaicking row
    ddnet_params = ddnet_from_flax(load_variables_npz(str(ROOT / "weights" / "ddnet.npz")))
    row = admm_config_for("Bosphorus", "fastdvd", deep_demosaicking=True)
    require((row.sigma, row.iters, row.rho, row.select_best_holdout, row.demosaic_method)
            == ((8 / 255, 6 / 255), (24, 12), 0.55, 0.05, "ddnet")
            and np.nonzero(make_schedule(row.sigma, row.iters, row.adapt)[1])[0].tolist() == [25],
            f"ddnet: the scene table's row changed: {row}")

    def run_row(scene, prior, dm, device, cfg=row, generator=None):
        """The row end to end through ``reconstruct_single_dispatch``."""
        return reconstruct_single_dispatch(
            scene.meas, scene.mask, GapTVConfig(iters=40), cfg, prior, fastdvd_params,
            orig=scene.orig_bayer, device=device, generator=generator, demosaic_fn=dm)

    def run_row_dm_update(scene, prior, spec, device, cfg=row, generator=None):
        """The row with the demosaicker adapted in the loop: GAP-TV, then
        ``two_stage_admm`` with ``dm_spec``."""
        warm = gap_tv(scene.meas, scene.mask, GapTVConfig(iters=40), device=device)
        return two_stage_admm(scene.meas, scene.mask, cfg, prior, fastdvd_params,
                              warm.x_bayer, scene.orig_bayer, device, generator,
                              dm_spec=spec, dm_variables=ddnet_params)

    # ------------------------------------------------------- ddnet parity
    if "ddnet_parity" in phases:
        import dataclasses

        sc = make_scene(b=8, h=64, w=64, seed=42)
        cfg = dataclasses.replace(row, iters=DDNET_PARITY_ITERS, adapt=dataclasses.replace(
            row.adapt, interval_iter=5))
        require(np.nonzero(make_schedule(cfg.sigma, cfg.iters, cfg.adapt)[1])[0].tolist() == [5],
                "ddnet_parity: trigger")
        prior = fastdvd_prior(FastDVDnet())
        runs = {
            "ddnet_fixed": lambda dev: run_row(sc, prior, ddnet_demosaic(DDnet(), ddnet_params),
                                               dev, cfg, torch.Generator().manual_seed(0)),
            "dm_update_carried": lambda dev: run_row_dm_update(
                sc, prior, make_dm_spec(DDnet(), **DM_UPDATE), dev, cfg,
                torch.Generator().manual_seed(0)),
            "dm_update_fresh": lambda dev: run_row_dm_update(
                sc, prior, make_dm_spec(DDnet(), **DM_UPDATE, fresh_opt=True), dev, cfg,
                torch.Generator().manual_seed(0)),
        }
        for name, run in runs.items():
            t0 = time.perf_counter()
            cpu = run("cpu")
            cpu_s = time.perf_counter() - t0
            cuda_kernels.reset_launches()
            gpu = run("cuda")
            torch.cuda.synchronize()
            counts = dict(cuda_kernels.launches)
            require(counts == DDNET_PARITY_LAUNCHES, f"ddnet_parity {name}: launches {counts}")
            require(bool(torch.isfinite(gpu.x_bayer).all()), f"ddnet_parity {name}: non-finite")
            dpsnr = (gpu.psnr_per_frame.cpu() - cpu.psnr_per_frame).abs()
            dx = float((gpu.x_bayer.cpu() - cpu.x_bayer).abs().max())
            picks = {"cuda": guard_pick(gpu), "cpu": guard_pick(cpu)}
            fields = {}
            if name != "ddnet_fixed":
                fields["max_abs_d_dm_variables"] = max(
                    float((gpu.dm_variables[k].cpu() - cpu.dm_variables[k]).abs().max())
                    for k in cpu.dm_variables)
            emit("ddnet_parity", run=name, shape=[8, 64, 64], iters=list(cfg.iters),
                 trigger_k=5, dtype="float32", weights="weights/ddnet.npz, weights/fastdvd.npz",
                 max_dpsnr_db=float(dpsnr.max()), dpsnr_per_frame_db=dpsnr.tolist(),
                 max_abs_dx_bayer=dx, bar="0.05 dB, 1e-3, the same pick", picks=picks,
                 psnr_cuda=gpu.psnr_per_frame.mean().item(),
                 psnr_cpu=cpu.psnr_per_frame.mean().item(), cpu_seconds=cpu_s,
                 launches=counts, **fields)
            require(picks["cuda"]["pick"] == picks["cpu"]["pick"],
                    f"ddnet_parity {name}: picks differ {picks}")
            require(float(dpsnr.max()) <= 0.05 and dx <= 1e-3,
                    f"ddnet_parity {name}: dPSNR {float(dpsnr.max())} dB, max |dx| {dx}")

    # -------------------------------------------------------------- ddnet
    if "ddnet" in phases:
        prior = fastdvd_prior(FastDVDnet(**modes["bf16"]))
        dm = ddnet_demosaic(DDnet(dtype=torch.bfloat16), ddnet_params)
        for style in ("smooth", "leaves"):
            sc = make_scene(b=8, h=512, w=512, seed=42, style=style)
            warm = gap_tv(sc.meas, sc.mask, GapTVConfig(iters=40), orig_bayer=sc.orig_bayer,
                          device="cuda")
            warm_psnr = warm.psnr_per_frame.mean().item()
            secs = []
            for rep in range(DDNET_RUNS[style]):  # one warm-up, then timed
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                cuda_kernels.reset_launches()
                t0 = time.perf_counter()
                res = run_row(sc, prior, dm, "cuda")
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                counts = dict(cuda_kernels.launches)
                require(counts == DDNET_LAUNCHES, f"ddnet {style}: launches {counts}")
                by_shape = dict(cuda_kernels.convpair_launches)
                require(by_shape == {shp: 144 for shp in CONVPAIR_MAIN_SHAPES.values()},
                        f"ddnet {style}: conv pair launches {by_shape}")
                report.setdefault("launches_ddnet", counts)
                report.setdefault("launches_convpair_ddnet", by_shape)
                if rep or DDNET_RUNS[style] == 1:
                    secs.append(dt)
            peak = torch.cuda.max_memory_allocated()
            require(tuple(res.x_bayer.shape) == (8, 512, 512)
                    and tuple(res.x_rgb.shape) == (8, 512, 512, 3), "ddnet: shapes")
            require(bool(torch.isfinite(res.x_bayer).all() & torch.isfinite(res.x_rgb).all()),
                    f"ddnet {style}: non-finite output")
            require(tuple(res.resid_trace.shape) == (37,), "ddnet: guard candidates")
            med = statistics.median(secs)
            emit("ddnet", scene=style, mode="bf16 DDnet + bf16 FastDVDnet (remat off)",
                 shape=[8, 512, 512], config='admm_config_for("Bosphorus", "fastdvd", True)',
                 weights="weights/ddnet.npz, weights/fastdvd.npz", seconds_per_snapshot=med,
                 seconds_runs=secs, frames_per_s=8 / med, warm_start_psnr_db=warm_psnr,
                 warm_start_ssim=warm.ssim_per_frame.mean().item(),
                 psnr_db=res.psnr_per_frame.mean().item(), ssim=res.ssim_per_frame.mean().item(),
                 gain_over_warm_start_db=res.psnr_per_frame.mean().item() - warm_psnr,
                 guard=guard_pick(res), peak_mem_bytes=peak,
                 launches_per_reconstruction=counts, **card)
            if style != "smooth":
                continue
            ddnet_calls = 37  # 36 iterations and the guard's candidate 0
            parts = {**ddnet_breakdown(torch, sc, ddnet_params, row),
                     **fastdvd_breakdown(torch, sc, fastdvd_params, torch.bfloat16, False)}
            emit("ddnet_breakdown", **parts, ddnet_calls=ddnet_calls,
                 ddnet_share_of_wall=ddnet_calls * parts["ddnet_bf16_ms"] / (med * 1e3),
                 **card)
            if "profiles" in phases:
                cuda_kernels.reset_launches()
                emit("ddnet_profile", **flagship_profile(
                    torch, lambda: run_row(sc, prior, dm, "cuda"), None), **card)
                require(dict(cuda_kernels.launches) == DDNET_LAUNCHES,
                        f"ddnet profile: launches {cuda_kernels.launches}")
            # the same row with the demosaicker adapted in the loop, at the
            # pipeline's defaults (one Adam step an iteration, carried Adam)
            # (one run, its first: the backward of bf16 DDnet at 512^2 is new here)
            spec = make_dm_spec(DDnet(dtype=torch.bfloat16), **DM_UPDATE)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            upd = run_row_dm_update(sc, prior, spec, "cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = dict(cuda_kernels.launches)
            require(counts == DDNET_LAUNCHES, f"ddnet dm_update: launches {counts}")
            require(bool(torch.isfinite(upd.x_bayer).all()), "ddnet dm_update: non-finite")
            emit("ddnet_dm_update", scene=style, lr=DM_UPDATE["lr"],
                 steps_per_iteration=DM_UPDATE["update_per_iter"], optimizer="carried Adam",
                 first_run_seconds_per_snapshot=secs,
                 psnr_db=upd.psnr_per_frame.mean().item(), ssim=upd.ssim_per_frame.mean().item(),
                 guard=guard_pick(upd), peak_mem_bytes=torch.cuda.max_memory_allocated(),
                 launches_per_reconstruction=counts, **card)

    # ------------------------------------------------------ drivers parity
    def second_measurement(sc, style="leaves"):
        """A second snapshot of another scene under the first scene's masks."""
        other = make_scene(b=sc.mask.shape[0], h=sc.mask.shape[1], w=sc.mask.shape[2],
                           seed=43, style=style)
        return (sc.mask * other.orig_bayer).sum(0).astype(np.float32), other.orig_bayer

    def warm_starts(y_seq, mask, device):
        return torch.stack([gap_tv(y, mask, GapTVConfig(iters=40), device=device).x_bayer
                            for y in y_seq])

    if "drivers_parity" in phases:
        sc = make_scene(b=8, h=64, w=64, seed=42)
        y2, o2 = second_measurement(sc)
        y_seq, o_seq = np.stack([sc.meas, y2]), np.stack([sc.orig_bayer, o2])
        ffd_params = ffdnet_from_flax(flax_style_ffdnet_params(16, 4, seed=0))
        ffd = ffdnet_prior(FFDNet(nc=16, nb=4))
        flagship_adapt = dict(lr=2e-6, update_per_iter=2, interval_iter=15, initial_iter=1)
        carried = ADMMConfig(sigma=SIGMA, iters=ITERS, adapt=AdaptConfig(
            **flagship_adapt, fresh_opt_per_trigger=False))
        big = make_scene(b=8, h=128, w=128, seed=42)
        tiled_cfg = ADMMConfig(sigma=FASTDVD_SIGMA, iters=(6, 4), denoiser="fastdvd",
                               adapt=AdaptConfig(lr=2e-7, update_per_iter=2, interval_iter=5),
                               select_best=True, select_best_holdout=0.05)
        fdvd32 = fastdvd_prior(FastDVDnet())

        def tiled_run(dev):
            warm = gap_tv(big.meas, big.mask, GapTVConfig(iters=40), device=dev)
            return two_stage_admm_tiled(
                big.meas, big.mask, tiled_cfg, tile=64, prior=fdvd32, params=fastdvd_params,
                orig_bayer=big.orig_bayer, x0_bayer=warm.x_bayer, overlap=8, tile_chunk=2,
                generator=torch.Generator().manual_seed(0), device=dev)

        def sequence_run(dev):
            x0 = warm_starts(y_seq, sc.mask, dev)
            return two_stage_admm_sequence(y_seq, sc.mask, carried, ffd, ffd_params, x0, o_seq,
                                           device=dev)

        def batched_run(dev):
            x0 = warm_starts(y_seq, sc.mask, dev)
            return two_stage_admm_batched(y_seq, sc.mask, ADMMConfig(sigma=SIGMA, iters=ITERS),
                                          ffd, ffd_params, x0, o_seq, device=dev)

        def gap_deep_run(dev):
            return gap_deep(sc.meas, sc.mask, GapDeepConfig(
                sigma=(25 / 255, 12 / 255), iters=(6, 4), lam=0.8,
                adapt=AdaptConfig(lr=2e-6, interval_iter=5, fresh_opt_per_trigger=False)),
                ffd, ffd_params, orig_bayer=sc.orig_bayer, device=dev)

        def menon_run(dev):
            warm = gap_tv(sc.meas, sc.mask, GapTVConfig(iters=40), device=dev)
            return two_stage_admm(sc.meas, sc.mask, ADMMConfig(
                sigma=SIGMA, iters=ITERS, demosaic_method="menon2007",
                adapt=AdaptConfig(**flagship_adapt)), ffd, ffd_params, warm.x_bayer,
                sc.orig_bayer, device=dev)

        def gray_run(dev):
            return gap_denoise_gray(sc.meas, sc.mask, GrayConfig(iters=(40,)),
                                    orig=sc.orig_bayer, device=dev)

        cases = {
            # 40 warm-start x-updates and TV proxes at 128^2; 2 groups of 2
            # windows of 80 (tile 64, overlap 8): 10 ADMM and 40 masked GAP-TV
            # x-updates and 40 TV proxes each (the guard's candidate 0)
            "tiled": (tiled_run, {"x_update": 40 + 2 * (10 + 40), "tv_chambolle": 40 + 2 * 40,
                                  "convpair": 0}),
            "sequence": (sequence_run, SEQUENCE_LAUNCHES),
            # the two measurements' ADMM iterations in lockstep: 25 launches
            "batched": (batched_run, {"x_update": 2 * 40 + 25, "tv_chambolle": 2 * 40,
                                      "convpair": 0}),
            "gap_deep": (gap_deep_run, {"x_update": 10, "tv_chambolle": 0, "convpair": 0}),
            "menon2007": (menon_run, {"x_update": 65, "tv_chambolle": 40, "convpair": 0}),
            "gray": (gray_run, {"x_update": 0, "tv_chambolle": 40, "convpair": 0}),
        }
        db_bar, dx_bar = DRIVERS_PARITY_BAR
        for name, (run, want_counts) in cases.items():
            t0 = time.perf_counter()
            cpu = run("cpu")
            cpu_s = time.perf_counter() - t0
            cuda_kernels.reset_launches()
            gpu = run("cuda")
            torch.cuda.synchronize()
            counts = dict(cuda_kernels.launches)
            require(counts == want_counts, f"drivers_parity {name}: launches {counts}")
            xg, xc = (gpu.x, cpu.x) if name == "gray" else (gpu.x_bayer, cpu.x_bayer)
            require(bool(torch.isfinite(xg).all()), f"drivers_parity {name}: non-finite")
            dpsnr = float((gpu.psnr_per_frame.cpu() - cpu.psnr_per_frame).abs().max())
            dx = float((xg.cpu() - xc).abs().max())
            fields = {}
            if getattr(gpu, "resid_trace", None) is not None:
                picks = {d: [int(i) for i in r.resid_trace.cpu().reshape(
                    -1, r.resid_trace.shape[-1]).argmin(-1)] for d, r in (("cuda", gpu), ("cpu", cpu))}
                fields["picks"] = picks
                require(picks["cuda"] == picks["cpu"], f"drivers_parity {name}: picks {picks}")
            if getattr(gpu, "variables", None) is not None and name != "batched":
                fields["max_abs_d_variables"] = max(
                    float((gpu.variables[k].cpu() - cpu.variables[k]).abs().max())
                    for k in cpu.variables)
            emit("drivers_parity", case=name, dtype="float32", max_dpsnr_db=dpsnr,
                 max_abs_dx=dx, bar=f"{db_bar} dB, {dx_bar}, the same pick",
                 psnr_cuda=gpu.psnr_per_frame.mean().item(),
                 psnr_cpu=cpu.psnr_per_frame.mean().item(), cpu_seconds=cpu_s,
                 launches=counts, **fields)
            require(dpsnr <= db_bar and dx <= dx_bar,
                    f"drivers_parity {name}: dPSNR {dpsnr} dB, max |dx| {dx}")

    # --------------------------------------------------------------- tiled
    if "tiled" in phases:
        import adaptivepnp_sci_torch.solvers.two_stage_admm as admm_mod

        size, tile = TILED["size"], TILED["tile"]
        sc = make_scene(b=8, h=size, w=size, seed=42)
        prior = fastdvd_prior(FastDVDnet(**modes["bf16"]))
        cfg = ADMMConfig(sigma=FASTDVD_SIGMA, iters=FASTDVD_ITERS, denoiser="fastdvd",
                         adapt=AdaptConfig(**FASTDVD_ADAPT))
        group_ms: list[float] = []
        run_admm = admm_mod.run_admm

        def timed_run_admm(*a, **kw):
            # the time of each group of tiles (one run_admm call), host clock
            # between two synchronisations
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_admm(*a, **kw)
            torch.cuda.synchronize()
            group_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def snapshot(chunk):
            warm = gap_tv(sc.meas, sc.mask, GapTVConfig(iters=40), orig_bayer=sc.orig_bayer,
                          device="cuda")
            res = two_stage_admm_tiled(
                sc.meas, sc.mask, cfg, tile=tile, prior=prior, params=fastdvd_params,
                orig_bayer=sc.orig_bayer, x0_bayer=warm.x_bayer, tile_chunk=chunk,
                generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
            return warm, res

        admm_mod.run_admm = timed_run_admm
        try:
            for chunk in (TILED["tile_chunk"], 4):
                secs, groups = [], []
                # one timed run each: the fastdvd phase's bf16 runs have warmed
                # the same kernels and models at the tiles' shapes, and the run
                # of 2 those of 4
                reps = 1
                for rep in range(reps):
                    group_ms.clear()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    cuda_kernels.reset_launches()
                    t0 = time.perf_counter()
                    warm, res = snapshot(chunk)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    counts = dict(cuda_kernels.launches)
                    require(counts == TILED_LAUNCHES[chunk],
                            f"tiled chunk {chunk}: launches {counts}")
                    by_shape = dict(cuda_kernels.convpair_launches)
                    require(by_shape == {shp: 16 * 36 * 4 for shp in CONVPAIR_MAIN_SHAPES.values()},
                            f"tiled chunk {chunk}: conv pair launches {by_shape}")
                    if chunk == TILED["tile_chunk"]:
                        report.setdefault("launches_tiled", counts)
                        report.setdefault("launches_convpair_tiled", by_shape)
                    if rep or reps == 1:
                        secs.append(dt)
                        groups.append(list(group_ms))
                peak = torch.cuda.max_memory_allocated()
                # the ``parallel`` phase's reference (4) and its wrong run (2)
                report[f"tiled_chunk{chunk}"] = {
                    "psnr": res.psnr_per_frame.cpu().numpy(), "seconds": secs[-1],
                    "variables": _flat_variables(res.variables),
                    "x_bayer": res.x_bayer.cpu().numpy() if chunk == 4 else None}
                require(tuple(res.x_bayer.shape) == (8, size, size)
                        and tuple(res.x_rgb.shape) == (8, size, size, 3), "tiled: shapes")
                require(bool(torch.isfinite(res.x_bayer).all() & torch.isfinite(res.x_rgb).all()),
                        f"tiled chunk {chunk}: non-finite output")
                require(set(res.variables) == set(fastdvd_params)
                        and res.variables["temp1.inc.convblock.0.weight"].shape
                        == fastdvd_params["temp1.inc.convblock.0.weight"].shape,
                        "tiled: the shared weights are not one copy")
                moved = max(float((res.variables[k].cpu() - fastdvd_params[k]).abs().max())
                            for k in fastdvd_params if k.endswith("weight"))
                require(moved > 0, "tiled: the adaptation did not move the weights")
                med = statistics.median(secs)
                warm_psnr = warm.psnr_per_frame.mean().item()
                emit("tiled", shape=[8, size, size], tile=tile, overlap=0, tile_chunk=chunk,
                     groups=16 // chunk, mode="bf16 FastDVDnet (remat off), adaptation shared "
                     "over tiles", weights="weights/fastdvd.npz",
                     seconds_per_snapshot=med, seconds_runs=secs, frames_per_s=8 / med,
                     group_ms=groups[-1], group_ms_median=statistics.median(groups[-1]),
                     warm_start_psnr_db=warm_psnr, psnr_db=res.psnr_per_frame.mean().item(),
                     ssim=res.ssim_per_frame.mean().item(),
                     gain_over_warm_start_db=res.psnr_per_frame.mean().item() - warm_psnr,
                     max_abs_weight_change=moved, peak_mem_bytes=peak,
                     launches_per_snapshot=counts, **card)
        finally:
            admm_mod.run_admm = run_admm
        with torch.no_grad():
            warm_ms = time_ms(lambda: gap_tv(sc.meas, sc.mask, GapTVConfig(iters=40),
                                             device="cuda"), n=3)
        emit("tiled_breakdown", warm_start_2048_40_ms=warm_ms, **card)
        if "seams" in phases:  # its scene and run
            report["tiled_run"] = (sc, prior, cfg)
        del sc, warm, res

    # ------------------------------------------------------------ sequence
    if "sequence" in phases:
        params = ffdnet_from_flax(flax_style_ffdnet_params(96, 12, seed=0))
        prior = ffdnet_prior(FFDNet(nc=96, nb=12))
        sc = make_scene(b=8, h=512, w=512, seed=42)
        y2, o2 = second_measurement(sc)
        y_seq, o_seq = np.stack([sc.meas, y2]), np.stack([sc.orig_bayer, o2])
        cfg = ADMMConfig(sigma=SIGMA, iters=ITERS, adapt=AdaptConfig(
            lr=2e-6, update_per_iter=2, interval_iter=15, initial_iter=1,
            fresh_opt_per_trigger=False))

        def run_sequence(y, o):
            x0 = warm_starts(y, sc.mask, "cuda")
            return two_stage_admm_sequence(y, sc.mask, cfg, prior, params, x0, o, device="cuda")

        secs = []
        for rep in range(2):  # one warm-up, then one timed
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            res = run_sequence(y_seq, o_seq)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts = dict(cuda_kernels.launches)
            require(counts == SEQUENCE_LAUNCHES, f"sequence: launches {counts}")
            report.setdefault("launches_sequence", counts)
        peak = torch.cuda.max_memory_allocated()
        first = run_sequence(y_seq[:1], o_seq[:1])
        require(tuple(res.x_bayer.shape) == (2, 8, 512, 512), "sequence: shapes")
        require(bool(torch.isfinite(res.x_bayer).all()), "sequence: non-finite output")
        # the first measurement of the pair is the sequence of one (up to the
        # library's nondeterministic backward sums)
        first_dx = float((first.x_bayer[0] - res.x_bayer[0]).abs().max())
        require(first_dx <= 1e-3, f"sequence: the first measurement moved by {first_dx}")
        require(int(res.opt_state["state"][0]["step"]) == 4, "sequence: the Adam was not carried")
        delta = max(float((res.variables[k] - first.variables[k]).abs().max()) for k in params)
        delta0 = max(float((first.variables[k].cpu() - params[k]).abs().max()) for k in params)
        require(delta > 0, "sequence: the second measurement did not adapt")
        emit("sequence", shape=[2, 8, 512, 512], ffdnet={"nc": 96, "nb": 12},
             weights="random, Flax default init from numpy seed 0", optimizer="carried Adam",
             seconds_per_measurement=secs[1] / 2, seconds_runs=secs,
             psnr_db=[float(p) for p in res.psnr_per_frame.mean(-1)],
             max_abs_weight_delta_second_from_first=delta,
             max_abs_weight_delta_first_from_start=delta0, first_measurement_max_abs_dx=first_dx,
             adam_steps=int(res.opt_state["state"][0]["step"]), peak_mem_bytes=peak,
             launches=counts, **card)

    # ----------------------------------------------------- pipeline_parity
    if "pipeline_parity" in phases:
        from adaptivepnp_sci_torch.data.mat_io import SceneData
        from adaptivepnp_sci_torch.pipelines import (
            holdout_cv_residuals,
            probe_demosaic_residuals,
            run_reconstruction,
            select_demosaicker,
            select_prior_variables,
        )

        sc = make_scene(b=8, h=64, w=64, seed=42, n_meas=2)
        scene = SceneData("Bosphorus", np.transpose(sc.meas, (2, 0, 1)).astype(np.float32),
                          sc.mask, sc.orig_bayer)
        ffd_params = ffdnet_from_flax(flax_style_ffdnet_params(16, 4, seed=0))
        ffd = ffdnet_prior(FFDNet(nc=16, nb=4))
        lr = 2e-6
        cfg = ADMMConfig(sigma=SIGMA, iters=ITERS, adapt=AdaptConfig(
            lr=lr, update_per_iter=2, interval_iter=15, initial_iter=1))
        db_bar, dx_bar, dw_bar = PIPELINE_PARITY_BAR
        for name, kw in PIPELINE_PARITY_RUNS.items():
            t0 = time.perf_counter()
            cpu = run_reconstruction(scene, ffd, ffd_params, config=cfg, device="cpu", **kw)
            cpu_s = time.perf_counter() - t0
            cuda_kernels.reset_launches()
            gpu = run_reconstruction(scene, ffd, ffd_params, config=cfg, device="cuda", **kw)
            torch.cuda.synchronize()
            counts = dict(cuda_kernels.launches)
            require(counts == PIPELINE_PARITY_LAUNCHES, f"pipeline_parity {name}: launches {counts}")
            require(bool(np.isfinite(gpu.x_bayer).all()), f"pipeline_parity {name}: non-finite")
            dpsnr = float(np.abs(gpu.psnr - cpu.psnr).max())
            dx = float(np.abs(gpu.x_bayer - cpu.x_bayer).max())
            dw = max(float((gpu.variables[k].cpu() - cpu.variables[k]).abs().max())
                     for k in cpu.variables) / lr
            moved = max(float((cpu.variables[k] - ffd_params[k]).abs().max())
                        for k in ffd_params) / lr
            emit("pipeline_parity", case=name, shape=[2, 8, 64, 64], dtype="float32",
                 max_dpsnr_db=dpsnr, max_abs_dx=dx, carried_weights_gap_lr=dw,
                 carried_weights_moved_lr=moved,
                 bar=f"{db_bar} dB, {dx_bar}, weights within {dw_bar} lr",
                 psnr_cuda=float(gpu.psnr.mean()), psnr_cpu=float(cpu.psnr.mean()),
                 cpu_seconds=cpu_s, launches=counts)
            require(dpsnr <= db_bar and dx <= dx_bar and dw <= dw_bar and moved > 0,
                    f"pipeline_parity {name}: dPSNR {dpsnr} dB, max |dx| {dx}, weights {dw} lr")
        # the ground-truth-free choices: the same residual ranking on both sides
        dd_params = ddnet_from_flax(load_variables_npz(str(ROOT / "weights" / "ddnet.npz")))
        natural = fastdvdnet_from_flax(load_variables_npz(str(ROOT / "weights" / "fastdvd.npz")))
        smooth = fastdvdnet_from_flax(
            load_variables_npz(str(ROOT / "weights" / "fastdvd_smooth.npz")))
        ffd_short = ADMMConfig(sigma=(25 / 255, 12 / 255), iters=(6, 4))
        fdvd_short = ADMMConfig(sigma=FASTDVD_SIGMA, iters=(6, 4), denoiser="fastdvd")
        fdvd32 = fastdvd_prior(FastDVDnet())
        resids = {}
        for d in ("cpu", "cuda"):
            x0 = gap_tv(scene.meas[0], scene.mask, GapTVConfig(iters=40), device=d).x_bayer
            resids[d] = {
                "demosaicker": probe_demosaic_residuals(
                    scene.meas[0], scene.mask, x0, ffd, ffd_params, DDnet(), dd_params,
                    ffd_short, ffd_short, device=d),
                "prior_variables": holdout_cv_residuals(
                    scene.meas[0], scene.mask, x0,
                    [dict(config=fdvd_short, prior=fdvd32, variables=v)
                     for v in (natural, smooth)], device=d)}
        picks = {d: {"demosaicker": "malvar" if r["demosaicker"][0] <= r["demosaicker"][1]
                     else "ddnet",
                     "prior_variables": ["natural", "smooth"][
                         int(np.argmin(r["prior_variables"]))]}
                 for d, r in resids.items()}
        picks["cuda_select"] = {
            "demosaicker": select_demosaicker(scene, ffd, ffd_params, DDnet(), dd_params,
                                              config_malvar=ffd_short, config_ddnet=ffd_short,
                                              device="cuda"),
            "prior_variables": select_prior_variables(
                scene, fdvd32, {"natural": natural, "smooth": smooth}, config=fdvd_short,
                device="cuda")}
        rel = {k: float(np.max(np.abs(np.subtract(resids["cuda"][k], resids["cpu"][k]))
                              / np.abs(resids["cpu"][k])))
               for k in resids["cpu"]}
        emit("pipeline_parity", case="selection", residuals=resids, max_rel_dresid=rel,
             bar=f"residuals within {PIPELINE_RESID_RTOL} relative, the same picks",
             picks=picks)
        require(max(rel.values()) <= PIPELINE_RESID_RTOL,
                f"pipeline_parity: residuals card vs CPU {rel}")
        require(picks["cuda"] == picks["cpu"] == picks["cuda_select"],
                f"pipeline_parity: picks {picks}")

    # ----------------------------------------------------------------- cli
    if "cli" in phases:
        import contextlib
        import io
        import re
        import shutil
        import tempfile

        import scipy.io as sio

        from adaptivepnp_sci_torch import cli as port_cli
        from adaptivepnp_sci_torch.data.mat_io import load_cacti_mat, load_warm_start
        from adaptivepnp_sci_torch.utils.image import calculate_psnr

        def run_cli(step: str, argv: list[str]) -> tuple[str, float]:
            """One subcommand in this process, its launches counted from 0."""
            buf = io.StringIO()
            torch.cuda.synchronize()
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                port_cli.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = dict(cuda_kernels.launches)
            require(counts == CLI_LAUNCHES[step], f"cli {step}: launches {counts}")
            for k, v in counts.items():
                cli_counts[k] += v
            for shape, v in cuda_kernels.convpair_launches.items():
                cli_shapes[shape] = cli_shapes.get(shape, 0) + v
            return buf.getvalue(), secs

        cli_counts = {"x_update": 0, "tv_chambolle": 0, "convpair": 0}
        cli_shapes: dict[tuple[int, int, int], int] = {}
        with tempfile.TemporaryDirectory() as d:
            s, w, r, r0 = (str(Path(d) / f) for f in ("s.mat", "w.mat", "r.mat", "r0.mat"))
            watch, out_dir = Path(d) / "in", Path(d) / "out"
            steps: dict[str, dict] = {}
            _, t = run_cli("synth", ["synth", "--out", s, "--size", str(CLI_SIZE), "--frames", "8",
                                     "--n-meas", str(CLI_N_MEAS), "--seed", "42"])
            steps["synth"] = {"seconds": t}
            text, t = run_cli("warmstart", ["warmstart", "--data", s, "--out", w])
            steps["warmstart"] = {"seconds": t, "out": text.strip()}
            fdvd = ["--data", s, "--warm", w, "--denoiser", "fastdvd", "--bf16",
                    "--name", "Bosphorus"]
            text, t = run_cli("reconstruct", ["reconstruct", *fdvd, "--out", r0])
            steps["reconstruct"] = {"seconds": t, "out": text.strip()}
            text, t = run_cli("reconstruct_auto", ["reconstruct", *fdvd, "--ckpt", "auto",
                                                   "--auto-demosaic", "--out", r])
            steps["reconstruct_auto"] = {"seconds": t, "out": text.strip()}
            eval_text, t = run_cli("eval", ["eval", r, "--data", s])
            steps["eval"] = {"seconds": t}
            watch.mkdir()
            for f in ("a.mat", "b.mat"):
                shutil.copy(s, watch / f)
            serve_text, t = run_cli("serve", [
                "serve", "--watch", str(watch), "--out", str(out_dir), "--denoiser", "fastdvd",
                "--bf16", "--scene", "Bosphorus", "--once", "--carry-weights", "--poll", "0.1"])
            steps["serve"] = {"seconds": t, "out": serve_text.strip()}
            for f in (s, w, r, r0, out_dir / "a.mat", out_dir / "b.mat"):
                require(Path(f).exists(), f"cli: {f} was not written")
            # serve reports a bad file and goes on: hold each file's result here
            require("FAILED" not in serve_text, f"cli serve: {serve_text}")
            psnrs = {}
            for label, f in (("reconstruct", r0), ("reconstruct_auto", r),
                             ("serve_a", out_dir / "a.mat"), ("serve_b", out_dir / "b.mat")):
                res = sio.loadmat(str(f))
                x, p = res["v_recon_bayer"], res["psnr"]
                require(x.shape == (CLI_SIZE, CLI_SIZE, 8 * CLI_N_MEAS)
                        and bool(np.isfinite(x).all()), f"cli: {f} holds {x.shape}")
                require(p.shape == (CLI_N_MEAS, 8) and bool(np.all(np.isfinite(p) & (p > 0))),
                        f"cli: {f} PSNR {p}")
                psnrs[label] = float(p.mean())
            # the leaves scene: the guard picks an ADMM iterate, so the stored
            # result is the solve's own and must beat its warm start
            ls, lw, lres = (str(Path(d) / f) for f in ("l.mat", "lw.mat", "lr.mat"))
            _, t = run_cli("synth_leaves", ["synth", "--out", ls, "--size", str(CLI_SIZE),
                                            "--frames", "8", "--n-meas", "1", "--seed", "42",
                                            "--style", "leaves"])
            steps["synth_leaves"] = {"seconds": t}
            text, t = run_cli("warmstart_leaves", ["warmstart", "--data", ls, "--out", lw])
            steps["warmstart_leaves"] = {"seconds": t, "out": text.strip()}
            text, t = run_cli("reconstruct_leaves", [
                "reconstruct", "--data", ls, "--warm", lw, "--denoiser", "fastdvd", "--bf16",
                "--deep-demosaicking", "--name", "Bosphorus", "--out", lres])
            steps["reconstruct_leaves"] = {"seconds": t, "out": text.strip()}
            truth = load_cacti_mat(ls, name="leaves").orig_bayer[0]
            x_w = load_warm_start(lw, 8)[0]
            x_r = np.transpose(sio.loadmat(lres)["v_recon_bayer"], (2, 0, 1))
            require(x_r.shape == x_w.shape == truth.shape and bool(np.isfinite(x_r).all()),
                    f"cli leaves: {x_r.shape}")
            leaves = {"warm_start_psnr_db": float(np.mean([calculate_psnr(
                          x_w[b] * 255.0, truth[b] * 255.0) for b in range(8)])),
                      "psnr_db": float(np.mean([calculate_psnr(
                          x_r[b] * 255.0, truth[b] * 255.0) for b in range(8)])),
                      "max_abs_dx_from_warm_start": float(np.abs(x_r - x_w).max())}
            require(leaves["max_abs_dx_from_warm_start"] > 0
                    and leaves["psnr_db"] > leaves["warm_start_psnr_db"],
                    f"cli leaves: the result is the warm start or below it {leaves}")
            stored = re.search(r"mean:\s+PSNR\s+(\S+) dB", eval_text)
            recomputed = re.search(r"recomputed vs ground truth: PSNR\s+(\S+) dB", eval_text)
            require(stored is not None and recomputed is not None, f"cli eval: {eval_text}")
            gap = abs(float(stored.group(1)) - float(recomputed.group(1)))
            require(gap <= 0.5 and "WARNING" not in eval_text, f"cli eval: {eval_text}")
        per_meas = {k: v["seconds"] / (2 * CLI_N_MEAS if k == "serve" else
                                       1 if k.endswith("_leaves") else CLI_N_MEAS)
                    for k, v in steps.items()}
        picks = dict(re.findall(r"(auto-ckpt|auto-demosaic): (\S+)",
                                steps["reconstruct_auto"]["out"]))
        report["launches_cli"] = cli_counts
        report["launches_convpair_cli"] = cli_shapes
        emit("cli", shape=[CLI_N_MEAS, 8, CLI_SIZE, CLI_SIZE], seconds_per_measurement=per_meas,
             steps=steps, picks=picks, psnr_db=psnrs, leaves=leaves,
             eval_stored_vs_recomputed_db=gap,
             launches=cli_counts, launches_by_step=CLI_LAUNCHES, **card)

    # -------------------------------------------------------- train_parity
    if "train_parity" in phases:
        from adaptivepnp_sci_torch.models.ffdnet import ffdnet_color
        from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32
        from adaptivepnp_sci_torch.train import Trainer, TrainerConfig
        from adaptivepnp_sci_torch.train import tasks as train_tasks
        from adaptivepnp_sci_torch.train.regularizers import svd_orthogonalize

        tp = TRAIN_PARITY
        fdvd_sd = fastdvdnet_from_flax(load_variables_npz(str(ROOT / "weights" / "fastdvd.npz")))
        cases = {
            "ffdnet": (train_tasks.ffdnet_task(ffdnet_color()),
                       ffdnet_from_flax(flax_style_ffdnet_params(96, 12, seed=0)), 1),
            "fastdvd": (train_tasks.fastdvd_task(FastDVDnet()), fdvd_sd, 5),
            "ddnet": (train_tasks.ddnet_task(DDnet()),
                      ddnet_from_flax(load_variables_npz(str(ROOT / "weights" / "ddnet.npz"))), 5),
        }
        cfg = TrainerConfig(lr=tp["lr"], steps_per_epoch=1, milestones=(0, 1))
        bars = TRAIN_PARITY_BAR
        for name, (task, sd, length) in cases.items():
            g = torch.Generator().manual_seed(7)
            shape = (tp["batch"], length, tp["patch"], tp["patch"], 3)
            batches = [torch.rand(shape, generator=g).numpy() for _ in range(tp["steps"])]
            if length == 1:
                batches = [b[:, 0] for b in batches]
            runs = {}
            for d in ("cpu", "cuda"):
                tr = Trainer(task, sd, cfg, device=d)
                tr.generator = torch.Generator().manual_seed(11)  # the same draws on both sides
                t0 = time.perf_counter()
                losses = tr.fit(iter(batches[:1]), max_steps=1, log_every=10**9)
                grads = {k: p.grad.detach().cpu().clone() for k, p in tr.net.named_parameters()}
                losses += tr.fit(iter(batches[1:]), max_steps=tp["steps"], log_every=10**9)
                if d == "cuda":
                    torch.cuda.synchronize()
                runs[d] = (losses, grads, {k: v.cpu() for k, v in tr.variables.items()},
                           time.perf_counter() - t0)
            (lc, gc, vc, _), (lg, gg, vg, secs) = runs["cpu"], runs["cuda"]
            names = list(gc)
            readings = {
                "step1_loss_rel": abs(lg[0] - lc[0]) / abs(lc[0]),
                "step1_grad_rel": max(float((gg[k] - gc[k]).abs().max() / gc[k].abs().max())
                                      for k in names),
                "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(lg, lc))}
            dparams = torch.cat([(vg[k] - vc[k]).abs().reshape(-1) for k in names])
            readings["params_abs"] = float(dparams.max())
            readings["params_frac_over"] = float((dparams > bars["params_abs"]).double().mean())
            stats = [k for k in vc if k.endswith(("running_mean", "running_var"))]
            readings["stats_rel"] = (max(float((vg[k] - vc[k]).abs().max()) for k in stats)
                                     / max(float(vc[k].abs().max()) for k in stats)
                                     if stats else 0.0)
            moved = max(float((vc[k] - sd[k]).abs().max()) for k in names)
            emit("train_parity", task=name, shape=list(shape), steps=tp["steps"], dtype="float32",
                 losses_cuda=lg, losses_cpu=lc, **readings, n_params=dparams.numel(),
                 params_moved=moved, cuda_seconds=secs, bar=bars)
            ok = all(readings[k] <= bars[k] for k in readings if k != "params_abs")
            require(ok and readings["params_abs"] <= tp["steps"] * tp["lr"]
                    and moved > 0.5 * tp["lr"], f"train_parity {name}: {readings}")
        nets = {}
        for d in ("cpu", "cuda"):
            net = FastDVDnet().to(d)
            net.load_state_dict(fdvd_sd)
            with full_f32():
                svd_orthogonalize(net)
            nets[d] = {k: v.detach().cpu() for k, v in net.named_parameters()}
        svd_abs = max(float((nets["cuda"][k] - nets["cpu"][k]).abs().max()) for k in nets["cpu"])
        emit("train_parity", case="svd_orthogonalize", model="FastDVDnet", max_abs_err=svd_abs,
             bar=bars["svd_abs"])
        require(svd_abs <= bars["svd_abs"], f"train_parity svd_orthogonalize: {svd_abs}")

    # --------------------------------------------------------------- train
    if "train" in phases:
        import contextlib
        import io
        import re
        import tempfile

        from adaptivepnp_sci_torch import cli as port_cli
        from adaptivepnp_sci_torch.train import Trainer

        def run_train_cli(step: str, argv: list[str]) -> tuple[str, float]:
            """One subcommand in this process, its launches counted from 0."""
            buf = io.StringIO()
            torch.cuda.synchronize()
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                port_cli.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = dict(cuda_kernels.launches)
            require(counts == TRAIN_LAUNCHES[step], f"train {step}: launches {counts}")
            for k, v in counts.items():
                train_counts[k] += v
            for shape, v in cuda_kernels.convpair_launches.items():
                train_shapes[shape] = train_shapes.get(shape, 0) + v
            return buf.getvalue(), secs

        # each step synchronised and timed on the host clock
        step_log: list[tuple[float, float]] = []
        plain_step = Trainer.train_step

        def timed_step(self, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = plain_step(self, batch)
            torch.cuda.synchronize()
            step_log.append((time.perf_counter() - t0, float(loss)))
            return loss

        train_counts = {"x_update": 0, "tv_chambolle": 0, "convpair": 0}
        train_shapes: dict[tuple[int, int, int], int] = {}
        networks: dict[str, dict] = {}
        with tempfile.TemporaryDirectory() as d:
            Trainer.train_step = timed_step
            try:
                for net, steps in TRAIN_STEPS.items():
                    step_log.clear()
                    torch.cuda.reset_peak_memory_stats()
                    text, t = run_train_cli(f"train_{net}", [
                        "train", "--network", net, "--steps", str(steps), "--batch",
                        str(TRAIN_BATCH), "--patch", str(TRAIN_PATCH), "--ckpt-dir",
                        str(Path(d) / net)])
                    times = [s for s, _ in step_log]
                    losses = [l for _, l in step_log]
                    require(len(times) == steps and all(np.isfinite(losses)),
                            f"train {net}: {len(times)} steps, losses {losses}")
                    networks[net] = {
                        "seconds_per_step": statistics.mean(times[TRAIN_WARMUP:]),
                        "first_step_seconds": times[0],
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "first_losses": losses[:5], "last_losses": losses[-5:],
                        "command_seconds": t, "out": text.strip().splitlines()[-1]}
            finally:
                Trainer.train_step = plain_step
            fd = networks["fastdvd"]
            require(statistics.mean(fd["last_losses"]) < statistics.mean(fd["first_losses"]),
                    f"train fastdvd: the loss did not fall {fd}")
            final = str(Path(d) / "fastdvd" / "final.pt")
            text, t = run_train_cli("denoise", ["denoise", "--network", "fastdvd", "--ckpt", final])
            got = re.search(r"noisy (\S+) dB -> denoised (\S+) dB", text)
            require(got is not None, f"train denoise: {text}")
            denoise = {"noisy_db": float(got.group(1)), "denoised_db": float(got.group(2)),
                       "seconds": t}
            require(denoise["denoised_db"] > denoise["noisy_db"],
                    f"train denoise: no better than the noisy input {denoise}")
            s, w, r = (str(Path(d) / f) for f in ("s.mat", "w.mat", "r.mat"))
            _, t_synth = run_train_cli("synth", ["synth", "--out", s, "--size", str(TRAIN_SCENE),
                                                 "--frames", "8", "--n-meas", "1", "--seed", "42"])
            _, t_warm = run_train_cli("warmstart", ["warmstart", "--data", s, "--out", w])
            text, t_rec = run_train_cli("reconstruct", [
                "reconstruct", "--data", s, "--warm", w, "--denoiser", "fastdvd", "--bf16",
                "--name", "Bosphorus", "--ckpt", final, "--out", r])
            import scipy.io as sio

            x = sio.loadmat(r)["v_recon_bayer"]
            require(x.shape == (TRAIN_SCENE, TRAIN_SCENE, 8) and bool(np.isfinite(x).all()),
                    f"train reconstruct: {x.shape}")
            reconstruct = {"seconds": t_rec, "out": text.strip(), "synth_seconds": t_synth,
                           "warmstart_seconds": t_warm}
        # where a FastDVDnet step's time goes: 3 steps under the profiler (with
        # recomputation, as trained above), and steps without recomputation
        from adaptivepnp_sci_torch.train import TrainerConfig
        from adaptivepnp_sci_torch.train.tasks import fastdvd_task

        g = torch.Generator().manual_seed(3)
        clips = [torch.rand((TRAIN_BATCH, 5, TRAIN_PATCH, TRAIN_PATCH, 3), generator=g).numpy()
                 for _ in range(3)]
        breakdown = {}
        for remat in (True, False):
            tr = Trainer(fastdvd_task(FastDVDnet(remat=remat)), None, TrainerConfig(), device=dev)
            for b in clips:
                tr.train_step(b)
            if remat and "profiles" in phases:
                prof = flagship_profile(torch, lambda: [tr.train_step(b) for b in clips], None)
                breakdown["profile_3_steps"] = prof
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in clips * 2:
                tr.train_step(b)
            torch.cuda.synchronize()
            breakdown[f"seconds_per_step_remat_{remat}"] = (time.perf_counter() - t0) / 6
        report["launches_train"] = train_counts
        report["launches_convpair_train"] = train_shapes
        emit("train", batch=TRAIN_BATCH, patch=TRAIN_PATCH, steps=TRAIN_STEPS,
             warmup=TRAIN_WARMUP, networks=networks, denoise=denoise, reconstruct=reconstruct,
             fastdvd_breakdown=breakdown, launches=train_counts,
             launches_by_step=TRAIN_LAUNCHES, **card)

    # ----------------------------------------------------- the six-scene run
    if phases & {"scenes_parity", "scenes", "scenes_full"}:
        import contextlib
        import functools
        import io
        import tempfile

        import scipy.io as sio

        from adaptivepnp_sci_torch import pipelines
        from adaptivepnp_sci_torch import run_all_scenes as scenes_run

        @contextlib.contextmanager
        def counted_scenes(log: list[dict]):
            """Each warm start and each row of ``run_all_scenes.main`` with its
            launches counted from 0, its seconds and its peak memory."""
            originals = pipelines.run_warm_start, pipelines.run_reconstruction

            def counted(kind, fn):
                def run(scene, *a, **kw):
                    torch.cuda.synchronize()
                    cuda_kernels.reset_launches()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    out = fn(scene, *a, **kw)
                    torch.cuda.synchronize()
                    log.append({"kind": kind, "scene": scene.name,
                                "seconds": time.perf_counter() - t0,
                                "launches": dict(cuda_kernels.launches),
                                "shapes": dict(cuda_kernels.convpair_launches),
                                "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
                    return out
                return run

            pipelines.run_warm_start = counted("warm", originals[0])
            pipelines.run_reconstruction = counted("row", originals[1])
            try:
                yield
            finally:
                pipelines.run_warm_start, pipelines.run_reconstruction = originals

        def run_mode(out_dir, mode, device, sc_kw, random_init, bf16=True):
            """``run_all_scenes.main`` for one mode; FastDVDnet and DDnet in
            float32 when ``bf16`` is False."""
            with contextlib.redirect_stdout(io.StringIO()):
                return scenes_run.main(str(out_dir), mode, random_init=random_init,
                                       device=device, bf16=bf16, **sc_kw)

    if "scenes_parity" in phases:
        sp = SCENES_PARITY
        sc_kw = dict(b=sp["b"], h=sp["size"], w=sp["size"], n_meas=sp["n_meas"])
        db_bar, dx_bar, _ = PIPELINE_PARITY_BAR
        with tempfile.TemporaryDirectory() as d:
            rows, logs = {}, {mode: [] for mode in sp["scenes"]}
            for device in ("cpu", "cuda"):
                for mode in sp["scenes"]:
                    t0 = time.perf_counter()
                    with counted_scenes(logs[mode] if device == "cuda" else []):
                        rows[device, mode] = run_mode(Path(d) / device / mode, mode, device,
                                                      {**sc_kw, "scenes": sp["scenes"][mode]},
                                                      random_init=mode == "ffd", bf16=False)
                    emit("scenes_parity_run", device=device, mode=mode,
                         seconds=time.perf_counter() - t0)
            for mode in sp["scenes"]:
                row_logs = [e for e in logs[mode] if e["kind"] == "row"]
                for cpu_row, gpu_row, e in zip(rows["cpu", mode], rows["cuda", mode], row_logs,
                                               strict=True):
                    name = gpu_row[0]
                    require(cpu_row[:5] == gpu_row[:5] and e["scene"] == name,
                            f"scenes_parity: rows {cpu_row} {gpu_row}")
                    x = {dev: sio.loadmat(str(Path(d) / dev / mode / f"{name}8_online_{mode}.mat"))
                         ["v_recon_bayer"] for dev in ("cpu", "cuda")}
                    # the guard's picks (every FastDVDnet row is guarded)
                    picks = {dev: scenes_run.guard_picks(str(Path(d) / dev / mode), name, mode,
                                                         sp["b"])
                             if mode.startswith("fastdvd") else None for dev in ("cpu", "cuda")}
                    want = scenes_launches(name, mode, sp["n_meas"], lowp=False)
                    res = {"scene": name, "mode": mode,
                           "warm_dpsnr_db": abs(gpu_row[5] - cpu_row[5]),
                           "final_dpsnr_db": abs(gpu_row[6] - cpu_row[6]),
                           "max_abs_dx": float(np.abs(x["cuda"] - x["cpu"]).max()),
                           "final_db_cuda": gpu_row[6], "final_db_cpu": cpu_row[6],
                           "picks": picks, "launches": e["launches"], "launches_predicted": want}
                    emit("scenes_parity", shape=[sp["n_meas"], sp["b"], sp["size"], sp["size"]],
                         dtype="float32", bar=f"{db_bar} dB, {dx_bar}, the same picks", **res)
                    require(res["warm_dpsnr_db"] <= db_bar and res["final_dpsnr_db"] <= db_bar
                            and res["max_abs_dx"] <= dx_bar and picks["cuda"] == picks["cpu"]
                            and e["launches"] == want, f"scenes_parity {name} {mode}: {res}")
            warm = [e["launches"] for mode in sp["scenes"] for e in logs[mode]
                    if e["kind"] == "warm"]
            require(len(warm) == sum(map(len, sp["scenes"].values())) and all(
                w == {"x_update": 40 * sp["n_meas"], "tv_chambolle": 40 * sp["n_meas"],
                      "convpair": 0} for w in warm), f"scenes_parity: warm-start launches {warm}")

    if phases & {"scenes", "scenes_full"}:
        sk = SCENES
        sc_kw = dict(b=sk["b"], h=sk["size"], w=sk["size"], n_meas=sk["n_meas"])
        full_run = "scenes_full" in phases
        n_rows = len(scenes_run.MODES) * (len(scenes_run.SCENE_STANDINS) if full_run else 1)
        make = scenes_run._make_scene_data
        scenes_run._make_scene_data = functools.cache(make)  # one scene for the four modes
        log: list[dict] = []
        rows = []
        t_phase = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory() as d:
                for mode in scenes_run.MODES:
                    names = list(scenes_run.SCENE_STANDINS) if full_run else [SCENES_DEFAULT[mode]]
                    with counted_scenes(log):
                        for row in run_mode(Path(d) / mode, mode, "cuda",
                                            {**sc_kw, "scenes": names},
                                            random_init=mode.startswith("ffd")):
                            rows.append(row)
                    table = (Path(d) / mode / scenes_run.TABLE_NAME).read_text()
                    require(table.count("\n| ") == 1 + len(names),
                            f"scenes {mode}: table {table}")
        finally:
            scenes_run._make_scene_data = make
        row_logs = [e for e in log if e["kind"] == "row"]
        warm_logs = [e for e in log if e["kind"] == "warm"]
        require(len(rows) == len(row_logs) == n_rows and len(warm_logs) == n_rows,
                f"scenes: {len(rows)} rows, {len(warm_logs)} warm starts")
        scene_counts = {"x_update": 0, "tv_chambolle": 0, "convpair": 0}
        scene_shapes: dict[tuple[int, int, int], int] = {}
        for e in warm_logs:
            require(e["launches"] == {"x_update": 40, "tv_chambolle": 40, "convpair": 0},
                    f"scenes: warm start of {e['scene']}: {e['launches']}")
        for row, e in zip(rows, row_logs, strict=True):
            name, mode = row[0], row[1]
            want = scenes_launches(name, mode, sk["n_meas"], lowp=True)
            line = {"scene": name, "mode": mode, "style": row[2], "sigma": row[3],
                    "iters": row[4], "warm_db": row[5], "final_db": row[6], "ssim": row[7],
                    "warm_s_per_meas": row[8], "recon_s_per_meas": row[9],
                    "launches": e["launches"], "launches_predicted": want,
                    "peak_gb": e["peak_gb"]}
            emit("scenes_row", **line)
            require(np.isfinite([row[5], row[6], row[7]]).all() and row[9] > 0,
                    f"scenes {name} {mode}: {line}")
            require(e["launches"] == want, f"scenes {name} {mode}: launches {e['launches']}"
                                           f" against {want}")
        for e in log:
            for k, v in e["launches"].items():
                scene_counts[k] += v
            for shape, v in e["shapes"].items():
                scene_shapes[shape] = scene_shapes.get(shape, 0) + v
        report["launches_scenes"] = scene_counts
        report["launches_convpair_scenes"] = scene_shapes
        emit("scenes_full" if full_run else "scenes",
             shape=[sk["n_meas"], sk["b"], sk["size"], sk["size"]],
             rows=len(rows), seconds=time.perf_counter() - t_phase,
             warm_start_seconds=[e["seconds"] for e in warm_logs[:6]],
             launches=scene_counts,
             peak_gb=max(e["peak_gb"] for e in log), **card)

    # -------------------------------------------------------- models_parity
    if "models_parity" in phases:
        from adaptivepnp_sci_torch.models import blocks as zoo
        from adaptivepnp_sci_torch.models.ddnet import PyramidEncoder
        from adaptivepnp_sci_torch.models.fastdvdnet import SpatialDnCNN
        from adaptivepnp_sci_torch.models.feature import VGGFeatures
        from adaptivepnp_sci_torch.models.ffdnet_ipol import ffdnet_ipol_gray, ffdnet_ipol_rgb
        from adaptivepnp_sci_torch.ops.resize import imresize
        from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32

        g = torch.Generator().manual_seed(8)
        sig = torch.tensor([0.1, 0.04])
        cls_ids = torch.tensor([0, 2])
        # name -> (build, input (N, C, H, W) or NHWC, extra args)
        cases = {
            "ConvBlock_CBR": (lambda: zoo.ConvBlock(8, 16, mode="CBR"), (2, 8, 32, 32), ()),
            "ConvBlock_TIl": (lambda: zoo.ConvBlock(8, 16, 2, 2, 0, mode="TIl"), (2, 8, 32, 32),
                              ()),
            "ConvBlock_CLr2": (lambda: zoo.ConvBlock(8, 16, mode="CLr2"), (2, 8, 32, 32), ()),
            "ConvBlock_C3Uuv": (lambda: zoo.ConvBlock(8, 18, mode="C3Uuv"), (2, 8, 16, 16), ()),
            "ConvBlock_C4MA": (lambda: zoo.ConvBlock(8, 32, mode="C4MA"), (2, 8, 32, 32), ()),
            "ConditionalBatchNorm2d": (lambda: zoo.ConditionalBatchNorm2d(8, 3), (2, 8, 16, 16),
                                       (cls_ids,)),
            "ConcatBlock": (lambda: zoo.ConcatBlock(zoo.ConvBlock(8, 4, mode="CR")),
                            (2, 8, 32, 32), ()),
            "ShortcutBlock": (lambda: zoo.ShortcutBlock(zoo.ConvBlock(8, 8, mode="CLC")),
                              (2, 8, 32, 32), ()),
            "ResBlock": (lambda: zoo.ResBlock(16), (2, 16, 32, 32), ()),
            "IMDBlock": (lambda: zoo.IMDBlock(16), (2, 16, 32, 32), ()),
            "ESA": (lambda: zoo.ESA(16), (2, 16, 40, 40), ()),
            "CFRB": (lambda: zoo.CFRB(16), (2, 16, 40, 40), ()),
            "CALayer": (lambda: zoo.CALayer(16, 4), (2, 16, 32, 32), ()),
            "RCABlock": (lambda: zoo.RCABlock(16, reduction=4), (2, 16, 32, 32), ()),
            "RCAGroup": (lambda: zoo.RCAGroup(16, reduction=4, nb=2), (2, 16, 32, 32), ()),
            "ResidualDenseBlock5C": (lambda: zoo.ResidualDenseBlock5C(16, 8), (2, 16, 32, 32),
                                     ()),
            "RRDB": (lambda: zoo.RRDB(16, 8), (2, 16, 32, 32), ()),
            "NonLocalBlock2D": (lambda: zoo.NonLocalBlock2D(16), (2, 16, 16, 16), ()),
            "NonLocalBlock2D_down": (lambda: zoo.NonLocalBlock2D(16, downsample=True),
                                     (2, 16, 16, 16), ()),
            "upsample_pixelshuffle": (lambda: zoo.upsample_pixelshuffle(16, 3, mode="2BR"),
                                      (2, 16, 16, 16), ()),
            "upsample_upconv": (lambda: zoo.upsample_upconv(16, 3, mode="3L"), (2, 16, 16, 16),
                                ()),
            "upsample_convtranspose": (lambda: zoo.upsample_convtranspose(16, 3, mode="2R"),
                                       (2, 16, 16, 16), ()),
            "downsample_strideconv": (lambda: zoo.downsample_strideconv(16, 8, mode="2R"),
                                      (2, 16, 32, 32), ()),
            "downsample_maxpool": (lambda: zoo.downsample_maxpool(16, 8, mode="2R"),
                                   (2, 16, 32, 32), ()),
            "downsample_avgpool": (lambda: zoo.downsample_avgpool(16, 8, mode="3BR"),
                                   (2, 16, 36, 36), ()),
            "FFDNetIPOL_rgb": (ffdnet_ipol_rgb, (2, 64, 64, 3), (sig,)),
            "FFDNetIPOL_gray": (ffdnet_ipol_gray, (2, 64, 64, 1), (sig,)),
            "SpatialDnCNN": (SpatialDnCNN, (2, 64, 64, 3), (sig,)),
            "PyramidEncoder": (PyramidEncoder, (2, 66, 70, 4), ()),
            "VGGFeatures": (VGGFeatures, (2, 64, 64, 3), ()),
        }
        errs = {}
        with full_f32():
            for name, (build, shape, extra) in cases.items():
                torch.manual_seed(0)
                m = build()
                for bname, b in m.named_buffers():  # non-trivial BatchNorm statistics
                    if bname.endswith("running_mean"):
                        b.copy_(0.1 * torch.randn(b.shape, generator=g))
                    elif bname.endswith("running_var"):
                        b.uniform_(0.5, 1.5, generator=g)
                x = torch.rand(shape, generator=g)
                with torch.no_grad():
                    want = m.eval()(x, *extra)
                    got = m.to(dev)(x.to(dev), *(a.to(dev) for a in extra)).cpu()
                require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                        f"models_parity {name}: {tuple(got.shape)}")
                errs[name] = float((got - want).abs().max() / want.abs().max())
            img = torch.rand(4, 37, 53, 3, generator=g)
            for name, kw in (("imresize_up", dict(scale=2.0)), ("imresize_down", dict(scale=0.5)),
                             ("imresize_down_plain", dict(scale=0.5, antialias=False))):
                want = imresize(img, **kw)
                got = imresize(img.to(dev), **kw)
                require(got.device.type == "cuda", f"models_parity {name}: ran on {got.device}")
                errs[name] = float((got.cpu() - want).abs().max() / want.abs().max())
            # full width: FFDNet-IPOL colour on 8 x 512^2, VGG19 features on 8 x 224^2
            timings = {}
            for name, build, shape, extra in (
                    ("ffdnet_ipol_rgb_8x512", ffdnet_ipol_rgb, (8, 512, 512, 3),
                     (torch.full((8,), 25 / 255),)),
                    ("vgg_features_8x224", VGGFeatures, (8, 224, 224, 3), ())):
                m = build().to(dev).eval()
                x = torch.rand(shape, generator=g).to(dev)
                ex = tuple(a.to(dev) for a in extra)
                with torch.no_grad():
                    timings[name] = time_ms(lambda: m(x, *ex), n=10)
        emit("models_parity", dtype="float32, TF32 off", rel_err=errs,
             bar=f"{MODELS_PARITY_REL} of each output's largest magnitude",
             full_width_ms=timings, **card)
        require(all(e <= MODELS_PARITY_REL for e in errs.values()), f"models_parity: {errs}")

    # ----------------------------------------------------- parallel_parity
    if "parallel_parity" in phases:
        import tempfile
        from concurrent.futures import ThreadPoolExecutor

        from adaptivepnp_sci_torch import multihost_validation as mv

        torch.cuda.empty_cache()
        cases, sizes = mv.DEFAULT_CASES["card"], mv.SIZES["card"]
        bar = PARALLEL_PARITY_BAR
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d2, tempfile.TemporaryDirectory() as d1, \
                ThreadPoolExecutor(2) as pool:
            # the 2-rank gloo run and the 1-rank NCCL run share the card, while
            # this process runs the CPU plain path
            gloo = pool.submit(mv.launch, 2, d2, "cuda", "gloo", cases, "card", 900.0)
            nccl = pool.submit(mv.launch, 1, d1, "cuda", "nccl", cases, "card", 900.0)
            cpu = {name: mv.run_case(name, None, "cpu", sizes) for name in cases
                   if name not in mv.REFUSALS | mv.MUST_FAIL}
            cpu_seconds = time.perf_counter() - t0
            ranks, (world1,) = gloo.result(), nccl.result()
        seconds = time.perf_counter() - t0

        def counts(res):
            return {k: int(res[f"launches__{k}"]) for k in _K}

        def dp_params(got, want):
            # Adam's opposite-sign bound (PARALLEL_PARITY_BAR)
            d = np.abs(got - want)
            frac = float((d > 0.1 * bar["dp_lr"]).mean())
            require(frac <= 1e-3 and float(d.max()) <= 2 * bar["dp_lr"],
                    f"parallel_parity dp_step: params {float(d.max())}, {frac} beyond lr/10")
            return float(d.max())

        for name in cases:
            want_rank, want_w1 = PARALLEL_PARITY_LAUNCHES[name]
            per_rank = [counts(r[name]) for r in ranks]
            require(all(c == want_rank for c in per_rank) and counts(world1[name]) == want_w1,
                    f"parallel_parity {name}: launches {per_rank}, world 1 {counts(world1[name])}")
            fields = {}
            if name in mv.REFUSALS:
                refused = [mv.outputs(r[name]) for r in ranks]
                require(all(got and all(bool(v) for v in got.values()) for got in refused),
                        f"parallel_parity {name}: not refused {refused}")
            elif name in mv.MUST_FAIL:
                # the gradient with the frame sum's backward summed over the
                # ranks: frame (2) times the one-process gradient
                ratios = [mv.grad_norm_ratios(mv.outputs(r[name]), ref)
                          for r in ranks for ref in (mv.outputs(world1["frame_loss_grad"]),
                                                     cpu["frame_loss_grad"])]
                require(all(abs(v - 2.0) <= 1e-3 for rs in ratios for v in rs.values()),
                        f"parallel_parity {name}: gradient norm ratios {ratios}")
                fields = {"gradient_norm_ratios": ratios}
            else:
                lowp = name == "prior_bf16"
                d_w1, d_cpu, grad_rel, grad_cpu = [], [], [], []
                for r in ranks:
                    got = mv.outputs(r[name])
                    ref_w1, ref_cpu = mv.outputs(world1[name]), cpu[name]
                    if name == "dp_step":
                        params = got.pop("params")
                        d_w1.append(dp_params(params, ref_w1["params"]))
                        d_cpu.append(dp_params(params, ref_cpu["params"]))
                    d_w1.append(mv.compare(name, got, ref_w1,
                                           bar["bf16"] if lowp else bar["world1"]))
                    grads = {k: got.pop(k) for k in list(got) if k.endswith("_grads")}
                    d_cpu.append(mv.compare(name, got, ref_cpu,
                                            bar["bf16"] if lowp else bar["cpu"]))
                    for k, g in grads.items():
                        grad_rel.append(float(np.linalg.norm(g - ref_cpu[k])
                                              / np.linalg.norm(ref_cpu[k])))
                        grad_cpu.append(mv.compare(name, {k: g}, {k: ref_cpu[k]}, np.inf))
                fields = {"max_scaled_d_world1": max(d_w1), "max_scaled_d_cpu": max(d_cpu)}
                if name == "frame_loss_grad":
                    ratios = [mv.grad_norm_ratios(mv.outputs(r[name]), mv.outputs(world1[name]))
                              for r in ranks]
                    require(all(abs(v - 1.0) <= bar["world1"] for rs in ratios for v in rs.values())
                            and max(grad_rel) <= bar["cpu_grad_rel_norm"],
                            f"parallel_parity {name}: gradient norm ratios {ratios}, against the "
                            f"CPU {grad_rel}")
                    fields.update(gradient_norm_ratios_world1=ratios,
                                  gradient_rel_norm_cpu=grad_rel,
                                  gradient_max_scaled_d_cpu=grad_cpu)
            emit("parallel_parity", case=name, ranks=2, backend="gloo (CUDA tensors); "
                 "world size 1: nccl", launches_per_rank=per_rank,
                 launches_world1=counts(world1[name]),
                 seconds_per_rank=[float(r[name]["seconds"]) for r in ranks],
                 seconds_world1=float(world1[name]["seconds"]),
                 collectives_ms_per_rank=[float(r[name]["collectives_ms"]) for r in ranks],
                 collectives_per_rank=[int(r[name]["collectives_count"]) for r in ranks],
                 collectives_by_key_rank0=ranks[0][name]["collectives_by_key"].tolist(),
                 collectives_ms_world1_nccl_host=float(world1[name]["collectives_ms"]),
                 nccl_device_ms_world1=float(world1[name]["nccl_device_ms"]),
                 peak_mem_bytes_per_rank=[int(r[name]["peak_mem_bytes"]) for r in ranks],
                 bar=bar, **fields, **card)
        emit("parallel_parity_total", seconds=seconds, cpu_plain_path_seconds=cpu_seconds,
             cases=len(cases), **card)

    # ------------------------------------------------------------ parallel
    if "parallel" in phases:
        import tempfile

        from adaptivepnp_sci_torch import multihost_validation as mv

        torch.cuda.empty_cache()
        full = mv.SIZES["full"]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            ranks = mv.launch(2, d, "cuda", "gloo", mv.DEFAULT_CASES["full"], "full", 900.0)
        seconds = time.perf_counter() - t0
        for name in mv.DEFAULT_CASES["full"]:
            per_rank = [{k: int(r[name][f"launches__{k}"]) for k in _K} for r in ranks]
            require(all(c == PARALLEL_LAUNCHES[name] for c in per_rank),
                    f"parallel {name}: launches per rank {per_rank}")
        report["launches_parallel_tiled"] = [
            {**{k: int(r["tiled_full"][f"launches__{k}"]) for k in _K},
             **{f"convpair_{n}": int(sum(row[3] for row in r["tiled_full"]["launches_by_shape"]
                                         if tuple(row[:3]) == shp))
                for n, shp in CONVPAIR_MAIN_SHAPES.items()}} for r in ranks]
        peaks = {name: [int(r[name]["peak_mem_bytes"]) for r in ranks]
                 for name in mv.DEFAULT_CASES["full"]}

        # the prior: against the one-process call on the card
        one = mv.run_case("prior_full", None, "cuda", full)
        d_prior = max(mv.compare("prior_bf16", {"out": r["prior_full"]["out"]},
                                 {"out": one["out"]}) for r in ranks)
        emit("parallel", case="prior_full", shape=[8, full.side, full.side],
             mode="bf16 FastDVDnet, frames over frame=2", ms_per_call_per_rank=[
                 1e3 * float(r["prior_full"]["seconds_per_call"]) for r in ranks],
             ms_per_call_one_process=1e3 * float(one["seconds_per_call"]),
             max_scaled_d_one_process=d_prior, bar=PARALLEL_PARITY_BAR["bf16"],
             launches_per_rank=PARALLEL_LAUNCHES["prior_full"],
             call_collectives_ms_per_rank=[float(r["prior_full"]["call_collectives_ms"])
                                           for r in ranks],
             call_collectives_by_key_rank0=ranks[0]["prior_full"][
                 "call_collectives_by_key"].tolist(),
             case_seconds_per_rank=[float(r["prior_full"]["seconds"]) for r in ranks],
             peak_mem_bytes_per_rank=peaks["prior_full"], **card)
        require(d_prior <= PARALLEL_PARITY_BAR["bf16"], f"parallel prior_full: {d_prior}")

        # the tiled snapshot: against the one-process tile_chunk=4 run, and
        # that run against tile_chunk=2 (a run that adapts in another direction)
        ref, wrong = report["tiled_chunk4"], report["tiled_chunk2"]
        start = _flat_variables(fastdvd_params)
        step = np.linalg.norm(ref["variables"] - start)

        def dw_fraction(w):
            return float(np.linalg.norm(w - ref["variables"]) / step)

        tf = [r["tiled_full"] for r in ranks]
        db = max(float(np.abs(t["psnr"] - ref["psnr"]).max()) for t in tf)
        dw = max(float(np.abs(t["variables"] - ref["variables"]).max()) for t in tf)
        dw_frac = max(dw_fraction(t["variables"]) for t in tf)
        moved = [float(np.abs(t["variables"] - start).max()) for t in tf]
        same = bool(np.array_equal(tf[0]["variables"], tf[1]["variables"]))
        k3 = sum(int(t["launches__convpair"]) for t in tf)
        emit("parallel", case="tiled_full", shape=[8, full.tiled, full.tiled],
             tile=full.tiled // 4, tile_chunk=mv.FULL_TILE_CHUNK, data=2,
             mode="bf16 FastDVDnet (remat off), adaptation shared over the tiles",
             seconds_per_snapshot_per_rank=[float(t["seconds_per_snapshot"]) for t in tf],
             seconds_per_snapshot_one_process=ref["seconds"],
             psnr_db=[float(t["psnr"].mean()) for t in tf],
             psnr_db_one_process=float(np.mean(ref["psnr"])), max_dpsnr_db=db,
             max_abs_dw_one_process=dw, dw_fraction_one_process=dw_frac,
             weights_moved=moved, weights_same_on_ranks=same,
             bar={"db": PARALLEL_TILED_DB, "dw_fraction": PARALLEL_TILED_DW_FRACTION},
             wrong_run={"run": "one process, tile_chunk 2",
                        "max_dpsnr_db": float(np.abs(wrong["psnr"] - ref["psnr"]).max()),
                        "dw_fraction": dw_fraction(wrong["variables"])},
             launches_per_rank=[{k: int(t[f"launches__{k}"]) for k in _K} for t in tf],
             convpair_sum_over_ranks=k3,
             warmup=f"one group of {mv.FULL_TILE_CHUNK} tiles on a {full.tiled // 2}^2 scene",
             warmup_collectives_ms_per_rank=[float(t["warmup_collectives_ms"]) for t in tf],
             warmup_collectives_per_rank=[int(t["warmup_collectives_count"]) for t in tf],
             warmup_collectives_by_key_rank0=tf[0]["warmup_collectives_by_key"].tolist(),
             case_seconds_per_rank=[float(t["seconds"]) for t in tf],
             peak_mem_bytes_per_rank=peaks["tiled_full"], **card)
        require(db <= PARALLEL_TILED_DB and dw_frac <= PARALLEL_TILED_DW_FRACTION,
                f"parallel tiled_full: {db} dB, weights {dw_frac} of the adaptation's change")
        require(same and min(moved) > 0, f"parallel tiled_full: weights {same}, moved {moved}")
        require(k3 == TILED_LAUNCHES[4]["convpair"], f"parallel tiled_full: K3 {k3} over ranks")

        # the training step: the same weights on both ranks; one process beside it
        tr = [r["train_full"] for r in ranks]
        one = mv.run_case("train_full", None, "cuda", full)
        require(bool(np.array_equal(tr[0]["params"], tr[1]["params"]))
                and all(np.isfinite(t["losses"]).all() for t in tr),
                "parallel train_full: ranks disagree or non-finite")
        emit("parallel", case="train_full", network="fastdvd",
             batch=mv.FULL_TRAIN_BATCH, patch=full.patch, frame=2,
             seconds_per_step_per_rank=[float(t["seconds_per_step"]) for t in tr],
             seconds_per_step_one_process=float(one["seconds_per_step"]),
             losses=tr[0]["losses"].tolist(), losses_one_process=one["losses"].tolist(),
             step_collectives_ms_per_rank=[float(t["step_collectives_ms"]) for t in tr],
             step_collectives_by_key_rank0=tr[0]["step_collectives_by_key"].tolist(),
             case_seconds_per_rank=[float(t["seconds"]) for t in tr],
             peak_mem_bytes_per_rank=peaks["train_full"], **card)

        # the frame-sharded snapshots: against the one-process runs of the
        # flagship and fastdvd phases (and, for the bf16 row without
        # adaptation, against one made here)
        fixed_one = mv.run_case("frame_fastdvd_fixed_full", None, "cuda", full)
        starts = {"ffdnet": _flat_variables(ffdnet_from_flax(
            flax_style_ffdnet_params(96, 12, seed=0))), "fastdvd": _flat_variables(fastdvd_params)}
        frame_runs = {
            "frame_flagship_full": ("FFDNet flagship, float32", report["flagship_ref"], "ffdnet",
                                    {"db": PARALLEL_FRAME_DB,
                                     "dw_fraction": PARALLEL_FRAME_DW_FRACTION}),
            "frame_fastdvd_fp32_full": ("FastDVDnet Bosphorus row, float32 (remat)",
                                        report["fastdvd_ref_fp32"], "fastdvd",
                                        {"db": PARALLEL_FRAME_DB,
                                         "max_abs_dw": PARALLEL_FRAME_FP32_DW}),
            "frame_fastdvd_fixed_full": ("FastDVDnet Bosphorus row, bf16, no adaptation",
                                         {**fixed_one, "seconds": float(
                                             fixed_one["seconds_per_snapshot"])}, None,
                                         {"db": PARALLEL_FRAME_DB}),
            "frame_fastdvd_full": ("FastDVDnet Bosphorus row, bf16", report["fastdvd_ref_bf16"],
                                   "fastdvd", dict(zip(("db", "rms_dx"),
                                                       FASTDVD_PARITY["bf16"][1][2:4]))),
        }
        report["launches_parallel_frame"] = {}
        for name, (what, ref, start_key, bars) in frame_runs.items():
            fr = [r[name] for r in ranks]
            got = {"db": max(float(np.abs(t["psnr"] - ref["psnr"]).max()) for t in fr)}
            if "x_bayer" in ref:
                got["rms_dx"] = max(float(np.sqrt(np.mean((t["x_bayer"] - ref["x_bayer"])
                                                          .astype(np.float64) ** 2))) for t in fr)
            if start_key is not None:
                step = np.linalg.norm(ref["variables"] - starts[start_key])
                got["dw_fraction"] = max(
                    float(np.linalg.norm(t["variables"] - ref["variables"]) / step) for t in fr)
                got["max_abs_dw"] = max(
                    float(np.abs(t["variables"] - ref["variables"]).max()) for t in fr)
            per_rank = [{k: int(t[f"launches__{k}"]) for k in _K} for t in fr]
            report["launches_parallel_frame"][name] = [
                {**c, **{f"convpair_{n}": int(sum(row[3] for row in t["launches_by_shape"]
                                                  if tuple(row[:3]) == shp))
                         for n, shp in CONVPAIR_MAIN_SHAPES.items()}}
                for c, t in zip(per_rank, fr)]
            emit("parallel", case=name, shape=[8, full.side, full.side], frame=2, mode=what,
                 seconds_per_snapshot_per_rank=[float(t["seconds_per_snapshot"]) for t in fr],
                 seconds_runs_per_rank=[t["seconds_runs"].tolist() for t in fr],
                 seconds_per_snapshot_one_process=float(ref["seconds"]),
                 psnr_db=[float(t["psnr"].mean()) for t in fr],
                 psnr_db_one_process=float(np.mean(ref["psnr"])),
                 against_one_process=got, bar=bars,
                 ranks_identical=bool(np.array_equal(fr[0]["psnr"], fr[1]["psnr"])
                                      and np.array_equal(fr[0]["variables"], fr[1]["variables"])),
                 launches_per_rank=per_rank,
                 warmup_collectives_ms_per_rank=[float(t["warmup_collectives_ms"]) for t in fr],
                 warmup_collectives_per_rank=[int(t["warmup_collectives_count"]) for t in fr],
                 warmup_collectives_by_key_rank0=fr[0]["warmup_collectives_by_key"].tolist(),
                 case_seconds_per_rank=[float(t["seconds"]) for t in fr],
                 peak_mem_bytes_per_rank=peaks[name], **card)
            require(all(bool(t["finite"]) for t in fr), f"parallel {name}: non-finite output")
            require(all(c == PARALLEL_LAUNCHES[name] for c in per_rank),
                    f"parallel {name}: launches per rank {per_rank}")
            require(np.array_equal(fr[0]["variables"], fr[1]["variables"]),
                    f"parallel {name}: the ranks' weights differ")
            require(all(got[k] <= v for k, v in bars.items()),
                    f"parallel {name}: {got} against the one-process run, bars {bars}")
        emit("parallel_total", seconds=seconds, **card)

    # ---------------------------------------------------------------- host
    if "host" in phases:
        import tempfile

        from adaptivepnp_sci_torch.data import native_loader
        from adaptivepnp_sci_torch.utils import profiling

        t0 = time.perf_counter()
        require(native_loader.native_available(), "host: the native prefetch ring did not build")
        build_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as d:
            rng = np.random.default_rng(0)
            paths = []
            for i in range(HOST_NPY["files"]):
                paths.append(str(Path(d) / f"clip_{i:03d}.npy"))
                np.save(paths[-1], rng.random(HOST_NPY["shape"], dtype=np.float32))
            nbytes = sum(Path(p).stat().st_size for p in paths)
            rates = {}
            for route in ("native", "np.load", "native"):
                t0 = time.perf_counter()
                if route == "native":
                    got = list(native_loader.iter_npy_prefetched(paths, workers=4, capacity=8))
                else:
                    got = [np.load(p) for p in paths]
                rates.setdefault(route, []).append(nbytes / 1e6 / (time.perf_counter() - t0))
                if route == "native":
                    require(len(got) == len(paths) and all(
                        np.array_equal(a, np.load(p)) for a, p in zip(got, paths)),
                        "host: the native ring's arrays differ from np.load's")
                del got
            # one flagship reconstruction under the profiler, its two stages annotated
            sc = make_scene(b=8, h=512, w=512, seed=42)
            prior = ffdnet_prior(FFDNet(nc=96, nb=12))
            params = ffdnet_from_flax(flax_style_ffdnet_params(96, 12, seed=0))
            cfg = ADMMConfig(sigma=SIGMA, iters=ITERS, adapt=AdaptConfig(
                lr=2e-6, update_per_iter=2, interval_iter=15, initial_iter=1))

            def flagship_step():
                with profiling.annotate("host_warm_start"):
                    warm = gap_tv(sc.meas, sc.mask, GapTVConfig(iters=40), device="cuda")
                with profiling.annotate("host_admm"):
                    return two_stage_admm(sc.meas, sc.mask, cfg, prior, params, warm.x_bayer,
                                          sc.orig_bayer, device="cuda")

            timer = profiling.StepTimer()
            with timer.measure() as h:
                h["out"] = flagship_step().x_bayer  # warm-up
            with timer.measure() as h, profiling.trace(str(Path(d) / "trace")) as prof:
                h["out"] = flagship_step().x_bayer
            for _ in range(2):
                with timer.measure() as h:
                    h["out"] = flagship_step().x_bayer
            trace_path = Path(d) / "trace" / profiling.TRACE_NAME
            events = json.loads(trace_path.read_text())["traceEvents"]
            names = {e.get("name") for e in events}
            kernels = [e for e in events if e.get("cat") == "kernel"]
            require({"host_warm_start", "host_admm"} <= names,
                    "host: the trace lacks the annotated spans")
            require(any("x_update" in e.get("name", "") for e in kernels),
                    "host: the trace holds no device kernel of the port")
            dev_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
            trace_mb = trace_path.stat().st_size / 1e6
        emit("host", native_available=True, native_build_s=build_s, npy_files=len(paths),
             npy_bytes=nbytes, mb_per_s=rates, mb_per_s_note="page cache warm: the files "
             "were just written", trace_spans=["host_warm_start", "host_admm"],
             trace_kernels=len(kernels), trace_device_ms=dev_ms, trace_mb=trace_mb,
             step_s_untraced=[timer.history[0], *timer.history[2:]],
             step_s_traced=timer.history[1], video="not run (no cv2 on this machine)", **card)

    # ------------------------------------------------------------- weights
    if phases & {"weights", "seams", "seams_halo"}:
        import os
        import tempfile

        from adaptivepnp_sci_torch.train.trainer import (
            load_checkpoint_variables,
            save_variables_npz,
        )

        tool_dir = tempfile.TemporaryDirectory()
        # the teacher FFDNet of the distillation chain and of the seam table:
        # this script's Flax-scheme weights (their dB mean nothing)
        teacher = os.path.join(tool_dir.name, "teacher.npz")
        save_variables_npz(teacher, flax_style_ffdnet_params(96, 12, seed=0))

        def counted(run):
            """``run()``'s result, its seconds and its launches, the counts
            zeroed just before it."""
            torch.cuda.synchronize()
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            return (out, time.perf_counter() - t0,
                    {**cuda_kernels.launches,
                     **{f"convpair_{n}": cuda_kernels.convpair_launches.get(shp, 0)
                        for n, shp in CONVPAIR_MAIN_SHAPES.items()}})

        def trained(trainer, losses, out_dir):
            """The written .npz read back equal to the trained weights."""
            back = load_checkpoint_variables(os.path.join(out_dir, "final.npz"))
            same = all(torch.equal(back[k], v.cpu()) for k, v in trainer.variables.items()
                       if not k.endswith("num_batches_tracked"))
            return same and bool(np.isfinite(losses).all())

    if "weights" in phases:
        from adaptivepnp_sci_torch import (
            distill_fastdvd,
            distill_iterates,
            eval_weights,
            harvest_iterates,
            regenerate_weights,
        )

        no_kernel = {**_launches(), **{f"convpair_{n}": 0 for n in CONVPAIR_MAIN_SHAPES}}
        sets = [str(ROOT / w) for w in WEIGHT_SETS]
        rows, secs, counts = counted(lambda: eval_weights.main(sets, size=512, device="cuda"))
        report["launches_eval_weights"] = counts
        emit("weights", tool="eval_weights", size=512, seconds=secs,
             sets=[{"weights": w, "standalone_db": r[1], "in_loop_db": r[2], "sigma_max": r[3]}
                   for w, r in zip(WEIGHT_SETS, rows)],
             sigma_max_claim="~0.73 (scripts/eval_weights.py docstring)", launches=counts,
             **card)
        require(counts == {**no_kernel, **EVAL_WEIGHTS_LAUNCHES},
                f"weights eval_weights: launches {counts}")
        require(all(np.isfinite(r[1:]).all() for r in rows), f"weights eval_weights: {rows}")
        gpu64 = eval_weights.main(sets, size=64, device="cuda")
        cpu64 = eval_weights.main(sets, size=64, device="cpu")
        d = {"db": max(abs(g[i] - c[i]) for g, c in zip(gpu64, cpu64) for i in (1, 2)),
             "sigma_max_rel": max(abs(g[3] - c[3]) / c[3] for g, c in zip(gpu64, cpu64))}
        emit("weights", tool="eval_weights", size=64, card=[list(r[1:]) for r in gpu64],
             cpu=[list(r[1:]) for r in cpu64], against_cpu=d, bar=EVAL_WEIGHTS_PARITY)
        require(all(d[k] <= v for k, v in EVAL_WEIGHTS_PARITY.items()),
                f"weights eval_weights at 64^2: {d} against the CPU")

        for network in ("fastdvd", "ddnet"):
            out_dir = os.path.join(tool_dir.name, network)
            (trainer, losses), secs, counts = counted(lambda: regenerate_weights.main(
                network, REGEN["steps"], out_dir=out_dir, n_clips=REGEN["n_clips"],
                device="cuda"))
            ok = trained(trainer, losses, out_dir)
            emit("weights", tool="regenerate_weights", network=network, **REGEN, batch=32,
                 clip=64, losses=losses, seconds=secs, npz_read_back=ok, launches=counts,
                 **card)
            require(ok and counts == no_kernel, f"weights regenerate {network}: {ok}, {counts}")

        student = str(ROOT / "weights" / "fastdvd.npz")
        pool = os.path.join(tool_dir.name, "pool.npz")
        (clips, sigmas), secs, counts = counted(lambda: harvest_iterates.main(
            pool, teacher, student, device="cuda", **HARVEST))
        report["launches_harvest"] = counts
        want = {**HARVEST_LAUNCHES, **{f"convpair_{n}": HARVEST_LAUNCHES["convpair"] // 2
                                       for n in CONVPAIR_MAIN_SHAPES}}
        emit("weights", tool="harvest_iterates", **HARVEST, priors=["teacher", "student bf16"],
             clips=list(clips.shape), seconds=secs, launches=counts, **card)
        require(counts == want, f"weights harvest: launches {counts}")
        require(clips.shape == (2 * 32 * 4, 5, 64, 64, 3) and bool(np.isfinite(clips).all()),
                f"weights harvest: clips {clips.shape}")
        small = dict(HARVEST, size=64)
        got, _ = harvest_iterates.main(os.path.join(tool_dir.name, "card64.npz"), teacher,
                                       student, device="cuda", **small)
        ref, _ = harvest_iterates.main(os.path.join(tool_dir.name, "cpu64.npz"), teacher,
                                       student, device="cpu", **small)
        half = len(ref) // 2  # the teacher loop, then the student loop
        d = {"teacher": float(np.abs(got[:half] - ref[:half]).max()
                              / max(1.0, float(np.abs(ref[:half]).max()))),
             "student_rms": float(np.sqrt(np.mean((got[half:] - ref[half:]).astype(np.float64)
                                                  ** 2)))}
        emit("weights", tool="harvest_iterates", size=64, against_cpu=d, bar=HARVEST_PARITY)
        require(all(d[k] <= v for k, v in HARVEST_PARITY.items()),
                f"weights harvest at 64^2: {d} against the CPU")

        for tool, run in (
                ("distill_iterates", lambda d: distill_iterates.main(
                    pool, teacher, steps=3, jac_weight=0.1, n_synth=32, out_dir=d,
                    device="cuda")),
                ("distill_fastdvd", lambda d: distill_fastdvd.main(
                    teacher, steps=1, n_clips=32, out_dir=d, device="cuda"))):
            out_dir = os.path.join(tool_dir.name, tool)
            (trainer, losses), secs, counts = counted(lambda: run(out_dir))
            ok = trained(trainer, losses, out_dir)
            emit("weights", tool=tool, steps=trainer.step, losses=losses, seconds=secs,
                 npz_read_back=ok, launches=counts, **card)
            require(ok and counts == no_kernel, f"weights {tool}: {ok}, {counts}")

    # --------------------------------------------------------------- seams
    if "seams" in phases:
        from adaptivepnp_sci_torch import measure_tile_seams as seams

        fields = ("overlap", "full_db", "seam_db", "interior_db", "s_per_solve")
        rows, secs, counts = counted(lambda: seams.main(teacher, device="cuda"))
        report["launches_seams"] = counts
        emit("seams", tool="measure_tile_seams", shape=[8, 1024, 1024], tile=512, band=8,
             weights="Flax-scheme FFDNet (numpy seed 0): dB mean nothing",
             rows=[dict(zip(fields, r)) for r in rows], seconds=secs, launches=counts, **card)
        require(counts == {**SEAMS_LAUNCHES, **{f"convpair_{n}": 0 for n in CONVPAIR_MAIN_SHAPES}},
                f"seams: launches {counts}")
        got = seams.main(teacher, **SEAMS_SMALL, device="cuda")
        ref = seams.main(teacher, **SEAMS_SMALL, device="cpu")
        d = max(abs(g[i] - c[i]) for g, c in zip(got, ref) for i in (1, 2, 3))
        emit("seams", tool="measure_tile_seams", **SEAMS_SMALL,
             card=[dict(zip(fields[:4], r)) for r in got],
             cpu=[dict(zip(fields[:4], r)) for r in ref], against_cpu_db=d, bar_db=SEAMS_PARITY_DB)
        require(d <= SEAMS_PARITY_DB, f"seams at {SEAMS_SMALL}: {d} dB from the CPU")
        # the tiled phase's 2048^2 FastDVDnet snapshot (overlap 0): PSNR on
        # the seam band and the interior
        sc = report["tiled_run"][0]
        full, seam, interior = seams.seam_psnrs(sc.orig_bayer, report["tiled_chunk4"]["x_bayer"],
                                                TILED["tile"], 8)
        emit("seams", tool="band_masks / masked_psnr", shape=[8, TILED["size"], TILED["size"]],
             tile=TILED["tile"], overlap=0, band=8, tile_chunk=4,
             mode="bf16 FastDVDnet, adaptation shared over the tiles",
             run="the tiled phase's tile_chunk=4 snapshot", full_db=full, seam_db=seam,
             interior_db=interior, seam_delta_db=interior - seam, **card)
        del sc

    # ---------------------------------------------------------- seams_halo
    if "seams_halo" in phases:
        # the same 2048^2 snapshot at overlap 32: the seam band and interior
        sc, prior, cfg = report["tiled_run"]
        tile = TILED["tile"]

        def snapshot32():
            warm = gap_tv(sc.meas, sc.mask, GapTVConfig(iters=40), device="cuda")
            return two_stage_admm_tiled(
                sc.meas, sc.mask, cfg, tile=tile, prior=prior, params=fastdvd_params,
                orig_bayer=sc.orig_bayer, x0_bayer=warm.x_bayer, tile_chunk=4, overlap=32,
                generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")

        res, secs, counts = counted(snapshot32)
        window = {n: (c, (tile + 64) * h // TILED["tile"], (tile + 64) * h // TILED["tile"])
                  for n, (c, h, _) in CONVPAIR_MAIN_SHAPES.items()}
        by_window = {n: cuda_kernels.convpair_launches.get(shp, 0) for n, shp in window.items()}
        full, seam, interior = seams.seam_psnrs(sc.orig_bayer, res.x_bayer.cpu().numpy(), tile, 8)
        emit("seams", tool="band_masks / masked_psnr", shape=[8, TILED["size"], TILED["size"]],
             tile=tile, overlap=32, band=8, tile_chunk=4,
             mode="bf16 FastDVDnet, adaptation shared over the tiles", full_db=full,
             seam_db=seam, interior_db=interior, seam_delta_db=interior - seam,
             seconds_per_snapshot=secs, launches=counts, convpair_launches_by_window=by_window,
             **card)
        require(dict(cuda_kernels.launches) == TILED_LAUNCHES[4]
                and by_window == {n: 16 * 36 * 4 for n in window},
                f"seams 2048^2 overlap 32: launches {counts}, by window {by_window}")
        del sc, res

    if phases & {"weights", "seams", "seams_halo"}:
        report.pop("tiled_run", None)
        tool_dir.cleanup()

    # ------------------------------------------------------------- studies
    if phases & {"studies", "studies_full"}:
        import dataclasses

        from adaptivepnp_sci_torch import (
            ab_cv_guard,
            ab_ddnet_precision,
            ab_demosaic_select,
            ab_ffdnet_precision,
            ab_kernels_adapt,
            ab_weight_select,
            bench_2048_adaptive,
            bench_fastdvd_bf16,
            decompose_fastdvd_floor,
            decompose_flagship_floor,
            diag_teacher_sigma,
            eval_teacher_inloop,
            studies,
            sweep_fastdvd_relax,
            sweep_fidelity,
        )

    if "studies" in phases:
        st = STUDIES
        size, narrow = st["size"], dict(nc=st["nc"], nb=st["nb"])
        small = ffdnet_from_flax(flax_style_ffdnet_params(st["nc"], st["nb"], seed=0))
        flag = studies.flagship_config(iters=st["flag_iters"], adapt=dataclasses.replace(
            studies.FLAGSHIP_ADAPT, interval_iter=st["interval"]))
        fixed = studies.flagship_config(adapt=None, iters=st["flag_iters"])
        fd = studies.fastdvd_config(iters=st["fastdvd_iters"], adapt=dataclasses.replace(
            studies.FASTDVD_ADAPT, interval_iter=st["interval"]))
        fd_fixed = studies.fastdvd_config(adapt=None, iters=st["fastdvd_iters"])
        sc = make_scene(b=8, h=size, w=size, seed=42)

        # tool -> device -> (numbers compared, their bars, the picks, arrays)
        tools = {
            "ab_ffdnet_precision": lambda d: {
                mode: ab_ffdnet_precision.precision_row(
                    sc, FFDNet(**narrow, **kw), small, flag, d, n=0)[1]
                for mode, kw in ab_ffdnet_precision.MODES.items()},
            "ab_kernels_adapt": lambda d: ab_kernels_adapt.main(
                small, None, size, d, FFDNet(**narrow), fixed, flag, fd, n=0),
            "decompose_flagship_floor": lambda d: decompose_flagship_floor.main(
                small, size, d, FFDNet(**narrow), fixed, flag, n=0),
            "decompose_fastdvd_floor": lambda d: decompose_fastdvd_floor.main(
                size, d, fd_fixed, n=0),
            "bench_fastdvd_bf16": lambda d: bench_fastdvd_bf16.main(size, d, fd, n=0),
            "ab_ddnet_precision": lambda d: ab_ddnet_precision.main(
                small, size, d, FFDNet(**narrow), studies.flagship_config(
                    adapt=None, iters=st["flag_iters"], demosaic_method="ddnet"), n=0),
            "ab_cv_guard": lambda d: ab_cv_guard.guard_row(
                make_scene(b=8, h=size, w=size, seed=st["cv_pair"][0], style=st["cv_pair"][1]),
                fastdvd_prior(FastDVDnet(dtype=torch.bfloat16, remat=False)),
                fastdvdnet_from_flax(load_variables_npz(str(ROOT / "weights" / "fastdvd.npz"))),
                fd, d),
            "ab_weight_select": lambda d: ab_weight_select.main(
                size, d, st["cut"], styles=(st["select_style"],)),
            "ab_demosaic_select": lambda d: ab_demosaic_select.main(
                small, size, d, FFDNet(**narrow), st["cut"], scenes=(st["demosaic_scene"],)),
            "sweep_fastdvd_relax": lambda d: sweep_fastdvd_relax.main(
                [st["relax_scene"]], size, d, st["cut"]),
            "sweep_fidelity": lambda d: sweep_fidelity.main(
                size=size, device=d, iters=st["fastdvd_iters"]),
            "bench_2048_adaptive": lambda d: bench_2048_adaptive.main(
                small, st["combos"], size, d, FFDNet(**narrow), flag),
            "diag_teacher_sigma": lambda d: diag_teacher_sigma.main(
                small, None, d, diag_teacher_sigma.FrameWise(**narrow), size=st["clips"]),
            "eval_teacher_inloop": lambda d: eval_teacher_inloop.main(
                small, size, ("smooth",), d, FFDNet(**narrow), fd),
        }
        f32, bf16, loop = STUDIES_F32, STUDIES_BF16, STUDIES_BF16_LOOP

        def db_of(res):
            """A result's mean per-frame PSNR (the solvers' or the pipelines')."""
            p = res.psnr_per_frame if hasattr(res, "psnr_per_frame") else res.psnr
            return float(torch.as_tensor(p).float().mean())

        def x_stats(a, b):
            """``(max, rms)`` of the difference of two arrays."""
            d = torch.as_tensor(a).double().cpu() - torch.as_tensor(b).double().cpu()
            return float(d.abs().max()), float(d.pow(2).mean().sqrt())

        def compare(tool, g, c):
            """``(gaps, bars, picks agree, x stats, float32 reads)`` of the
            card's result ``g`` against the CPU's ``c``: each gap in dB, in
            x or relative against its bar, named; every solve's ``(max,
            rms)`` of x; what the card's float32 rows read against the
            CPU's reduced ones."""
            gaps, bars, same, stats, reads = {}, {}, True, {}, {}

            def db(name, a, b, bar):
                gaps[name], bars[name] = abs(a - b), bar["db"]

            def arr(name, a, b, bar):
                # two arrays, by the bar's measure of their difference
                stats[name] = x_stats(a, b)
                for i, k in enumerate(("max", "rms")):
                    if k in bar:
                        gaps[f"{name}_{k}"], bars[f"{name}_{k}"] = stats[name][i], bar[k]

            def solve(name, a, b, bar):
                # a solve's result: its dB and its x
                db(f"{name}_db", db_of(a), db_of(b), bar)
                arr(name, a.x_bayer, b.x_bayer, bar)

            def read(name, a32, b):
                reads[name] = {"db": abs(db_of(a32) - db_of(b)),
                               **dict(zip(("max", "rms"), x_stats(a32.x_bayer, b.x_bayer)))}

            def rel(name, a, b, bar):
                gaps[name], bars[name] = abs(a - b) / max(abs(b), 1e-30), bar

            def pick(name, a, b, stats, margin, largest=False):
                # a pick (the least statistic, or the largest) is held where
                # the two best differ by more than their bar (``margin``, in
                # the statistics' unit)
                nonlocal same
                best = sorted(stats, reverse=largest)[:2]
                if abs(best[1] - best[0]) > margin:
                    same &= a == b
                gaps[f"{name}_same"] = a == b

            def resid_margin(stats, bar):
                return bar * max(abs(v) for v in stats)

            if tool == "ab_ffdnet_precision":
                for mode in g:
                    solve(mode, g[mode], c[mode], f32 if mode == "fp32" else bf16)
                    if mode != "fp32":
                        read(mode, g["fp32"], c[mode])
            elif tool == "ab_kernels_adapt":
                cpu = {(r[0], r[1]): r for r in c}
                for r in g:
                    ref = cpu[(r[0], "plain" if r[1] == "kernels" else r[1])]
                    solve(f"{r[0]}/{r[1]}", r[5], ref[5], f32)
            elif tool == "decompose_flagship_floor":
                for k in "ABCD":
                    arr(k, g[f"{k}_out"], c[f"{k}_out"], f32)
            elif tool == "decompose_fastdvd_floor":
                # A: the bf16 denoiser alone over the schedule, no loop
                arr("A", g["A_out"], c["A_out"], bf16)
                arr("B", g["B_out"], c["B_out"], f32)
                arr("C", g["C_out"], c["C_out"], loop)
            elif tool == "bench_fastdvd_bf16":
                for a, b in zip(g, c):
                    solve(a[0], a[4], b[4], f32 if a[0] == "fp32" else loop)
                read("bf16+fp32res", g[0][4], c[1][4])
            elif tool == "ab_ddnet_precision":
                for a, b in zip(g, c):
                    solve(f"{a[0]}/{a[1]}", a[5], b[5], f32 if a[1] == "fp32" else bf16)
                for a, b in zip(g[0::2], c[1::2]):
                    read(f"{b[0]}/{b[1]}", a[5], b[5])
            elif tool == "ab_cv_guard":
                db("warm", g[0], c[0], f32)
                for a, b in zip(g[1], c[1]):
                    solve(a[0].strip(), a[3], b[3], loop)
                    if b[3].resid_trace is not None:
                        r = list(b[3].resid_trace.cpu().numpy())
                        pick(a[0].strip(), int(a[3].resid_trace.cpu().argmin()),
                             int(np.argmin(r)), r, resid_margin(r, STUDIES_RESID_REL_LOOP))
            elif tool == "ab_weight_select":
                for a, b in zip(g, c):
                    for i, k in enumerate(ab_weight_select.WEIGHTS):
                        rel(f"resid_{k}", a[2][i], b[2][i], STUDIES_RESID_REL_LOOP)
                        solve(k, a[7][i], b[7][i], loop)
                    pick("pick", a[3], b[3], b[2], resid_margin(b[2], STUDIES_RESID_REL_LOOP))
                    pick("oracle", a[5], b[5], b[4], loop["db"], largest=True)
            elif tool == "ab_demosaic_select":
                for a, b in zip(g, c):
                    rel("resid_malvar", a[2], b[2], STUDIES_RESID_REL)
                    rel("resid_ddnet", a[3], b[3], STUDIES_RESID_REL)
                    solve("malvar", a[9][0], b[9][0], f32)
                    solve("ddnet", a[9][1], b[9][1], bf16)
                    pick("pick", a[4], b[4], (b[2], b[3]),
                         resid_margin((b[2], b[3]), STUDIES_RESID_REL))
                    pick("oracle", a[7], b[7], (b[5], b[6]), bf16["db"], largest=True)
            elif tool == "sweep_fastdvd_relax":
                for a, b in zip(g, c):
                    db("warm", a[2], b[2], f32)
                    for r, ra, rb in zip(a[3], a[6], b[6]):
                        solve(f"r={r}", ra, rb, loop)
                    pick("best_r", a[4], b[4], list(b[3].values()), loop["db"], largest=True)
                    solve("guarded", a[6][-1], b[6][-1], loop)
            elif tool == "sweep_fidelity":
                for a, b in zip(g, c):
                    solve(a[0], a[3], b[3], loop)
            elif tool == "bench_2048_adaptive":
                for a, b in zip(g, c):
                    solve(f"{a[0]}:{a[1]}", a[5], b[5], f32)
            elif tool == "diag_teacher_sigma":
                rel("teacher_sigma_max", g[0], c[0], STUDIES_SIGMA_REL)
                for a, b in zip(g[1], c[1]):
                    rel("student_sigma_max", a[1], b[1], STUDIES_SIGMA_REL)
                    rel("student_rms", a[2], b[2], STUDIES_SIGMA_REL)
            elif tool == "eval_teacher_inloop":
                for a, b in zip(g, c):
                    db(f"{a[0]}_warm", a[1], b[1], f32)
                    solve(a[0], a[3], b[3], f32)
            return gaps, bars, same, stats, reads

        studies_counts = {k: 0 for k in _K}
        studies_shapes: dict = {}
        failed: list[str] = []
        t_phase = time.perf_counter()
        for tool, run in tools.items():
            torch.cuda.synchronize()
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            g, _ = quiet(lambda: run("cuda"))
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            counts = dict(cuda_kernels.launches)
            for shp, k in cuda_kernels.convpair_launches.items():
                studies_shapes[shp] = studies_shapes.get(shp, 0) + k
            t0 = time.perf_counter()
            c, _ = quiet(lambda: run("cpu"))
            cpu_s = time.perf_counter() - t0
            gaps, bars, same, stats, reads = compare(tool, g, c)
            want = studies_launches(tool)
            emit("studies", tool=tool, shape=[8, size, size], launches=counts,
                 launches_predicted=want, gaps=gaps, bars=bars, same_picks=same,
                 x_max_rms=stats, float32_reads=reads, card_s=card_s, cpu_s=cpu_s, **card)
            if counts != want:
                failed.append(f"studies {tool}: launches {counts}, predicted {want}")
            if not (all(gaps[k] <= v for k, v in bars.items()) and same):
                failed.append(f"studies {tool}: card against the CPU {gaps}, bars {bars}")
            for k in _K:
                studies_counts[k] += counts[k]
        # the flagship with use_kernels=False on the card: no K1 or K2 launch,
        # the CPU plain path's result within the float32 bar
        plain = (dataclasses.replace(studies.WARM, use_kernels=False),
                 dataclasses.replace(flag, use_kernels=False))
        cuda_kernels.reset_launches()
        g = reconstruct_single_dispatch(sc.meas, sc.mask, *plain, ffdnet_prior(FFDNet(**narrow)),
                                        small, orig=sc.orig_bayer, device="cuda")
        torch.cuda.synchronize()
        counts = dict(cuda_kernels.launches)
        c = reconstruct_single_dispatch(sc.meas, sc.mask, *plain, ffdnet_prior(FFDNet(**narrow)),
                                        small, orig=sc.orig_bayer, device="cpu")
        gaps = {"db": float((g.psnr_per_frame.cpu() - c.psnr_per_frame).abs().max()),
                "max": float((g.x_bayer.cpu() - c.x_bayer).abs().max())}
        emit("studies", tool="use_kernels=False flagship", shape=[8, size, size],
             launches=counts, gaps=gaps, bars=f32, **card)
        if counts != _launches():
            failed.append(f"studies use_kernels=False: launches {counts}")
        if not all(gaps[k] <= f32[k] for k in f32):
            failed.append(f"studies use_kernels=False: {gaps} against the CPU")
        # FFDNet-color, one apply per mode: the card against the CPU, the
        # type of each convolution's input on the card, and what the card's
        # float32 apply reads against the CPU's reduced one
        from torch.overrides import TorchFunctionMode

        from adaptivepnp_sci_torch.solvers.two_stage_admm import full_f32

        class ConvInputTypes(TorchFunctionMode):
            def __init__(self):
                super().__init__()
                self.seen = []

            def __torch_function__(self, func, types, args=(), kwargs=None):
                if func is torch.nn.functional.conv2d:
                    self.seen.append(str(args[0].dtype).removeprefix("torch."))
                return func(*args, **(kwargs or {}))

        color = ffdnet_from_flax(flax_style_ffdnet_params(96, 12, seed=0))
        xin = torch.rand((1, size, size, 3), generator=torch.Generator().manual_seed(0))
        applied = {}
        for mode, kw in ab_ffdnet_precision.MODES.items():
            for d in ("cuda", "cpu"):
                net = FFDNet(**kw).to(d)
                net.load_state_dict(color)
                with full_f32(), torch.no_grad(), ConvInputTypes() as seen:
                    out = net(xin.to(d), torch.tensor(25 / 255, device=d))
                applied[mode, d] = out.double().cpu(), seen.seen
        interior = {"fp32": "float32", "mixed": "bfloat16", "bf16": "bfloat16"}
        for mode in ab_ffdnet_precision.MODES:
            ends = "float32" if mode == "mixed" else interior[mode]
            want = [ends] + [interior[mode]] * 10 + [ends]
            (out, types), cpu_out = applied[mode, "cuda"], applied[mode, "cpu"][0]
            d = (out - cpu_out).abs()
            gaps = {"max": float(d.max()), "mean": float(d.mean())}
            d32 = (applied["fp32", "cuda"][0] - cpu_out).abs()
            reads = {"max": float(d32.max()), "mean": float(d32.mean())}
            bar = dict(zip(("max", "mean"), STUDIES_APPLY[mode]))
            emit("studies", tool="FFDNet-color apply", mode=mode, shape=[1, size, size, 3],
                 gaps=gaps, bars=bar, conv_input_types=types, float32_reads=reads, **card)
            if not all(gaps[k] <= bar[k] for k in bar):
                failed.append(f"studies FFDNet-color {mode} apply: {gaps}, bars {bar}")
            if types != want:
                failed.append(f"studies FFDNet-color {mode} apply: conv inputs {types}")
            if mode != "fp32" and reads["mean"] <= bar["mean"]:
                failed.append(f"studies FFDNet-color {mode} apply: float32 reads {reads}, "
                              f"within the bars {bar}")
        require(not failed, "; ".join(failed))
        report["launches_studies"] = studies_counts
        report["launches_convpair_studies"] = studies_shapes
        emit("studies_total", seconds=time.perf_counter() - t_phase, launches=studies_counts,
             **card)

    # -------------------------------------------------------- studies_full
    if "studies_full" in phases:
        # every tool once at its published size, FFDNet-color with this
        # script's Flax-scheme weights (their dB mean nothing)
        from adaptivepnp_sci_torch.run_all_scenes import SCENE_STANDINS

        color = ffdnet_from_flax(flax_style_ffdnet_params(96, 12, seed=0))
        full = {
            "ab_ffdnet_precision": lambda: ab_ffdnet_precision.main(color),
            "ab_kernels_adapt": lambda: ab_kernels_adapt.main(color),
            "decompose_flagship_floor": lambda: decompose_flagship_floor.main(color),
            "decompose_fastdvd_floor": lambda: decompose_fastdvd_floor.main(),
            "bench_fastdvd_bf16": lambda: bench_fastdvd_bf16.main(),
            "ab_ddnet_precision": lambda: ab_ddnet_precision.main(color),
            "ab_cv_guard": lambda: ab_cv_guard.main(),
            "ab_weight_select": lambda: ab_weight_select.main(),
            "ab_demosaic_select": lambda: ab_demosaic_select.main(color),
            "sweep_fastdvd_relax": lambda: sweep_fastdvd_relax.main(list(SCENE_STANDINS)),
            "sweep_fidelity": lambda: sweep_fidelity.main(),
            "bench_2048_adaptive": lambda: bench_2048_adaptive.main(color, STUDIES_FULL_COMBOS),
            "diag_teacher_sigma": lambda: diag_teacher_sigma.main(color),
            "eval_teacher_inloop": lambda: eval_teacher_inloop.main(color),
        }

        def numbers(v):
            """A tool's rows without their solver results and output arrays."""
            if hasattr(v, "x_bayer"):
                return None
            if isinstance(v, dict):
                return {k: numbers(u) for k, u in v.items() if not str(k).endswith("_out")}
            if isinstance(v, (list, tuple)):
                return [numbers(u) for u in v]
            return v

        for tool, run in full.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            out, text = quiet(run)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            emit("studies_full", tool=tool, seconds=secs, launches=dict(cuda_kernels.launches),
                 peak_mem_bytes=torch.cuda.max_memory_allocated(), table=text.splitlines(),
                 result=json.loads(json.dumps(numbers(out), default=str)), **card)
            torch.cuda.empty_cache()

    # --------------------------------------------------------------- bench
    if phases & {"bench", "suite", "suite_full"}:
        from adaptivepnp_sci_torch import bench, bench_batched
        from adaptivepnp_sci_torch import run_benchmark_suite as suite

    if "bench" in phases:
        torch.cuda.empty_cache()
        bench_counts = {k: 0 for k in _K}
        readings = {}
        for size in (BENCH_SIZE, BENCH_JAX_SIZE):
            for mode in bench.MODES:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                cuda_kernels.reset_launches()
                t0 = time.perf_counter()
                (line, res), text = quiet(lambda: bench.main(mode, "cuda", size))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts = dict(cuda_kernels.launches)
                # the warm-up and 6 timed runs, and in the flagship mode the leaves scene
                runs = 7 + (mode == "flagship")
                want = {k: runs * v for k, v in BENCH_LAUNCHES[mode].items()}
                for name, r in res.items():
                    require(tuple(r.x_bayer.shape) == (8, size, size)
                            and bool(torch.isfinite(r.x_bayer).all()
                                     & torch.isfinite(r.x_rgb).all()),
                            f"bench {mode} {size} {name}: shapes or non-finite output")
                fields = {}
                if size == BENCH_JAX_SIZE:
                    got = {mode: line["psnr_db"]}
                    if mode == "flagship":
                        got["flagship_natural"] = line["psnr_db_natural"]
                    gaps = {k: abs(v - BENCH_JAX_DB[k]) for k, v in got.items()}
                    fields = dict(jax_cpu_db={k: BENCH_JAX_DB[k] for k in got},
                                  against_jax_db=gaps, bar_db=BENCH_JAX_BAR_DB)
                    readings.update(gaps)
                else:
                    for k in _K:
                        bench_counts[k] += counts[k]
                    report.setdefault("bench", {})[mode] = line
                emit("bench", mode=mode, shape=[8, size, size], line=json.loads(text.strip()),
                     unrounded=line, seconds=secs, launches=counts, launches_predicted=want,
                     peak_mem_bytes=torch.cuda.max_memory_allocated(),
                     weights="adaptivepnp_sci_torch/weights/ffdnet_color_init0.npz", **fields,
                     **card)
                print(text.strip(), flush=True)
                require(counts == want, f"bench {mode} {size}: launches {counts}, want {want}")
                require(all(v <= BENCH_JAX_BAR_DB for v in fields.get("against_jax_db",
                                                                        {}).values()),
                        f"bench {mode} {size}: {fields} against JAX's CPU readings")
        report["launches_bench"] = bench_counts
        emit("bench_total", against_jax_db=readings, bar_db=BENCH_JAX_BAR_DB,
             launches=bench_counts, **card)

    # --------------------------------------------------------------- suite
    if "suite" in phases:
        st = STUDIES
        size, narrow = st["size"], dict(nc=st["nc"], nb=st["nb"])
        small = ffdnet_from_flax(flax_style_ffdnet_params(st["nc"], st["nb"], seed=0))
        cfg = suite.suite_configs(st["cut"], st["interval"])
        suite_counts = {k: 0 for k in _K}
        suite_shapes: dict = {}
        failed = []
        t_phase = time.perf_counter()

        def x_gaps(g, c):
            d = g.double().cpu() - c.double().cpu()
            return {"max": float(d.abs().max()), "rms": float(d.pow(2).mean().sqrt())}

        def compare(name, g_db, c_db, gx, cx, bars, counts, want, **extra):
            gaps = {"db": abs(g_db - c_db), **x_gaps(gx, cx)}
            emit("suite", row=name, shape=[8, size, size], launches=counts,
                 launches_predicted=want, gaps=gaps, bars=bars, psnr_cuda=g_db, psnr_cpu=c_db,
                 **extra, **card)
            if counts != want:
                failed.append(f"suite {name}: launches {counts}, predicted {want}")
            if not (all(gaps[k] <= v for k, v in bars.items())
                    and bool(torch.isfinite(gx).all())):
                failed.append(f"suite {name}: card against the CPU {gaps}, bars {bars}")

        def counted_run(run):
            torch.cuda.synchronize()
            cuda_kernels.reset_launches()
            out = run()
            torch.cuda.synchronize()
            for shp, k in cuda_kernels.convpair_launches.items():
                suite_shapes[shp] = suite_shapes.get(shp, 0) + k
            counts = dict(cuda_kernels.launches)
            for k in _K:
                suite_counts[k] += counts[k]
            return out, counts

        for key in suite.ROWS:
            def rows(d, key=key):
                return suite.run_rows(size, d, small, st["cut"], st["interval"], n=0,
                                      rows=(key,), model=FFDNet(**narrow))[0]

            (_, name, secs, g_db, _, g), counts = counted_run(lambda: rows("cuda"))
            _, _, cpu_s, c_db, _, c = rows("cpu")
            bars = (STUDIES_BF16_LOOP if key in SUITE_BF16_LOOP else
                    STUDIES_BF16 if key in SUITE_BF16 else STUDIES_F32)
            compare(key, g_db, c_db, g.x_bayer, c.x_bayer, bars, counts, suite_launches(key),
                    label=name, iters=list(cfg[key].iters) if key in cfg else [40],
                    card_s=secs, cpu_s=cpu_s)
        for t in SUITE_BATCHES:
            def batched(d, t=t):
                return quiet(lambda: bench_batched.main(
                    small, (t,), size, d, cfg["2"], n=0, model=FFDNet(**narrow)))[0][0]

            (_, secs, _, g_db, _, gx), counts = counted_run(lambda: batched("cuda"))
            _, cpu_s, _, c_db, _, cx = batched("cpu")
            compare(f"bench_batched t={t}", g_db, c_db, gx, cx, STUDIES_F32, counts,
                    suite_launches(f"t{t}"), card_s=secs, cpu_s=cpu_s)
        # row 4 uncut at bench.py's size: the bench flagship's call
        torch.cuda.synchronize()
        cuda_kernels.reset_launches()
        (_, _, _, row4_db, _, r4), = suite.run_rows(BENCH_SIZE, "cuda", n=0, rows=("4",))
        torch.cuda.synchronize()
        gap4 = abs(row4_db - report["bench"]["flagship"]["psnr_db"])
        emit("suite", row="4 at 512^2, uncut", psnr_db=row4_db,
             bench_flagship_psnr_db=report["bench"]["flagship"]["psnr_db"], gap_db=gap4,
             bar_db=SUITE_ROW4_DB, launches=dict(cuda_kernels.launches), **card)
        if gap4 > SUITE_ROW4_DB or dict(cuda_kernels.launches) != FLAGSHIP_LAUNCHES:
            failed.append(f"suite row 4 at 512^2: {gap4} dB from the bench flagship, "
                          f"launches {cuda_kernels.launches}")
        require(not failed, "; ".join(failed))
        report["launches_suite"] = suite_counts
        report["launches_convpair_suite"] = suite_shapes
        emit("suite_total", seconds=time.perf_counter() - t_phase, launches=suite_counts,
             **card)

    # ---------------------------------------------------------- suite_full
    if "suite_full" in phases:
        # the suite's rows and the batched sweep at their published sizes,
        # FFDNet-color with bench.py's fallback variables (its dB mean nothing)
        torch.cuda.empty_cache()
        rows = []
        for key in suite.ROWS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            (row,) = suite.run_rows(rows=(key,))
            torch.cuda.synchronize()
            frames = suite.N_BATCHED * 8 if key == "5b" else 8
            emit("suite_full", row=key, label=row[1], shape=list(row[5].x_bayer.shape),
                 seconds_per_run=row[2], frames_per_s=frames / row[2], psnr_db=row[3],
                 ssim=row[4], runs=1 + suite.ROW_N[key], seconds=time.perf_counter() - t0,
                 peak_mem_bytes=torch.cuda.max_memory_allocated(),
                 launches=dict(cuda_kernels.launches), **card)
            rows.append(row)
            torch.cuda.empty_cache()
        print(suite.table(rows, 512, "cuda"), flush=True)
        cuda_kernels.reset_launches()
        t0 = time.perf_counter()
        sweep, text = quiet(lambda: bench_batched.main())
        emit("suite_full", tool="bench_batched", lines=text.splitlines(),
             rows=[{"t": r[0], "seconds_per_run": r[1], "frames_per_s": r[2], "psnr_db": r[3],
                    "peak_mem_bytes": r[4]} for r in sweep],
             out_of_memory_at=next((r[0] for r in sweep if r[2] is None), None),
             seconds=time.perf_counter() - t0, launches=dict(cuda_kernels.launches), **card)
        del sweep, rows
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- kernels
    if "kernels" in phases:
        # launches on the main paths: the flagship's for its two kernels, the
        # bf16 FastDVDnet reconstruction's for the conv pair; and on the
        # deep-demosaicking row
        launches = dict(report["launches"])
        launches_ddnet = dict(report["launches_ddnet"])
        launches_tiled = dict(report["launches_tiled"])
        launches_sequence = dict(report["launches_sequence"])
        launches_cli = dict(report["launches_cli"])
        launches_train = dict(report["launches_train"])
        launches_scenes = dict(report["launches_scenes"])
        launches_parallel = [dict(r) for r in report["launches_parallel_tiled"]]
        tools = {k: report[f"launches_{k}"] for k in ("eval_weights", "harvest", "seams")}
        launches_studies = dict(report["launches_studies"])
        launches_bench = dict(report["launches_bench"])
        launches_suite = dict(report["launches_suite"])
        for name, shape in CONVPAIR_MAIN_SHAPES.items():
            launches_scenes[f"convpair_{name}"] = report["launches_convpair_scenes"].get(shape, 0)
            launches_cli[f"convpair_{name}"] = report["launches_convpair_cli"].get(shape, 0)
            launches_train[f"convpair_{name}"] = report["launches_convpair_train"].get(shape, 0)
            launches[f"convpair_{name}"] = report["launches_convpair"][shape]
            launches_ddnet[f"convpair_{name}"] = report["launches_convpair_ddnet"][shape]
            launches_tiled[f"convpair_{name}"] = report["launches_convpair_tiled"][shape]
            launches_sequence[f"convpair_{name}"] = 0
            # the studies run at 64^2: the pair of the same C at that size
            c, h, w = shape
            launches_studies[f"convpair_{name}"] = report["launches_convpair_studies"].get(
                (c, h * STUDIES["size"] // 512, w * STUDIES["size"] // 512), 0)
            launches_suite[f"convpair_{name}"] = report["launches_convpair_suite"].get(
                (c, h * STUDIES["size"] // 512, w * STUDIES["size"] // 512), 0)
            launches_bench[f"convpair_{name}"] = 0
        pallas = {"x_update": "adaptivepnp_sci_tpu/ops/pallas_kernels.py:58",
                  "tv_chambolle": "adaptivepnp_sci_tpu/ops/pallas_kernels.py:93",
                  "convpair": "scripts/ab_pallas_convpair.py:47"}
        sources = {"x_update": "x_update.cu", "tv_chambolle": "tv_chambolle.cu",
                   "convpair": "convpair_wgmma.cu"}
        extra = {"x_update": ("items2_ms", "items2_plain_ms", "items2_bound_ms"),
                 "tv_chambolle": ("ms_1024", "ms_288")}
        rows = []
        for name, kernel in (("x_update", "x_update"), ("tv_chambolle", "tv_chambolle"),
                             *((f"convpair_{n}", "convpair") for n in CONVPAIR_MAIN_SHAPES)):
            r = report[name]
            rows.append({"name": name, "route": "cuda",
                         "source": f"adaptivepnp_sci_torch/csrc/{sources[kernel]}",
                         "replaces": pallas[kernel], "launches": launches[name],
                         "launches_ddnet_row": launches_ddnet[name],
                         "launches_tiled": launches_tiled[name],
                         "launches_sequence": launches_sequence[name],
                         "launches_cli": launches_cli[name],
                         "launches_train": launches_train[name],
                         "launches_scenes": launches_scenes[name],
                         "launches_studies": launches_studies[name],
                         "launches_bench": launches_bench[name],
                         "launches_suite": launches_suite[name],
                         "launches_parallel_tiled_per_rank": [p[name] for p in launches_parallel],
                         **{f"launches_{k}": v[name] for k, v in tools.items()},
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "previous_ms": r.get("previous_ms"), "plain_ms": r["plain_ms"],
                         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                         "library_ms": r.get("library_ms"),
                         **{k: r[k] for k in extra.get(name, ())}})
        require(all(r["launches"] > 0 and r["launches_ddnet_row"] > 0 and r["launches_tiled"] > 0
                    and r["launches_cli"] > 0 and r["launches_train"] > 0
                    and r["launches_scenes"] > 0
                    and min(r["launches_parallel_tiled_per_rank"]) > 0 for r in rows),
                f"a kernel was never launched: {rows}")
        require(all(r["launches_sequence"] > 0 and r["launches_eval_weights"] > 0
                    and r["launches_seams"] > 0 for r in rows[:2]),
                f"the sequence, eval_weights or seam path missed a kernel: {rows}")
        require(all(r["launches_harvest"] > 0 for r in rows),
                f"harvest_iterates missed a kernel: {rows}")
        require(all(r["launches_studies"] > 0 for r in rows),
                f"the A/B, sweep and decomposition tools missed a kernel: {rows}")
        require(all(r["launches_suite"] > 0 for r in rows)
                and all(r["launches_bench"] > 0 for r in rows[:2]),
                f"the benchmark suite or bench.py's modes missed a kernel: {rows}")
        # the frame-sharded snapshots: the split x-update (the fused form runs
        # on none of them), the TV and conv-pair kernels on each rank's frames
        frame = report["launches_parallel_frame"]
        for r in rows[1:]:
            r["launches_parallel_frame_fastdvd_bf16_per_rank"] = [
                c[r["name"]] for c in frame["frame_fastdvd_full"]]
        split = report["x_update_split"]
        rows.append({"name": "x_update_split", "route": "cuda",
                     "source": "adaptivepnp_sci_torch/csrc/x_update.cu",
                     "replaces": pallas["x_update"],
                     "launches": frame["frame_flagship_full"][0]["x_update"],
                     "launches_per_rank": {n: [c["x_update"] for c in v]
                                           for n, v in frame.items()},
                     "max_abs_err": split["max_abs_err"], "ms": split["ms"],
                     "warm_l2_ms": split["warm_l2_ms"], "items2_ms": split["items2_ms"],
                     "plain_ms": split["plain_ms"], "bound_ms": split["bound_ms"],
                     "bound_by": split["bound_by"], "library_ms": split["library_ms"]})
        require(all(c["x_update"] > 0 for v in frame.values() for c in v)
                and all(min(r["launches_parallel_frame_fastdvd_bf16_per_rank"]) > 0
                        for r in rows[1:-1]),
                f"a kernel was never launched on the frame-sharded path: {rows}")
        print(json.dumps({"kernels": rows}), flush=True)

    emit("total", seconds=time.perf_counter() - T0, phases=sorted(phases), **card)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "adaptivepnp_sci_tpu"))
    require(not foreign, f"JAX modules were imported: {foreign}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
