#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (`gapartnet_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from `gapartnet_tpu_torch/csrc/` (one nvcc per
source, in parallel), then:

  1. prints the card (nvidia-smi name and power limit), the torch, CUDA and
     nvcc versions, the kernel build time, ptxas's registers and shared
     memory per kernel and, from `cuobjdump -sass`, each kernel's count of
     tensor-core (HMMA, HGMMA) and asynchronous-copy (LDGSTS, UBLKCP)
     instructions; it fails if the forward or wgrad kernel has none of
     either;
  2. holds the submanifold-conv kernel against its plain PyTorch version on
     every distinct (level, Cin, Cout) of the backbone, on the real
     hierarchy of assets/bench_cloud.npz, and times both with CUDA events
     around each call (median of 10 launches, wrapper host time included),
     and the kernel alone by its device time per launch (torch.profiler,
     median of three windows of 10 launches);
  3. drives the flagship inference forward on the card (bench-cloud
     capacities and clustering overrides, seeded random weights): 5
     warm-ups, then 20 timed requests (median and spread); it checks that
     the kernel launched exactly 53 times per forward, that every capacity
     counter is zero and that every output is finite; it profiles one
     forward for its device time;
     then it holds the kernel against its plain version on the hierarchy of
     `entry()`'s cloud (default capacities) and runs `entry()` once as a
     user would, counting its launches;
  4. runs the same forward, weights and inputs on the CPU (plain versions)
     and compares: integer outputs exactly, floats within stated
     tolerances;
  5. training (the second slice's main path): on the B = 8 batch of
     `train_setup` (eight rotated copies of the cloud), holds the forward,
     dgrad and wgrad kernels against their plain versions at every distinct
     (V, Cin, Cout) of the backbone and the two proposal UNets, checks that
     the wgrad is bitwise repeatable, and times all six (CUDA events,
     median of 10) and the three kernels' device time (profiler); then
     drives `train_step` (all three stages, Adam 1e-3): 3 warm-ups and 10
     timed steps, checking the launch counts per step, zero counters,
     finite losses, a moving loss and moving BN statistics; profiles one
     step;
  6. runs one train step at B = 2 on the card (four times) and on the CPU
     with the same weights, jitter and inputs: integer outputs exactly,
     losses, every parameter's gradient and the updated running statistics
     within stated tolerances, the gradients' allowing for what rounding
     alone does to them on the CPU;
  7. the inference API at the flagship config with the eval capacities of
     train/trainer.py:452, seeded random weights, auto_capacity: predict on
     the bench cloud and predict_with_masks on its ground-truth instances
     (3 warm-ups, 3 timed requests each), predict_depth on a depth frame
     rendered from the cloud (1 warm-up, 2 timed requests; FPS timed
     alone); the kernel against its plain version on the hierarchy each of
     the three builds; 53 forward launches per request; the time of each
     request split into forward, selection (NMS), host scatter and RANSAC
     (CUDA events), with the device time of the selection, RANSAC and FPS
     alone;
     every counter printed (zero for the masks); each request again on the
     CPU with the same weights and RANSAC samples: integers (sem_preds,
     instances, kept proposals, classes, FPS indices, inlier masks, ok
     flags, counters) exactly, NPCS and scores within 1e-4 and boxes within
     1e-3 of scale; estimate_joint_angle once per branch on a rotated part;
  8. prints the wall time of each phase, one {"kernels": [...]} JSON line
     (the fp32 kernels, then the bf16 ones), the nvidia-smi line and, last,
     the device line {"ok": true, "device": {...}}, after phase 15;
  9. the trainer (the fifth slice's main path), in a temporary directory:
     a dataset of assets/bench_cloud.npz rotated about z (48 train clouds,
     3 per eval split, so each eval split ends in a padded batch);
     configs/gapartnet.yaml read by the port's reader with the overrides
     of FIT_OVERRIDES (8 clouds per step, widths, points and proposals not
     cut); `trainer.fit(cfg, device="cuda")` in process: 2 epochs of 6
     steps and a validation of the three splits after each, checking the
     forward, dgrad and wgrad launches of every train step at its epoch's
     flags and 53 forward launches per eval forward, finite losses, the
     metric names of metrics.jsonl, the top-k checkpoints and `last`; it
     prints each epoch's epoch_time_s, each step's time, the median and
     spread of each epoch's steps after its first, the time per split
     validation and per checkpoint save, and every counter; then it holds
     the forward, dgrad and wgrad kernels against their plain versions at
     the fit's shapes (the backbone hierarchy of a fit train batch at the
     fit's auto_capacity levels, the proposal grid of a train forward with
     the fitted weights, and the eval model's hierarchy of the val split's
     padded batch); then a frozen-trunk epoch
     warm-started from `last` (the frozen parameters and running statistics
     bitwise unchanged, the score and NPCS parameters moved); then the CLI
     in two subprocesses, as users run it: `fit --trainer.ckpt_path` of
     the epoch-0 checkpoint (resumes at epoch 1 with its step counts and
     jitter generator, logs epoch 1 only; under `python -m
     torch.distributed.run --standalone --nproc_per_node 1`, so NCCL and the
     CLI's launcher branch run at world size 1) and `test` of `last`; last,
     one reduced eval step on the val split's last batch of 2 (its last
     cloud padded, with no valid point) at the eval capacities with the fit's
     weights on the card and on the CPU (conf, keep, rep_cls and counters
     exactly, scores and IoUs within 1e-4, no proposal kept in the padded
     cloud; a near-tie sem flip switches to the CPU forward on the card's
     proposals, as in phase 7);
 10. data-parallel training (the sixth slice's main path): two ranks in
     spawned processes on the one card (gloo; NCCL refuses two ranks on one
     card), each with B = 4 of phase 5's 8 clouds, phase 5's seeded weights
     and jitter, the clustering overrides and all three stages.  First, in
     this process, the one-process B = 8 card step from that start and four
     probes (phase 6's rounding allowance).  Each rank holds the forward,
     dgrad and wgrad kernels against their plain versions at its own
     shapes, takes 2 warm-up steps (the first held against the one-process
     step: the ranks' summed losses and the running statistics within 1e-4
     of magnitude, gradients within phase 6's allowance) and 2 timed
     steps (77 / 76 / 77 launches per step, zero counters, finite losses;
     ms per step, all-reduces per step, gradient bytes per step), checks
     its parameters and buffers bitwise against rank 0's, and times the
     gradient all-reduce alone (CUDA events).  Then `trainer.fit` on both
     ranks for one epoch on phase 9's dataset cut to 23 train clouds: the
     shards disjoint and covering, the same number of steps (the fewer full
     batches: 2), the same logged metrics, and metrics.jsonl and the
     checkpoints from rank 0 alone.  The ranks share the card and the host,
     so their step times are no scaling figure;
 11. bf16 conv compute, bench.py's configuration
     (GAPartNetConfig(conv_compute_dtype="bfloat16")), the seventh slice's
     main path: the bf16 forward, dgrad and wgrad kernels
     (csrc/subm_conv_bf16.cu, csrc/subm_conv_wgrad_bf16.cu; SASS must hold
     wgmma, HGMMA, checked in phase 1) against their plain versions at every
     backbone shape of bench_cloud_setup and every training shape of
     train_setup at bf16, each twice and bitwise equal, each call one kernel
     launch or two where its plan splits taps or chunks rows (profiler: no
     operand copy), timed (CUDA events, profiler device time, plain
     version) beside their bound at the bf16 tensor-core peak and the HBM
     rate, with the bytes the call reads (fp32 rows, no copy) printed
     beside the bound's bf16 bytes; the bare forward, 5 warm-ups
     and 20 timed (53 fwd_bf16 launches each and no fp32 subm-conv launch,
     zero counters, finite outputs, a profile with the cuDNN bf16 rows),
     printed beside phase 3's fp32 median, then 6 fp32 and 6 bf16
     forwards in turns (the same weights; an A/B free of the host's drift
     over the call); the same forward on the CPU
     (integers exactly, sem_preds outside near-ties, floats within 1e-4 of
     scale plus twice what two CPU probes with every BatchNorm output moved
     by +-1 fp32 ulp move them: a bf16 network carries an fp32 rounding
     difference on as flipped bf16 roundings); train_step at B = 8 (3
     warm-ups, 10 timed, 77 / 76 / 77 bf16 launches and no fp32 one, zero
     counters, moving losses and statistics, a profile), then 3 fp32 and
     3 bf16 steps in turns; one card step, with PyTorch's deterministic
     scatter-adds, against the CPU step at B = 2 with phase 6's allowance,
     plus the probes' move for losses and running statistics, and for
     gradients BF16_KINK_FACTOR times the probes' move and one bf16 ulp of
     scale (--compare-draws N: this check over N draws, then stop);
 12. the model's other two configurations (the ninth slice's main path):
     12a, exact clustering (GAPartNetConfig(clustering_impl="exact"), the
     reference's first-K ball query and list CCL, ops/ball_query.py and
     ops/ccl.py) on the bench cloud with the overrides, the proposal cap
     and dense pool fitted to it: 3 warm-ups, then 10 exact forwards in
     turns with 10 hash forwards (each exact forward: 53 forward launches,
     2 ball queries, 2 CCLs, counted around it; zero counters); the ball
     query and the CCL of both sets alone (ms per call by CUDA events,
     kernel ms and launches by the profiler, tiles and CCL iterations, each
     a host sync) and against the CPU (neighbour lists, counts, labels
     exactly); the forward against the CPU (phase 4's rules); 2
     GAPartNetInference.predict requests with exact clustering at the eval
     capacities against the CPU (phase 7's rules, counters equal to the
     CPU's); 12b, the PointNet backbone (GAPartNetConfig(backbone_type=
     "PointNet")) at phase 5's B = 8 batch and capacities: the forward,
     dgrad and wgrad kernels against their plain versions at the proposal
     UNets' shapes of this step, 2 warm-ups and 5 timed train steps (24 /
     24 / 24 launches per step, zero counters), a profiled step, one
     deterministic B = 2 step against the CPU (phase 6's allowance, with
     phase 11's terms for rounding-sensitive steps but the bf16 ulp: the
     transformers' fc BatchNorms take E[x^2] - mean^2 over the B rows) and
     one B = 1 eval forward against the CPU (phase 4's rules).  The kernel
     line adds phase 12's launches to the fp32 kernels' counts;
 13. dataset generation -> predict_depth -> train steps (the tenth slice's
     main path), at the JAX defaults (800 x 800 views, 1,000,000 surface
     samples, 20000 points, GAPartNetConfig()), in a temporary directory:
     13a, datagen/synthetic.generate_assets writes a Box, a Remote and a
     Microwave; one view of each is rendered without SAPIEN
     (datagen/assets.render_view_maps: host render ms, foreground pixels)
     and its foreground sampled by FPS on the card (ms); render_asset_view
     of the view with the fewest foreground pixels, once with FPS on the
     card and once on the CPU: every array of the two .npz files equal,
     FPS indices included; 13b, predict_depth on a rendered view through
     the demo's --asset path (demo.asset_request; seeded random weights,
     auto_capacity): 53 forward launches, the forward kernel against its
     plain version on this request's hierarchy, the counters and the stage
     split; 13c, ingest_asset (FPS on the card) until 4 clouds, loaded
     through GAPartNetDataset with the native instance statistics
     (data/native_loader.py, built with g++) and held equal to the plain
     NumPy version's items; the forward, dgrad and wgrad kernels against
     their plain versions at this batch's shapes; 1 warm-up and 3 train
     steps at B = 4 (fp32, all three stages, phase 5's clustering
     overrides) timed by utils/profiling.StepTimer around a synchronize,
     77 / 76 / 77 launches per step, zero counters, finite losses; one
     more step traced by utils/profiling.maybe_trace, whose Chrome trace
     must name the subm-conv kernels; device_memory_stats().  The kernel
     line adds phase 13's launches to the fp32 kernels' counts;
 14. the checkpoint tools (the eleventh slice's main path), at
     GAPartNetConfig() widths, with phase 9's checkpoint `last`: 14a,
     `last` written as the reference's Lightning .ckpt (spconv layout, the
     inverse of train/ckpt_convert, `reference_state_dict`) and read back
     through tools/eval_parity's own loading: every tensor bitwise equal;
     14b, `python -m gapartnet_tpu_torch.tools.eval_parity` through its
     main(argv) on 2 rotated bench clouds per split (exact clustering,
     --batch 2, the tool's default capacities): every eval metric name
     logged and finite, 53 forward launches per eval batch, the counters
     printed; the kernel against its plain version on the hierarchy of the
     tool's val batch; one reduced eval step (the val split's last cloud)
     card vs CPU (phase 9's rules); then with --bf16 (53 fwd_bf16 launches
     per batch, the bf16 forward against its plain version); 14c,
     tools/visu's run with --ckpt `last` on the bench cloud's .npz and on
     an OBJ of it with 4000 more jittered vertices (FPS 24000 -> 20000 on
     the card, indices equal to the CPU's): 53 launches per predict, each
     predict against the CPU's (phase 7's rules; at these default
     capacities the hash node table overflows, so where sem_preds agree
     but the clustering's integers differ, an offset within tolerance of a
     hash-cell face must explain it and the CPU's clustering of the card's
     offsets must give the card's integers; --visu-draws N: this check
     over N rotated clouds, then stop); the panels where cv2 is
     importable, else write_panels must raise naming cv2.  The kernel line
     adds phase 14's launches to the fp32 and bf16 forwards' counts;
 15. the sustained staged-training tool (the twelfth slice's main path):
     `python -m gapartnet_tpu_torch.tools.sustained_run --two-phase
     --freeze-trunk-b --sem-alpha auto --add-zoom --device cuda` through
     its main(argv), in a temporary directory, at GAPartNetConfig() widths
     (make_cfg: bf16 conv compute, hash clustering, auto_capacity, 20000
     points, B = 8), cut on one [cut] line: the reference's two real
     assets replaced by generated stand-ins, the view plans cut to 10
     distant and 2 close-up views (every split non-empty), phase A to 2
     epochs and phase B to 3 (one validation each).  It checks (a) each
     split's clouds against the cut plan's allocation under the tool's
     skip rule; (b) phase_a_done and a _recall_gmp_ best checkpoint of
     phase A; (c) every parameter and running statistic under the five
     frozen prefixes of checkpoints/last bitwise equal to best_a's; (d)
     both tests (last, best) under the tool's zero-overflow contract
     (GAPARTNET_CHECKS and GAPARTNET_ALLOW_OVERFLOW unset for the run) and
     their test_metrics files; the bf16 launches of every train step (53 /
     52 / 53 in phase A, 77 / 24 / 24 in the frozen phase B) and eval
     forward (53), none fp32; then the diagnostics on the run's
     checkpoints, (f): confusion_diag on 2 val views on the card and on
     the CPU (tables equal up to near-tie sem flips, the tolerance with a
     BatchNorm-ulp CPU probe's allowance), proposal_diag (gt per class =
     the split's instances, born >= iou50 >= match-gt, born >= scored >=
     kept), margin_diag (a finite row per checkpoint) and a 1-epoch
     valley_probe (its trajectory); (e) the bf16 forward, dgrad and wgrad
     against their plain versions at the run's shapes (phase B's train
     batch, the val split's padded batch).  The kernel line adds phase
     15's launches to the bf16 kernels' counts.

Any failure raises and exits non-zero.  Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.

To compare two versions of the kernels on one card, in one call:

    python3 chip_smoke.py --kernels-only --port-root <other checkout>
    python3 chip_smoke.py --kernels-only

runs phases 1, 2 and the kernel half of 5 on that checkout's package, the
bf16 kernels at the bare forward's and the train step's shapes (phase 11a),
prints device and call ms per B = 8 step and per B = 1 forward of all six
kernels, then the kernel line (launches null) and the nvidia-smi line (no
phase 10 or 11).
"""

import collections
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
import unittest.mock
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.  The kernels
# compute in 3xTF32 on the tensor cores (three TF32 products per fp32
# product), so their bound takes a third of the TF32 peak; the CUDA-core
# fp32 peak gives `bound_fp32_ms`, the bound of the earlier fp32-FMA kernels
PEAK_TF32_FLOPS = 495e12
PEAK_TF32X3_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
# the bf16 kernels: one bf16 mma per product, at the dense bf16 peak
PEAK_BF16_FLOPS = 989e12
# the kernels of each wrapper, as torch.profiler names them (the bf16 ones
# also by their names before the wgmma redesign, so that --kernels-only
# --port-root times an older checkout's kernels too)
KERNEL_NAMES = {"fwd": ("subm_conv_fwd_kernel", "sum_splits_kernel"),
                "dgrad": ("subm_conv_fwd_kernel", "sum_splits_kernel"),
                "wgrad": ("subm_conv_wgrad_kernel", "sum_chunks_kernel"),
                "fwd_bf16": ("subm_conv_bf16_wgmma_kernel", "subm_conv_bf16_fwd_kernel",
                             "sum_splits_bf16_kernel"),
                "dgrad_bf16": ("subm_conv_bf16_wgmma_kernel", "subm_conv_bf16_fwd_kernel",
                               "sum_splits_bf16_kernel"),
                "wgrad_bf16": ("subm_conv_wgrad_bf16_wgmma_kernel", "subm_conv_wgrad_bf16_kernel",
                               "sum_chunks_bf16_kernel")}
# the bf16 conv kernels: wgmma (HGMMA in SASS) on bf16 operands
BF16_KERNELS = ("subm_conv_bf16_wgmma_kernel", "subm_conv_wgrad_bf16_wgmma_kernel")
SASS_OPS = ("HMMA", "HGMMA", "LDGSTS", "UBLKCP", "HMMA.16816.F32.BF16")
TIMED_LAUNCHES = 20
PROFILE_WINDOWS = 3
WARMUP_REQUESTS = 5
TIMED_REQUESTS = 30
CONVS_PER_FORWARD = 53
# the counters of ops/subm_conv.LAUNCHES: the fp32 kernels and the bf16 ones
KINDS = ("fwd", "dgrad", "wgrad", "fwd_bf16", "dgrad_bf16", "wgrad_bf16")


def launch_counts(**per_kind) -> dict:
    """{kind: count} over KINDS, 0 for each kind not given."""
    return {k: per_kind.get(k, 0) for k in KINDS}


TRAIN_BATCH = 8
WARMUP_STEPS = 3
TIMED_STEPS = 20
# per train step: 53 backbone + 12 + 12 proposal-UNet convs; every conv but
# the backbone stem (whose input needs no gradient) runs a dgrad
LAUNCHES_PER_STEP = launch_counts(fwd=77, dgrad=76, wgrad=77)
# kernel vs plain: fp32 both, only the summation order differs
KERNEL_RTOL = 1e-4
# wgrad vs plain: each entry sums up to B * V = 160000 products in fp32 in
# another order (chunked on the card, cuBLAS's in the plain version); the
# rounding of such a sum grows as sqrt(n) * eps ~ 3e-5 of its scale
WGRAD_RTOL = 1e-3
# card vs CPU train step (B = 2), CARD_RUNS card runs against one CPU run:
# losses within LOSS_RTOL; per parameter tensor
#   max|card - cpu| <= GRAD_RTOL * scale + KINK_FACTOR * max_p max|cpu_p - cpu|,
# scale = max(max|cpu|, GRAD_FLOOR * the largest gradient).  fp32 rounding
# alone stays below 1e-3 of scale.  At this random init some ReLUs and maxima
# sit at their kink to within rounding, and the branch that rounding picks
# moves a deep-level weight gradient by percents; the card picks its own
# branches (its scatter-adds sum in atomic order, so they change from run to
# run).  The second term admits what rounding alone does on the CPU: cpu_p is
# the CPU step with every parameter moved by +-PERTURB (relative, seeded
# normal noise, two antithetic pairs), which moves every layer's output by
# about PERTURB, more than the card's rounding does; of each pair, one probe
# crosses each kink that the card's rounding can cross
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-4
KINK_FACTOR = 2.0
PERTURB = 1e-6
PROBES = ((11, 1.0), (11, -1.0), (12, 1.0), (12, -1.0))
CARD_RUNS = 4
STATS_RTOL = 1e-4
# card vs CPU forward: fp32 through ~60 conv layers, sums in other orders
FORWARD_RTOL = 1e-4
# dense proposal cells may move by one cell on at most this share of entries
CELL_FLIP_SHARE = 1e-3
# the inference API (phase 7): requests per phase, the stages of a request
PREDICT_WARMUPS = 3
PREDICT_REQUESTS = 5
DEPTH_WARMUPS = 1
DEPTH_REQUESTS = 2
STAGES = ("forward", "select", "scatter", "ransac")
# the depth frame: the bench cloud DEPTH_OFFSET in front of a 640 x 480
# pinhole camera, each point splatted over a 7 x 7 square: about 90000 valid
# pixels, so predict_depth pre-crops to 80000 points and FPS runs 19999
# steps over them
DEPTH_HW = (480, 640)
DEPTH_K = ((700.0, 0.0, 320.0), (0.0, 700.0, 240.0), (0.0, 0.0, 1.0))
DEPTH_OFFSET = 3.0
DEPTH_SPLAT = 3
# card vs CPU requests: NPCS and scores as the forward's floats; the ok
# boxes, scales, rotations and translations within 1e-3 of scale (a refit
# sums up to thousands of rows and takes a 3x3 SVD, cuSOLVER against LAPACK)
NPCS_RTOL = FORWARD_RTOL
BOX_RTOL = 1e-3
# the trainer (phase 9): the dataset, the overrides of configs/gapartnet.yaml;
# 6 steps per epoch, so that epoch 1 times 5 steps after its first
FIT_BATCH = TRAIN_BATCH                            # the reference's 64 over 8 cards
FIT_TRAIN_CLOUDS = 6 * FIT_BATCH
FIT_EVAL_CLOUDS = 3
FIT_VAL_BATCH = 4
# the card-vs-CPU reduced eval step: the val split's last batch of this
# size, one cloud and one padded (the CPU eval forward dominates its time)
FIT_COMPARE_BATCH = 2
FIT_OVERRIDES = (
    ("data.init_args.train_batch_size", str(FIT_BATCH)),
    ("data.init_args.val_batch_size", str(FIT_VAL_BATCH)),
    ("data.init_args.num_workers", "4"),
    ("data.init_args.auto_capacity", "True"),
    ("model.init_args.training_schedule", "[0, 1]"),
    ("trainer.max_epochs", "2"),
)
# launches per train step at the fit's flags: epoch 0 clusters and runs the
# ScoreNet (53 backbone + 12 ScoreNet convs, the backbone stem without a
# dgrad), epoch 1 adds the NPCSNet's 12; a frozen-trunk step (all stages)
# runs no backward through the backbone
FIT_LAUNCHES_PER_STEP = {False: launch_counts(fwd=65, dgrad=64, wgrad=65), True: LAUNCHES_PER_STEP}
FROZEN_LAUNCHES_PER_STEP = launch_counts(fwd=77, dgrad=24, wgrad=24)
EVAL_FORWARD_LAUNCHES = launch_counts(fwd=CONVS_PER_FORWARD)
FREEZE = ("backbone", "sem_seg_head", "offset_mlp0", "offset_bn", "offset_mlp1")
# card vs CPU reduced eval step: scores and IoUs
FIT_SCORE_RTOL = 1e-4
CLI_TIMEOUT_S = 600
# data parallel (phase 10): two gloo ranks on the one card (NCCL refuses two
# ranks on one card), B = 4 each of phase 5's 8 clouds; the time per step of
# a rank is not a scaling figure, since the ranks share the card and host
DP_WORLD = 2
DP_BATCH = TRAIN_BATCH // DP_WORLD
DP_WARMUP_STEPS = 2
DP_TIMED_STEPS = 3
DP_ALLREDUCE_RUNS = 5
# the 2-rank fit: phase 9's dataset with 23 train clouds, so the ranks'
# shards hold 12 and 11 (3 and 2 batches of 4) and the fewer, 2, is what
# both run; one epoch with every stage
DP_FIT_TRAIN_CLOUDS = 23
DP_FIT_STEPS = (DP_FIT_TRAIN_CLOUDS // DP_WORLD) // DP_BATCH
DP_FIT_OVERRIDES = (
    ("data.init_args.train_batch_size", str(DP_BATCH)),
    ("model.init_args.training_schedule", "[0, 0]"),
    ("trainer.max_epochs", "1"),
)
DP_TIMEOUT_S = 600
# bf16 conv compute (phase 11), bench.py's configuration: the same 53 / 77
# / 76 / 77 convs on the bf16 kernels and none on the fp32 ones
BF16_FORWARD_LAUNCHES = launch_counts(fwd_bf16=CONVS_PER_FORWARD)
BF16_LAUNCHES_PER_STEP = launch_counts(fwd_bf16=77, dgrad_bf16=76, wgrad_bf16=77)
# bf16 kernel vs plain: the forward's fp32 sums of exact bf16 products in
# another order, as the fp32 kernels' (KERNEL_RTOL); the dgrad and wgrad
# round to bf16, so one bf16 ulp of the value more where the two fp32 sums
# round apart (wgrad: WGRAD_RTOL, sums over B * V rows); one bf16 ulp is at
# most 2^-7 of the value
BF16_ULP = 2.0 ** -7
# card vs CPU B = 2 train step at bf16: each gradient's allowance takes
# BF16_KINK_FACTOR (not KINK_FACTOR) times the four probes' largest move.
# The bf16 network carries a rounding difference on as flipped bf16
# roundings through every layer (training's batch statistics at the small
# coarse levels amplify them), so the card's move and each probe's are
# draws of one wide distribution, and over 319 tensors one card draw came
# to 2.6 times the largest of four probes (a BatchNorm bias of the NPCS
# UNet, on an H100 80GB HBM3 at 700 W)
BF16_KINK_FACTOR = 4.0
# cuBLAS's setting for deterministic results under
# torch.use_deterministic_algorithms (deterministic_ops)
CUBLAS_WORKSPACE = ":4096:8"
# card vs CPU forward at bf16: the CPU also runs once per seed with every
# BatchNorm output moved by +-1 fp32 ulp (what another fp32 rounding does)
NET_PROBES = (11, 12)
# the bf16 forward and train step against the fp32 ones, called in turns
AB_CALLS = 10
AB_STEPS = 5


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[-1]


def cuda_ms(fn, runs: int) -> float:
    """Median device time of `fn()` over `runs` launches, CUDA events."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, runs: int, names):
    """Device time per call of `fn()` of the kernels whose names contain one
    of `names`, each launched at most once per call: torch.profiler (CUDA
    activity) over `runs` calls after one warm-up, each kernel's mean over
    the launches the profiler recorded.  None if it saw no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total / e.count for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.count and any(n in e.key for n in names))
    return us / 1e3 if us > 0 else None


def device_ms(fn, runs: int, names):
    """The median of `_device_ms` over PROFILE_WINDOWS windows: the profiler
    now and then loses some or all of a window's kernels (hence also the
    mean over the launches it recorded).  None if it saw none in any
    window."""
    got = [ms for ms in (_device_ms(fn, runs, names) for _ in range(PROFILE_WINDOWS))
           if ms is not None]
    return statistics.median(got) if got else None


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def _fmt_count(n) -> str:
    return "not measured" if n is None else f"{n:g}"


def sass_counts(lib: Path):
    """{kernel<template args>: {op: count}} of the SASS_OPS instructions in
    a built library (`cuobjdump -sass`)."""
    from gapartnet_tpu_torch.ops.subm_conv import find_nvcc

    tool = Path(find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = re.search(r"(subm_conv_fwd_kernel|subm_conv_wgrad_kernel|sum_splits_kernel|"
                               r"sum_chunks_kernel|subm_conv_bf16_wgmma_kernel|"
                               r"subm_conv_wgrad_bf16_wgmma_kernel|subm_conv_bf16_fwd_kernel|"
                               r"subm_conv_wgrad_bf16_kernel|sum_splits_bf16_kernel|"
                               r"sum_chunks_bf16_kernel)", m.group(1))
            name = (kernel.group(1) if kernel else m.group(1)) + "<" + ",".join(
                re.findall(r"L[ib](\d+)E", m.group(1))) + ">"
            current = counts.setdefault(name, dict.fromkeys(SASS_OPS, 0))
        elif current is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{re.escape(op)}\b", line):
                    current[op] += 1
    return counts


def backbone_conv_shapes(channels, stem_in=6):
    """[(level, Cin, Cout, launches per forward)] of a SparseUNet's convs;
    stem_in=None for a UNet without a stem conv."""
    last = len(channels) - 1
    shapes = [] if stem_in is None else [(0, stem_in, channels[0], 1)]
    for li, c in enumerate(channels):
        shapes.append((li, c, c, 4 + (3 if li < last else 0)))
        if li < last:
            shapes.append((li, 2 * c, c, 1))
    return shapes


def phase_kernels(cfg, hierarchy, device, tag="kernel", timed=True):
    """Kernel vs plain version on every backbone shape of `hierarchy` (at
    its batch size); returns the rows (with CUDA-event times of both when
    `timed`)."""
    import torch

    from gapartnet_tpu_torch.ops.subm_conv import subm_conv, subm_conv_reference

    rows = []
    gen = torch.Generator(device=device).manual_seed(1234)
    for li, cin, cout, per_fwd in backbone_conv_shapes(cfg.channels):
        nbr = hierarchy.levels[li].subm_nbr
        b, _, v = nbr.shape
        feats = torch.randn((b, v, cin), generator=gen, device=device)
        w = torch.randn((27, cin, cout), generator=gen, device=device) / (27 * cin) ** 0.5
        ref = subm_conv_reference(feats, nbr, w)
        out = subm_conv(feats, nbr, w)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if not err <= KERNEL_RTOL * scale:
            raise AssertionError(
                f"subm_conv disagrees at level {li} ({cin}->{cout}): "
                f"max|d| {err} > {KERNEL_RTOL} * max|ref| {scale}"
            )
        pairs = int((nbr >= 0).sum())
        if not timed:
            rows.append(dict(level=li, cin=cin, cout=cout, V=v, max_abs_err=err))
            print(f"[{tag}] level {li} {cin:>3}->{cout:<3} B={b} V={v:<6} pairs={pairs:<7} "
                  f"max|d| {err:.3e} (max|ref| {scale:.3e})")
            continue
        ms = cuda_ms(lambda: subm_conv(feats, nbr, w), TIMED_LAUNCHES)
        dev_ms = device_ms(lambda: subm_conv(feats, nbr, w), TIMED_LAUNCHES, KERNEL_NAMES["fwd"])
        plain_ms = cuda_ms(lambda: subm_conv_reference(feats, nbr, w), TIMED_LAUNCHES)
        flops = 2 * cin * cout * pairs
        nbytes = 4 * (b * v * cin + 27 * b * v + 27 * cin * cout + b * v * cout)
        bound_ms, _ = _bound(flops, nbytes)
        rows.append(dict(
            level=li, cin=cin, cout=cout, V=v, pairs=pairs, per_forward=per_fwd,
            max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_fp32_ms=_bound(flops, nbytes, PEAK_FP32_FLOPS)[0], flops=flops, bytes=nbytes,
        ))
        print(f"[{tag}] level {li} {cin:>3}->{cout:<3} V={v:<6} pairs={pairs:<7} "
              f"x{per_fwd}/fwd  call {ms:.4f} ms  device {_fmt(dev_ms)} ms  bound "
              f"{bound_ms:.4f} ms  plain {plain_ms:.4f} ms  max|d| {err:.3e} (max|ref| {scale:.3e})")
    return rows


def run_forward(model, batch, cluster_sem, cluster_off):
    import torch

    with torch.no_grad():
        return model(batch, do_cluster=True, do_score=True, do_npcs=True,
                     cluster_sem_override=cluster_sem, cluster_offset_override=cluster_off)


def phase_forward(cfg, batch, cluster_sem, cluster_off, smi, kind="fwd", tag="forward"):
    """The flagship forward on the card; `kind` the counter its 53 convs
    must launch ("fwd", or "fwd_bf16" at bf16 compute) and no other.

    Returns (model, last output, kernel launches counted over the timed
    requests, ms per request)."""
    import torch

    from gapartnet_tpu_torch.entry import make_model
    from gapartnet_tpu_torch.ops.subm_conv import LAUNCHES, reset_launches

    model = make_model(cfg, "cuda", seed=0)
    for _ in range(WARMUP_REQUESTS):
        run_forward(model, batch, cluster_sem, cluster_off)
    torch.cuda.synchronize()
    reset_launches()
    times = []
    for _ in range(TIMED_REQUESTS):
        t0 = time.perf_counter()
        out = run_forward(model, batch, cluster_sem, cluster_off)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = LAUNCHES[kind]
    if LAUNCHES != launch_counts(**{kind: CONVS_PER_FORWARD * TIMED_REQUESTS}):
        raise AssertionError(
            f"subm_conv launched {LAUNCHES} in {TIMED_REQUESTS} forwards, "
            f"expected {CONVS_PER_FORWARD} {kind} launches per forward and no other"
        )
    counters = {k: int(v.sum()) for k, v in out.counters.items()}
    if any(counters.values()):
        raise AssertionError(f"capacity counters nonzero: {counters}")
    for name in ("sem_logits", "offset_preds", "score_preds", "npcs_preds"):
        t = getattr(out, name)
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} has non-finite values")
    print(f"[{tag}] counters {counters}")
    deciles = statistics.quantiles(times, n=10)
    print(f"[{tag}] ms per cloud over {TIMED_REQUESTS} requests: "
          f"median {statistics.median(times):.3f}, p10 {deciles[0]:.3f}, "
          f"p90 {deciles[-1]:.3f}, min {min(times):.3f}, max {max(times):.3f}  ({smi})")
    print(f"[{tag}] proposals {out.proposals.num_proposals.tolist()}, "
          f"subm_conv {kind} launches {launches} ({launches // TIMED_REQUESTS} per forward)")
    return model, out, launches, times


def phase_entry():
    """`entry()` as a user calls it: the flagship model at its default
    capacities on a synthetic cloud.  The kernel is first held against its
    plain version on that cloud's hierarchy; returns those rows."""
    import torch

    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.entry import entry
    from gapartnet_tpu_torch.models.gapartnet import prepare_input_grid
    from gapartnet_tpu_torch.ops.sparse_conv import build_hierarchy
    from gapartnet_tpu_torch.ops.subm_conv import LAUNCHES, reset_launches

    fn, (batch,) = entry()
    cfg = GAPartNetConfig()
    keys, _, nvox, _ = prepare_input_grid(batch.points, batch.point_mask, cfg)
    hierarchy = build_hierarchy(keys, nvox, cfg.input_capacities(), extent=cfg.input_grid_extent)
    print(f"[entry] capacities {cfg.input_capacities()}, extent {cfg.input_grid_extent}, "
          f"voxels per level {[int(lv.num_voxels[0]) for lv in hierarchy.levels]}")
    rows = phase_kernels(cfg, hierarchy, "cuda", tag="entry kernel", timed=False)
    reset_launches()
    t0 = time.perf_counter()
    outs = fn(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if LAUNCHES != launch_counts(fwd=CONVS_PER_FORWARD):
        raise AssertionError(f"entry(): subm_conv launched {LAUNCHES}")
    if not all(bool(torch.isfinite(t.float()).all()) for t in outs):
        raise AssertionError("entry(): non-finite outputs")
    print(f"[entry] entry() forward on a synthetic cloud: {ms:.1f} ms (first call), "
          f"{LAUNCHES['fwd']} subm_conv launches, "
          f"outputs {[tuple(t.shape) for t in outs]}")
    return rows


def phase_profile(run, request_ms, tag="profile", what="one forward"):
    """Device time by kernel over one `run()` (torch.profiler, CUDA activity
    only).  The idle share is taken against `request_ms`, the median wall of
    the unprofiled runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        print(f"[{tag}] device time not measured (profiler saw no kernels)")
        return
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    launches = sum(e.count for e in events)
    print(f"[{tag}] {what}: kernel time {busy_ms:.3f} ms in {launches} kernel "
          f"launches; idle share {1 - busy_ms / request_ms:.3f} of the median "
          f"unprofiled run ({request_ms:.3f} ms); profiled wall {wall_ms:.3f} ms")
    for e in events[:15]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} {e.key[:90]}")


def _check_close(name, got, want, mask=None, rtol=FORWARD_RTOL, allow=0.0):
    """max|got - want| <= rtol * max|want| + allow (over `mask`)."""
    got, want = got.cpu(), want.cpu()
    if mask is not None:
        got, want = got[mask], want[mask]
    if got.numel() == 0:
        print(f"[compare] {name}: nothing to compare")
        return
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1e-30)
    print(f"[compare] {name}: max|d| {err:.3e}, max|cpu| {scale:.3e}, n={got.numel()}"
          + (f", probe allowance {allow:.3e}" if allow else ""))
    if not err <= rtol * scale + allow:
        raise AssertionError(f"{name}: card vs CPU max|d| {err} > {rtol} * {scale} + {allow}")


def _probe_allow(name, probes, want, mask=None):
    """KINK_FACTOR times the largest move of output `name` (over `mask`)
    from the CPU output `want` in the CPU probe runs (0 without probes)."""
    moves = []
    for p in probes:
        d = (getattr(p, name).cpu() - getattr(want, name).cpu()).abs()
        d = d[mask] if mask is not None else d
        moves.append(float(d.max()) if d.numel() else 0.0)
    return KINK_FACTOR * max(moves, default=0.0)


def _check_equal(name, got, want):
    import torch

    if not torch.equal(got.cpu(), want.cpu()):
        n = int((got.cpu() != want.cpu()).sum())
        raise AssertionError(f"{name}: card and CPU differ at {n} entries")


def phase_compare(cfg, batch, cluster_sem, cluster_off, model_gpu, out_gpu, probes=()):
    """The same forward on the CPU; integers exact, floats within tolerance.
    With `probes` (seeds; the bf16 run) the CPU forward also runs once per
    seed with every BatchNorm output moved by +-1 fp32 ulp (`bn_ulp_probe`),
    and each float may differ by FORWARD_RTOL of scale plus KINK_FACTOR
    times what the probes move it: at bf16 an fp32 ulp flips a bf16
    rounding further on, and the flips grow through the layers."""
    import torch

    from gapartnet_tpu_torch.entry import make_model
    from gapartnet_tpu_torch.models.gapartnet import prepare_input_grid
    from gapartnet_tpu_torch.ops.sparse_conv import build_hierarchy

    model_cpu = make_model(cfg, "cpu", seed=0)
    for (k, a), b in zip(model_gpu.state_dict().items(), model_cpu.state_dict().values()):
        _check_equal(f"weight {k}", a, b)
    bc, sc, oc = batch.to("cpu"), cluster_sem.cpu(), cluster_off.cpu()
    t0 = time.perf_counter()
    out_cpu = run_forward(model_cpu, bc, sc, oc)
    print(f"[compare] CPU forward {time.perf_counter() - t0:.1f} s")
    outs_p = []
    for seed in probes:
        with bn_ulp_probe(seed):
            outs_p.append(run_forward(model_cpu, bc, sc, oc))
    if probes:
        print(f"[compare] {len(probes)} CPU probe forwards (BatchNorm outputs +-1 ulp) done")

    grids = []
    for b in (batch, bc):
        keys, _, nvox, pcid = prepare_input_grid(b.points, b.point_mask, cfg)
        hier = build_hierarchy(keys, nvox, cfg.input_capacities(), extent=cfg.input_grid_extent)
        grids.append((keys, nvox, pcid, hier))
    (kg, ng, pg, hg), (kc, nc, pc, hc) = grids
    _check_equal("voxel keys", kg, kc)
    _check_equal("num voxels", ng, nc)
    _check_equal("pc_voxel_id", pg, pc)
    for li, (lg, lc) in enumerate(zip(hg.levels, hc.levels)):
        for f in lg._fields:
            _check_equal(f"level {li} {f}", getattr(lg, f), getattr(lc, f))
    for li, (dg, dc) in enumerate(zip(hg.downsamples, hc.downsamples)):
        for f in dg._fields:
            _check_equal(f"downsample {li} {f}", getattr(dg, f), getattr(dc, f))
    for f in out_gpu.proposals._fields:
        _check_equal(f"proposals.{f}", getattr(out_gpu.proposals, f), getattr(out_cpu.proposals, f))
    print("[compare] voxel keys, pc_voxel_id, rulebooks, downsample maps, proposals: identical")

    # dense entry cells: a flip moves an entry by one cell within its grid
    s = int(cfg.score_fullscale)
    s3 = s ** 3
    sg, scp = out_gpu.entry_site.cpu(), out_cpu.entry_site.cpu()
    diff = sg != scp
    n_valid = int((scp >= 0).sum())
    n_diff = int(diff.sum())
    print(f"[compare] dense entry cells differing: {n_diff} of {n_valid}")
    if n_diff > CELL_FLIP_SHARE * n_valid:
        raise AssertionError(f"{n_diff} dense entry cells differ (> {CELL_FLIP_SHARE:.1%})")
    if n_diff:
        a, b = sg[diff], scp[diff]
        if not bool(((a >= 0) & (b >= 0) & (a // s3 == b // s3)).all()):
            raise AssertionError("a differing dense entry changed grid or validity")
        ca = torch.stack([(a % s3) // (s * s), (a % (s * s)) // s, a % s], -1)
        cb = torch.stack([(b % s3) // (s * s), (b % (s * s)) // s, b % s], -1)
        if int((ca - cb).abs().max()) > 1:
            raise AssertionError("a differing dense entry moved by more than one cell")
    # proposals whose grid holds a moved cell are left out of the float
    # comparison of their score and NPCS (their conv inputs differ)
    pid = out_cpu.proposals.entry_proposal.cpu()
    prop_ok = out_cpu.proposals.proposal_mask.cpu().clone()
    bb, ee = diff.nonzero(as_tuple=True)
    prop_ok[bb, pid[bb, ee].long()] = False

    sem_allow = _probe_allow("sem_logits", outs_p, out_cpu)
    _check_close("sem_logits", out_gpu.sem_logits, out_cpu.sem_logits, allow=sem_allow)
    _check_close("offset_preds", out_gpu.offset_preds, out_cpu.offset_preds,
                 allow=_probe_allow("offset_preds", outs_p, out_cpu))
    # argmax may flip only at near-ties of the two largest logits
    lc = out_cpu.sem_logits.cpu()
    flip = out_gpu.sem_preds.cpu() != out_cpu.sem_preds.cpu()
    print(f"[compare] sem_preds differing: {int(flip.sum())} of {flip.numel()}")
    if flip.any():
        top2 = lc[flip].topk(2, dim=-1).values
        tol = FORWARD_RTOL * float(lc.abs().max()) + sem_allow
        if not bool(((top2[:, 0] - top2[:, 1]) <= 2 * tol).all()):
            raise AssertionError("sem_preds differ at a point that is not a near-tie")
    # a proposal's class is the sem pred at its representative point
    sem_agree = out_gpu.proposal_sem.cpu() == out_cpu.proposal_sem.cpu()
    n_sem = int((~sem_agree & prop_ok).sum())
    print(f"[compare] proposal classes differing: {n_sem}")
    if n_sem > int(flip.sum()):
        raise AssertionError("proposal classes differ beyond the sem_preds near-ties")
    prop_ok &= sem_agree
    # a probe's own near-tie flips pick other classes: those proposals and
    # entries are left out of the comparison and of the probes' allowance
    for p in outs_p:
        prop_ok &= p.proposal_sem.cpu() == out_cpu.proposal_sem.cpu()
    _check_close("score_logits", out_gpu.score_logits, out_cpu.score_logits, prop_ok,
                 allow=_probe_allow("score_logits", outs_p, out_cpu, prop_ok))
    _check_close("score_preds", out_gpu.score_preds, out_cpu.score_preds, prop_ok,
                 allow=_probe_allow("score_preds", outs_p, out_cpu, prop_ok))
    ep = out_cpu.proposals.entry_point.cpu().long()
    bidx = torch.arange(ep.shape[0])[:, None]
    entry_ok = out_cpu.proposals.entry_mask.cpu() & ~flip[bidx, ep]
    entry_ok &= prop_ok[bidx, pid.clamp(min=0).long()]
    for p in outs_p:
        entry_ok &= (p.sem_preds.cpu() == out_cpu.sem_preds.cpu())[bidx, ep]
    if outs_p:
        print(f"[compare] left out for the probes' own sem_preds flips: "
              f"{int((out_cpu.proposals.proposal_mask.cpu() & ~prop_ok).sum())} proposals, "
              f"{int((out_cpu.proposals.entry_mask.cpu() & ~entry_ok).sum())} entries (with the "
              f"card's)")
    _check_close("npcs_preds", out_gpu.npcs_preds, out_cpu.npcs_preds, entry_ok,
                 allow=_probe_allow("npcs_preds", outs_p, out_cpu, entry_ok))


def _bound(flops, nbytes, peak_flops=PEAK_TF32X3_FLOPS):
    """(ms, what bounds it): the larger of the operations at `peak_flops`
    and the bytes at the HBM rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _weighted(rows, key, weight):
    """sum of row[key] * row[weight], or None if any time is missing."""
    if any(r[key] is None for r in rows if r[weight]):
        return None
    return sum(r[key] * r[weight] for r in rows if r[weight])


def train_conv_shapes(cfg, hierarchy, prop_hier):
    """Every distinct (V, Cin, Cout) of one train step with its neighbour
    table and its launches per step: the backbone's convs, and the convs of
    the two proposal UNets (channels[:2], no stem conv) on the proposal
    grid.  The backbone stem's input needs no gradient, so it has no dgrad.
    `hierarchy` None: a PointNet backbone, no backbone convs."""
    out = []
    for li, cin, cout, per in (backbone_conv_shapes(cfg.channels, cfg.in_channels)
                               if hierarchy is not None else ()):
        dgrad = 0 if (li == 0 and cin == cfg.in_channels) else per
        out.append(dict(net="backbone", level=li, cin=cin, cout=cout,
                        nbr=hierarchy.levels[li].subm_nbr,
                        per_step={"fwd": per, "dgrad": dgrad, "wgrad": per}))
    for li, cin, cout, per in backbone_conv_shapes(cfg.channels[:2], stem_in=None):
        out.append(dict(net="proposal", level=li, cin=cin, cout=cout,
                        nbr=prop_hier.levels[li].subm_nbr,
                        per_step={"fwd": 2 * per, "dgrad": 2 * per, "wgrad": 2 * per}))
    return out


def phase_train_kernels(shapes, tag="train kernel", timed=True):
    """Forward, dgrad and wgrad kernels against their plain versions at
    every training shape; the wgrad twice, bitwise; when `timed`,
    CUDA-event medians of all six.  Returns the rows."""
    import torch

    from gapartnet_tpu_torch.ops import subm_conv as sc

    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows = []
    for sh in shapes:
        nbr, cin, cout = sh["nbr"], sh["cin"], sh["cout"]
        b, _, v = nbr.shape
        x = torch.randn((b, v, cin), generator=gen, device="cuda")
        w = torch.randn((27, cin, cout), generator=gen, device="cuda") / (27 * cin) ** 0.5
        g = torch.randn((b, v, cout), generator=gen, device="cuda")
        calls = {
            "fwd": (lambda: sc.subm_conv_forward(x, nbr, w),
                    lambda: sc.subm_conv_reference(x, nbr, w), KERNEL_RTOL),
            "dgrad": (lambda: sc.subm_conv_dgrad(g, nbr, w),
                      lambda: sc.subm_conv_dgrad_reference(g, nbr, w), KERNEL_RTOL),
            "wgrad": (lambda: sc.subm_conv_wgrad(x, nbr, g),
                      lambda: sc.subm_conv_wgrad_reference(x, nbr, g), WGRAD_RTOL),
        }
        pairs = int((nbr >= 0).sum())
        flops = 2 * cin * cout * pairs
        nbytes = 4 * (b * v * cin + 27 * b * v + 27 * cin * cout + b * v * cout)
        bound_ms, bound_by = _bound(flops, nbytes)
        row = dict(net=sh["net"], level=sh["level"], cin=cin, cout=cout, B=b, V=v, pairs=pairs,
                   per_step=sh["per_step"], flops=flops, bytes=nbytes, bound_ms=bound_ms,
                   bound_by=bound_by, bound_fp32_ms=_bound(flops, nbytes, PEAK_FP32_FLOPS)[0])
        for kind, (kernel, plain, rtol) in calls.items():
            got = kernel()
            ref = plain()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            if not err <= rtol * scale:
                raise AssertionError(
                    f"{kind} disagrees at {sh['net']} level {sh['level']} ({cin}->{cout}, "
                    f"V={v}): max|d| {err} > {rtol} * max|ref| {scale}")
            if kind == "wgrad" and not torch.equal(got, kernel()):
                raise AssertionError(f"wgrad not bitwise repeatable at {cin}->{cout}, V={v}")
            row[kind] = dict(max_abs_err=err, max_ref=scale)
            if timed:
                row[kind].update(ms=cuda_ms(kernel, TIMED_LAUNCHES),
                                 device_ms=device_ms(kernel, TIMED_LAUNCHES, KERNEL_NAMES[kind]),
                                 plain_ms=cuda_ms(plain, TIMED_LAUNCHES))
        rows.append(row)
        if not timed:
            print(f"[{tag}] {sh['net']:<8} level {sh['level']} {cin:>3}->{cout:<3} B={b} V={v:<6} "
                  f"pairs={pairs:<8} " + "  ".join(
                      f"{k} max|d| {row[k]['max_abs_err']:.1e} (max|ref| {row[k]['max_ref']:.1e})"
                      for k in ("fwd", "dgrad", "wgrad")))
            continue
        print(f"[{tag}] {sh['net']:<8} level {sh['level']} {cin:>3}->{cout:<3} B={b} V={v:<6} "
              f"pairs={pairs:<8} bound {bound_ms:.4f} ms ({bound_by})  " + "  ".join(
                  f"{k} x{sh['per_step'][k]} {row[k]['ms']:.4f}/{_fmt(row[k]['device_ms'])}/"
                  f"{row[k]['plain_ms']:.4f} ms d {row[k]['max_abs_err']:.1e}/{row[k]['max_ref']:.1e}"
                  for k in ("fwd", "dgrad", "wgrad")) + "  (call/device/plain)")
    return rows


def _train_model(cfg):
    from gapartnet_tpu_torch.entry import make_model

    return make_model(cfg, "cuda", seed=0).train()


def proposal_geometry(cfg, batch, cluster_sem, cluster_off):
    """The proposal grid of one train forward (a throwaway model, the first
    jitter draw of seed 0): the hierarchy the proposal UNets convolve."""
    import torch

    model = _train_model(cfg)
    with torch.no_grad():
        out = model(batch, do_cluster=True, do_score=True, do_npcs=True,
                    cluster_sem_override=cluster_sem, cluster_offset_override=cluster_off,
                    jitter=torch.rand((2, 3), generator=torch.Generator().manual_seed(0)))
    hier = out.proposal_grid
    print(f"[train setup] live proposals {out.proposals.num_proposals.tolist()}, proposal voxels "
          f"{hier.levels[0].num_voxels.tolist()} (capacities {cfg.proposal_capacities()})")
    return hier


def phase_train(cfg, batch, cluster_sem, cluster_off, smi, per_step=LAUNCHES_PER_STEP,
                tag="train", warmups=WARMUP_STEPS, steps=TIMED_STEPS):
    """train_step on the card: `warmups` steps, then `steps` timed steps
    with the launch counts read around them (`per_step` launches of each
    kind per step).  Returns (step function, launches, ms per step)."""
    import torch

    from gapartnet_tpu_torch.ops.subm_conv import LAUNCHES, reset_launches
    from gapartnet_tpu_torch.train.loop import adam, train_step

    model = _train_model(cfg)
    opt = adam(model.named_parameters(), 1e-3)
    gen = torch.Generator().manual_seed(0)
    stats0 = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}

    def step():
        return train_step(model, opt, batch, gen, True, True, True,
                          cluster_sem_override=cluster_sem, cluster_offset_override=cluster_off)

    history = [step() for _ in range(warmups)]
    torch.cuda.synchronize()
    reset_launches()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        history.append(step())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(LAUNCHES)
    want = {k: n * steps for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"train steps launched {launches}, expected {want}")
    for i, m in enumerate(history):
        bad = [k for k, v in m.items() if not bool(torch.isfinite(v))]
        if bad:
            raise AssertionError(f"step {i + 1}: non-finite {bad}")
        nonzero = {k: float(v) for k, v in m.items() if k.startswith("counters/") and float(v) != 0}
        if nonzero:
            raise AssertionError(f"step {i + 1}: capacity counters nonzero: {nonzero}")
    first, last = float(history[0]["loss/total_loss"]), float(history[-1]["loss/total_loss"])
    if first == last:
        raise AssertionError(f"the loss did not move over {len(history)} steps ({first})")
    moved = sum(not torch.equal(v, model.state_dict()[k]) for k, v in stats0.items())
    if moved != len(stats0):
        raise AssertionError(f"only {moved} of {len(stats0)} BN running statistics moved")
    deciles = statistics.quantiles(times, n=10)
    med = statistics.median(times)
    print(f"[{tag}] B={batch.batch_size} ms per step over {steps} steps: median {med:.3f}, "
          f"p10 {deciles[0]:.3f}, p90 {deciles[-1]:.3f}, min {min(times):.3f}, "
          f"max {max(times):.3f}; {batch.batch_size / med * 1e3:.2f} clouds/s  ({smi})")
    print(f"[{tag}] launches in {steps} steps {launches} "
          f"(per step {dict((k, v // steps) for k, v in launches.items())}); "
          f"all counters 0; {moved} BN running statistics moved")
    print(f"[{tag}] step 1: " + ", ".join(f"{k} {float(v):.4f}" for k, v in history[0].items()
                                          if not k.startswith("counters/")))
    print(f"[{tag}] step {len(history)}: " + ", ".join(
        f"{k} {float(v):.4f}" for k, v in history[-1].items() if not k.startswith("counters/")))
    return step, launches, times


def _clouds(batch, lo, hi):
    """Clouds lo..hi-1 of a batch."""
    import torch

    return type(batch)(**{
        f.name: (getattr(batch, f.name)[lo:hi]
                 if isinstance(getattr(batch, f.name), (torch.Tensor, list))
                 else getattr(batch, f.name))
        for f in dataclasses.fields(batch)
    })


def _train_pass(cfg, sub, dev, cluster_sem, cluster_off, jitter, probe=None):
    """One train forward + backward of a fresh seed-0 model on `sub`, on
    `dev`.  `probe` = (seed, sign) first moves every parameter p to
    p * (1 + sign * PERTURB * N(0, 1)), the noise drawn on the CPU from
    `seed`.  Returns (model, output, batch on `dev`)."""
    import torch

    from gapartnet_tpu_torch.entry import make_model

    b = sub.to(dev)
    model = make_model(cfg, dev, seed=0).train()
    if probe is not None:
        seed, sign = probe
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + sign * PERTURB * torch.randn(p.shape, generator=gen).to(dev))
    out = model(b, do_cluster=True, do_score=True, do_npcs=True,
                cluster_sem_override=cluster_sem.to(dev),
                cluster_offset_override=cluster_off.to(dev), jitter=jitter)
    out.total_loss.backward()
    return model, out, b


@contextlib.contextmanager
def deterministic_ops():
    """PyTorch's deterministic implementations inside the block: its
    scatter-adds (index_add_, the backward of gathers) sum in a fixed order
    instead of atomics.  It raises where an op has none.  cuBLAS needs
    CUBLAS_WORKSPACE_CONFIG before the process's first cuBLAS call, which
    main sets."""
    import torch

    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in (CUBLAS_WORKSPACE, ":16:8"):
        raise RuntimeError(f"deterministic_ops needs CUBLAS_WORKSPACE_CONFIG={CUBLAS_WORKSPACE} "
                           "(or :16:8) set before torch starts")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def _check_same_graph(name, og, oc, fields=("entry_voxel_id", "sem_preds", "proposal_sem",
                                            "npcs_valid", "ious")):
    """The integer outputs of two train passes that decide what the loss
    sums: proposal grid, proposals, the given fields, counters."""
    a, b = og.proposal_grid, oc.proposal_grid
    for li, (lg, lc) in enumerate(zip(a.levels, b.levels)):
        for f in lg._fields:
            _check_equal(f"{name}: proposal grid level {li} {f}", getattr(lg, f), getattr(lc, f))
    for li, (dg, dc) in enumerate(zip(a.downsamples, b.downsamples)):
        for f in dg._fields:
            _check_equal(f"{name}: proposal grid downsample {li} {f}", getattr(dg, f),
                         getattr(dc, f))
    for f in og.proposals._fields:
        _check_equal(f"{name}: proposals.{f}", getattr(og.proposals, f), getattr(oc.proposals, f))
    for f in fields:
        _check_equal(f"{name}: {f}", getattr(og, f), getattr(oc, f))
    for k, v in oc.counters.items():
        _check_equal(f"{name}: counter {k}", og.counters[k], v)


def phase_train_compare(cfg, batch, cluster_sem, cluster_off, n=2, runs=CARD_RUNS, tag="train compare",
                        deterministic=None):
    """One train forward + backward on n clouds: `runs` times on the card,
    once on the CPU with the same weights, jitter and inputs, and once on
    the CPU per probe of PROBES.  Returns the worst gradient deviation
    over the card runs (max|d| / scale) and the worst running-statistics
    deviation (max|d| / max|cpu|).

    At bf16 conv compute (phase 11) a rounding difference flips bf16
    roundings further on, and training's batch statistics carry the flips
    through the layers, so the losses and running statistics also get
    KINK_FACTOR times the probes' move, a gradient BF16_KINK_FACTOR times
    the probes' move and one bf16 ulp of its scale (a rounding of dW that
    flips between card and CPU), and sem_preds (with npcs_valid) may flip
    at near-ties of the CPU's logits, as they may in the probes.  A
    PointNet step (phase 12b) is as rounding-sensitive without bf16: its
    transformers' fc BatchNorms take E[x^2] - mean^2 over the B rows,
    which cancels most digits; it gets the same terms but the bf16 ulp.

    Such a step's card runs take PyTorch's deterministic implementations
    (deterministic_ops; `deterministic` overrides), and more than one such
    run must be bitwise equal.  With atomic scatter-adds each card run is
    another draw of the card's rounding, and now and then one crosses a
    kink that none of the four probes crosses (--compare-draws counts
    them): one bf16 draw moved npcs_unet.ublock.dec0.shortcut_kernel's
    gradient by 18% of its scale, 1.15 times its allowance, where the
    probes move it by 2-4% (on an H100 80GB HBM3 at 700 W)."""
    import torch

    from gapartnet_tpu_torch.models.gapartnet import prepare_input_grid
    from gapartnet_tpu_torch.ops.sparse_conv import build_hierarchy

    jitter = torch.rand((2, 3), generator=torch.Generator().manual_seed(7))
    sub, sem, off = _clouds(batch, 0, n), cluster_sem[:n], cluster_off[:n]

    def run(dev, what, probe=None):
        t0 = time.perf_counter()
        res = _train_pass(cfg, sub, dev, sem, off, jitter, probe)
        if dev == "cuda":
            torch.cuda.synchronize()
        print(f"[{tag}] {what} at B={n}: {time.perf_counter() - t0:.2f} s")
        return res

    bf16 = cfg.conv_compute_dtype == "bfloat16"
    # rounding-sensitive steps: a bf16 network, or PointNet, whose
    # transformers' fc BatchNorms take E[x^2] - mean^2 over the B rows
    sensitive = bf16 or cfg.backbone_type == "PointNet"
    det = sensitive if deterministic is None else deterministic
    mc, oc, bc = run("cpu", "cpu step")
    with deterministic_ops() if det else contextlib.nullcontext():
        cards = [run("cuda", f"card step {r + 1}" + (" (deterministic scatter-adds)" if det else ""))
                 for r in range(runs)]
    if det and runs > 1:
        first = {**cards[0][0].state_dict(),
                 **{"grad " + k: p.grad for k, p in cards[0][0].named_parameters()}}
        for r, (mg, _, _) in enumerate(cards[1:], 2):
            now = {**mg.state_dict(), **{"grad " + k: p.grad for k, p in mg.named_parameters()}}
            for k, v in first.items():
                _check_equal(f"deterministic card step {r}: {k}", now[k], v)
        print(f"[{tag}] {runs} deterministic card steps: every gradient and running "
              "statistic bitwise equal")
    probes = [run("cpu", f"cpu step, parameters moved by {sign * PERTURB:+g} (noise seed {seed})",
                  (seed, sign)) for seed, sign in PROBES]

    grids = []
    for b in (cards[0][2], bc):
        keys, _, nvox, pcid = prepare_input_grid(b.points, b.point_mask, cfg)
        hier = build_hierarchy(keys, nvox, cfg.input_capacities(), extent=cfg.input_grid_extent)
        grids.append((keys, nvox, pcid, hier))
    (kg, ng, pg, hg), (kc, nc, pc, hc) = grids
    _check_equal("voxel keys", kg, kc)
    _check_equal("num voxels", ng, nc)
    _check_equal("pc_voxel_id", pg, pc)
    for li, (lg, lc) in enumerate(zip(hg.levels, hc.levels)):
        for f in lg._fields:
            _check_equal(f"backbone level {li} {f}", getattr(lg, f), getattr(lc, f))
    for li, (dg, dc) in enumerate(zip(hg.downsamples, hc.downsamples)):
        for f in dg._fields:
            _check_equal(f"backbone downsample {li} {f}", getattr(dg, f), getattr(dc, f))
    reduced = ("entry_voxel_id", "proposal_sem", "ious")
    lc = oc.sem_logits.detach().cpu()
    sem_tol = LOSS_RTOL * float(lc.abs().max()) + max(
        float((op.sem_logits.detach().cpu() - lc).abs().max()) for _, op, _ in probes)
    for r, (_, og, _) in enumerate(cards):
        _check_same_graph(f"card step {r + 1}", og, oc, fields=reduced if sensitive else (
            "entry_voxel_id", "sem_preds", "proposal_sem", "npcs_valid", "ious"))
        if sensitive:
            _near_ties(f"card step {r + 1}", og.sem_preds.cpu(), lc, sem_tol)
    print(f"[{tag}] voxel keys, rulebooks, downsample maps; in all {runs} card steps: "
          "proposals, proposal-grid keys and rulebooks, entry_voxel_id, proposal classes, ious"
          + (" identical to the CPU's; sem_preds equal outside near-ties" if sensitive else
             ", sem_preds, npcs_valid: identical to the CPU's"))
    # a probe may flip an argmax near-tie of sem_preds (and with it
    # npcs_valid); the proposals and grids it must not change
    for i, (_, op, _) in enumerate(probes):
        _check_same_graph(f"probe {i + 1}", op, oc, fields=("entry_voxel_id", "proposal_sem", "ious"))
        flips = int((op.sem_preds != oc.sem_preds).sum())
        print(f"[{tag}] probe {i + 1}: proposals and grids as the CPU step's; "
              f"sem_preds differing at {flips} points")

    for k in oc.LOSSES:
        b = float(getattr(oc, k).detach())
        got = [float(getattr(og, k).detach()) for _, og, _ in cards]
        worst_loss = max(abs(a - b) for a in got)
        allow = LOSS_RTOL * max(abs(b), 1.0) + (KINK_FACTOR * max(
            abs(float(getattr(op, k).detach()) - b) for _, op, _ in probes) if sensitive else 0.0)
        print(f"[{tag}] {k}: cpu {b:.7f}, card {', '.join(f'{a:.7f}' for a in got)}, "
              f"max|d| {worst_loss:.2e} (allowed {allow:.2e})")
        if not worst_loss <= allow:
            raise AssertionError(f"{k}: card {got} vs CPU {b}")

    grads_c = {k: p.grad for k, p in mc.named_parameters()}
    top = max(float(g.abs().max()) for g in grads_c.values())
    scale = {k: max(float(g.abs().max()), GRAD_FLOOR * top) for k, g in grads_c.items()}
    grads_p = [{k: p.grad for k, p in mp.named_parameters()} for mp, _, _ in probes]
    own = {k: max(float((gp[k] - g).abs().max()) for gp in grads_p) for k, g in grads_c.items()}
    steady = [k for k in grads_c if own[k] <= GRAD_RTOL * scale[k]]
    print(f"[{tag}] {len(grads_c)} parameter gradients; the probes move "
          f"{len(grads_c) - len(steady)} of them by more than {GRAD_RTOL} of their scale, the "
          "five most (max over probes / scale): " + "; ".join(
              f"{k} {own[k] / scale[k]:.2e}"
              for k in sorted(grads_c, key=lambda k: own[k] / scale[k], reverse=True)[:5]))
    failures, worst = [], 0.0
    for r, (mg, _, _) in enumerate(cards):
        ratio, worst_steady = {}, (0.0, "")
        for k, p in mg.named_parameters():
            err = float((p.grad.cpu() - grads_c[k]).abs().max())
            kink = BF16_KINK_FACTOR if sensitive else KINK_FACTOR
            ulp = BF16_ULP * scale[k] if bf16 else 0.0
            allowed = GRAD_RTOL * scale[k] + kink * own[k] + ulp
            ratio[k] = err / allowed
            worst = max(worst, err / scale[k])
            if k in steady:
                worst_steady = max(worst_steady, (err / scale[k], k))
            if err > allowed:
                failures.append(f"card step {r + 1}, grad {k}: max|d| {err} > {GRAD_RTOL} * "
                                f"{scale[k]} + {kink} * {own[k]} + {ulp}")
        k = max(ratio, key=ratio.get)
        print(f"[{tag}] card step {r + 1}: worst max|d| / allowed {ratio[k]:.3f} ({k}); "
              f"among the {len(steady)} tensors the probes leave within {GRAD_RTOL}: worst "
              f"max|d| / scale {worst_steady[0]:.3e} ({worst_steady[1]})")
    if failures:
        raise AssertionError("card vs CPU gradients:\n" + "\n".join(failures))

    sc_ = mc.state_dict()
    sp_ = [mp.state_dict() for mp, _, _ in probes]
    worst_stats = (0.0, "")
    for r, (mg, _, _) in enumerate(cards):
        sg_ = mg.state_dict()
        for k in sc_:
            if "running_" not in k:
                continue
            err = float((sg_[k].cpu() - sc_[k]).abs().max())
            scale_k = float(sc_[k].abs().max())
            own_k = max(float((sp[k] - sc_[k]).abs().max()) for sp in sp_) if sensitive else 0.0
            if not err <= STATS_RTOL * scale_k + KINK_FACTOR * own_k:
                raise AssertionError(f"card step {r + 1}, {k}: card vs CPU max|d| {err} > "
                                     f"{STATS_RTOL} * {scale_k} + {KINK_FACTOR} * {own_k}")
            worst_stats = max(worst_stats, (err / scale_k, k))
    print(f"[{tag}] running statistics: worst max|d| / max|cpu| {worst_stats[0]:.3e} "
          f"({worst_stats[1]}), tolerance {STATS_RTOL}")
    return worst, worst_stats[0]


def phase_compare_draws(draws, smi):
    """Phase 11c's bf16 card-vs-CPU train step as a distribution: `draws`
    card steps with PyTorch's atomic scatter-adds, each held to the CPU
    step's allowances, then `draws` deterministic ones, which must pass
    and be bitwise equal.  Prints how many atomic draws went over."""
    import torch

    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.entry import train_setup

    tcfg, tbatch, tsem, toff = train_setup(GAPartNetConfig(conv_compute_dtype="bfloat16"),
                                           batch_size=TRAIN_BATCH, device="cuda")
    over = set()
    try:
        phase_train_compare(tcfg, tbatch, tsem, toff, runs=draws, tag="bf16 draws, atomic",
                            deterministic=False)
    except AssertionError as e:
        over = set(re.findall(r"card step (\d+), grad", str(e)))
        if not over:
            raise
    print(f"[bf16 draws, atomic] {len(over)} of {draws} card steps over their allowance "
          f"({smi})")
    torch.cuda.empty_cache()
    phase_train_compare(tcfg, tbatch, tsem, toff, runs=draws, tag="bf16 draws, deterministic",
                        deterministic=True)


def phase_visu_draws(draws, smi):
    """Phase 14c's card-vs-CPU visu request as a distribution: phase 9's fit
    for a trained `last`, then the bench cloud turned about z by 2 pi i /
    `draws`, i < `draws`, through GAPartNetInference(ckpt_path=last) at the
    default capacities (as visu builds it) on the card and on the CPU, each
    held to compare_requests.  Prints how many needed the clustering
    replay."""
    import tempfile

    import numpy as np

    from gapartnet_tpu_torch.infer import api

    base, _ = bench_points()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_draws_") as tmp:
        last = Path(tmp) / "fit_last"
        phase_fit(smi, keep_last=last)
        card = api.GAPartNetInference(ckpt_path=str(last), device="cuda")
        cpu = api.GAPartNetInference(ckpt_path=str(last), device="cpu")
    how = []
    for i in range(draws):
        a = 2 * np.pi * i / draws
        rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                       np.float32)
        pts = base.copy()
        pts[:, :3] = base[:, :3] @ rot.T
        how.append(compare_requests(f"visu draw {i}", card._request(pts), cpu, pts))
    print(f"[visu draws] {draws} rotated bench clouds pass card vs CPU: "
          + ", ".join(f"{how.count(h)} {h}" for h in ("exact", "near-ties", "replay"))
          + f"  ({smi})")


def inference_pair(cfg):
    """GAPartNetInference on the card and on the CPU with the same seed-0
    weights (checked equal) and auto_capacity, as a user would build it."""
    from gapartnet_tpu_torch.infer.api import GAPartNetInference

    card = GAPartNetInference(cfg, seed=0, auto_capacity=True, device="cuda")
    cpu = GAPartNetInference(cfg, seed=0, auto_capacity=True, device="cpu")
    for (k, a), b in zip(card.model.state_dict().items(), cpu.model.state_dict().values()):
        _check_equal(f"weight {k}", a, b)
    return card, cpu


def phase_api_kernels(tag, infer, pts):
    """The kernel against its plain version at every backbone shape of the
    hierarchy that a request of `infer` builds for `pts` (its fitted
    capacities and extent, built as the forward builds it).  Returns the
    largest max|d|."""
    from gapartnet_tpu_torch.models.gapartnet import prepare_input_grid
    from gapartnet_tpu_torch.ops.sparse_conv import build_hierarchy

    cfg = infer.cfg
    batch = infer._wrap_points(pts)
    keys, _, nvox, _ = prepare_input_grid(batch.points, batch.point_mask, cfg)
    hierarchy = build_hierarchy(keys, nvox, cfg.input_capacities(), extent=cfg.input_grid_extent)
    print(f"[{tag} kernel] capacities {cfg.input_capacities()}, extent {cfg.input_grid_extent}, "
          f"voxels per level {[int(lv.num_voxels[0]) for lv in hierarchy.levels]}")
    rows = phase_kernels(cfg, hierarchy, "cuda", tag=f"{tag} kernel", timed=False)
    return max(r["max_abs_err"] for r in rows)


def bench_points():
    """(points (N, 6), instance labels) of assets/bench_cloud.npz."""
    import numpy as np

    from gapartnet_tpu_torch.entry import BENCH_CLOUD

    d = np.load(BENCH_CLOUD)
    return np.concatenate([d["xyz"], d["rgb"]], axis=1).astype(np.float32), d["instance_labels"]


def timed_request(infer, pts, proposals=None):
    """One request through GAPartNetInference's stages on the card (the
    stages of predict; with `proposals`, of predict_with_masks), a CUDA event
    after each.  Returns (Request, {stage: ms between events})."""
    import torch

    events = {}

    def mark(stage):
        events[stage] = torch.cuda.Event(enable_timing=True)
        events[stage].record()

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    req = infer._request(pts, proposals, mark=mark)
    torch.cuda.synchronize()
    split, prev = {}, start
    for stage in STAGES:
        split[stage] = prev.elapsed_time(events[stage])
        prev = events[stage]
    return req, split


def busy_ms(fn):
    """(kernel time in ms, kernel launches) of one `fn()` on the card
    (torch.profiler, CUDA activity); (None, 0) if it saw no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in events)
    return (us / 1e3 if us > 0 else None), sum(e.count for e in events)


def _quantiles(times):
    deciles = statistics.quantiles(times, n=10)
    return dict(median=statistics.median(times), p10=deciles[0], p90=deciles[-1])


def run_requests(tag, call, requests, warmups, smi):
    """`call()` warmups times, then `requests` timed calls (host clock,
    ending in a synchronize) with the subm-conv counts set to 0 just before
    and read just after; checks 53 forward launches per request.  Returns
    (ms per request, launches)."""
    import torch

    from gapartnet_tpu_torch.ops.subm_conv import LAUNCHES, reset_launches

    for _ in range(warmups):
        call()
    torch.cuda.synchronize()
    reset_launches()
    times = []
    for _ in range(requests):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(LAUNCHES)
    if launches != launch_counts(fwd=CONVS_PER_FORWARD * requests):
        raise AssertionError(f"{tag}: subm_conv launched {launches} in {requests} requests, "
                             f"expected {CONVS_PER_FORWARD} forward launches per request")
    q = _quantiles(times)
    print(f"[{tag}] ms per request over {requests} requests ({warmups} warm-ups): median "
          f"{q['median']:.3f}, p10 {q['p10']:.3f}, p90 {q['p90']:.3f}, min {min(times):.3f}, "
          f"max {max(times):.3f}; subm_conv launches {launches['fwd']} "
          f"({launches['fwd'] // requests} per request)  ({smi})")
    return times, launches["fwd"]


def report_split(tag, infer, pts, proposals=None, requests=PREDICT_REQUESTS):
    """The stage split over `requests` requests, and the device time of
    the selection and RANSAC stages alone (profiler).  Returns (the last
    Request, {stage: median ms}, {stage: device ms})."""
    splits, req = [], None
    for _ in range(requests):
        req, split = timed_request(infer, pts, proposals)
        splits.append(split)
    med = {s: statistics.median(sp[s] for sp in splits) for s in STAGES}
    device = {}
    if proposals is None:
        device["select"] = busy_ms(lambda: infer._select(req.out))
    if req.jobs is not None:
        device["ransac"] = busy_ms(lambda: infer._fit(req.jobs, 100, 0))
    counters = {k: int(v.sum()) for k, v in req.out.counters.items()}
    print(f"[{tag}] split, median over {requests} requests (CUDA events; ms): " + ", ".join(
        f"{s} {med[s]:.3f}" for s in STAGES) + f"; total {sum(med.values()):.3f}")
    print(f"[{tag}] device time alone (profiler): " + ", ".join(
        f"{s} {_fmt(ms)} ms in {n} kernels" for s, (ms, n) in device.items()))
    jobs = "none" if req.jobs is None else f"{req.jobs.mask.shape[0]} (width {req.jobs.mask.shape[1]})"
    print(f"[{tag}] proposals {int(req.out.proposals.num_proposals[0])}, kept {int(req.keep.sum())}, "
          f"box jobs {jobs}, ok boxes {int(req.ok.sum())}, part points "
          f"{int((req.result.ins_preds > 0).sum())}; counters {counters}")
    return req, med, {s: v[0] for s, v in device.items()}


def _near_ties(name, got, want_logits, tol=None):
    """sem_preds may differ only where the CPU's two largest logits are
    within the forward's tolerance (or `tol`) of each other."""
    want = want_logits.argmax(dim=-1)
    flip = got != want
    if flip.any():
        top2 = want_logits[flip].topk(2, dim=-1).values
        tol = FORWARD_RTOL * float(want_logits.abs().max()) if tol is None else tol
        if not bool(((top2[:, 0] - top2[:, 1]) <= 2 * tol).all()):
            raise AssertionError(f"{name}: sem_preds differ at a point that is not a near-tie")
    return int(flip.sum())


def _cpu_post(cpu, pts, out, keep_given):
    """The stages after the forward on the CPU, from given forward outputs
    (the card's, copied to the CPU)."""
    keep = cpu._select(out) if keep_given is None else keep_given
    result, jobs = cpu._scatter(pts, out, keep, 10)
    fits = cpu._fit(jobs, 100, 0) if jobs is not None else None
    return keep, result, jobs, fits


def _cluster_replay(tag, got, cpu, pts, want, differ):
    """sem_preds agree, yet the clustering's integers differ (`differ`).  The
    hash clustering cuts the shifted set xyz + offset_preds into cells of
    side radius / sqrt(3) and joins nodes by a radius test, so an offset
    within the forward's tolerance of a cell face or of the radius moves a
    point; where the node table overflows (the default capacity on a whole
    cloud) one node more or less changes the overflow count and which nodes
    are kept.  The card's offsets must lie within FORWARD_RTOL of the CPU's;
    at most CELL_FLIP_SHARE of the valid shifted points may change cell, and
    at least one where the node overflow differs; and a CPU forward that
    clusters the card's sem_preds and offsets (its heads its own) must give
    the card's counters and proposals exactly.  Returns that CPU forward."""
    import numpy as np
    import torch

    from gapartnet_tpu_torch.ops.voxelize import div_const

    print(f"[{tag} compare] clustering integers differing with sem_preds equal: "
          f"{', '.join(differ)}")
    n = len(pts)
    card_offs = got.offset_preds[0, :n].cpu()
    _check_close(f"{tag}: offset_preds", card_offs, want.offset_preds[0, :n])
    xyz = torch.from_numpy(np.ascontiguousarray(pts[:, :3]))
    valid = (want.sem_preds[0, :n] > 0).repeat(2)
    side = cpu.cfg.ball_query_radius / 3.0 ** 0.5
    cells = []
    for offs in (card_offs, want.offset_preds[0, :n]):
        both = torch.cat([xyz, xyz + offs])
        lo = torch.where(valid[:, None], both, torch.tensor(1e9)).amin(dim=0) - side
        cells.append(torch.floor(div_const(both - lo, side)))
    moved = int(((cells[0] != cells[1]).any(dim=-1) & valid).sum())
    n_valid = int(valid.sum())
    print(f"[{tag} compare] points of the two sets in another hash cell on the card: {moved} of "
          f"{n_valid}")
    if moved > CELL_FLIP_SHARE * n_valid:
        raise AssertionError(f"{tag}: {moved} shifted points changed hash cell "
                             f"(> {CELL_FLIP_SHARE:.1%})")
    if moved == 0 and "counter ccl_node_overflow" in differ:
        raise AssertionError(f"{tag}: the node overflow differs with no point in another cell")
    with torch.no_grad():
        ref = cpu.model(cpu._wrap_points(pts), do_cluster=True, do_score=True, do_npcs=True,
                        cluster_sem_override=got.sem_preds.cpu(),
                        cluster_offset_override=got.offset_preds.cpu())
    what = "(CPU clustering of the card's sem_preds and offsets)"
    for k, v in ref.counters.items():
        _check_equal(f"{tag}: counter {k} {what}", got.counters[k], v)
    for f in ref.proposals._fields:
        _check_equal(f"{tag}: proposals.{f} {what}", getattr(got.proposals, f),
                     getattr(ref.proposals, f))
    print(f"[{tag} compare] counters and proposals equal the CPU's clustering of the card's "
          "sem_preds and offsets")
    return ref


def compare_requests(tag, card_req, cpu, pts, proposals_cpu=None):
    """The same request on the CPU (same weights, same CPU-drawn RANSAC
    samples): exact sem_preds, counters, proposals, kept proposal ids,
    ins_preds, classes, box jobs, inlier masks, ok flags; NPCS and scores
    within NPCS_RTOL of scale; boxes, scales, rotations and translations of
    the ok fits within BOX_RTOL of scale.  If sem_preds differ (allowed only
    at near-ties of the top two logits, which then change the clustering),
    the stages after the forward run on the CPU from the card's forward
    outputs and are held to the same rules, and an independent CPU forward
    on the card's proposals holds the card's scores and NPCS (except where a
    flipped point picks the class) and counters.  If sem_preds agree but the
    clustering's counters or proposals differ, `_cluster_replay` explains
    them by the offsets, and the stages after the forward run on the CPU
    from its forward.  Returns how the forward's integers were held:
    "exact", "near-ties" or "replay"."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    c = cpu._request(pts, proposals_cpu)
    print(f"[{tag} compare] CPU request {time.perf_counter() - t0:.1f} s")
    g = card_req
    how = "exact"
    flips = _near_ties(tag, g.out.sem_preds.cpu(), c.out.sem_logits)
    print(f"[{tag} compare] sem_preds differing: {flips} of {c.out.sem_preds.numel()}")
    if flips:
        from gapartnet_tpu_torch.train.trainer import cpu_tree

        prop = cpu_tree(g.out.proposals)
        ref = cpu._forward(pts, prop)
        for k, v in ref.counters.items():
            _check_equal(f"{tag}: counter {k} (CPU forward on the card's proposals)",
                         g.out.counters[k], v)
        flip = (g.out.sem_preds.cpu() != ref.sem_preds)[0]
        same_class = prop.proposal_mask[0] & (g.out.proposal_sem.cpu() == ref.proposal_sem)[0]
        same_entry = prop.entry_mask[0] & ~flip[prop.entry_point[0].long()]
        _check_close(f"{tag}: score_preds (CPU forward on the card's proposals)",
                     g.out.score_preds[0], ref.score_preds[0], mask=same_class, rtol=NPCS_RTOL)
        _check_close(f"{tag}: npcs_preds (CPU forward on the card's proposals)",
                     g.out.npcs_preds[0], ref.npcs_preds[0], mask=same_entry, rtol=NPCS_RTOL)
        keep_given = None if proposals_cpu is None else proposals_cpu.proposal_mask[0]
        out = cpu_tree(g.out)
        keep, result, jobs, fits = _cpu_post(cpu, pts, out, keep_given)
        c = c._replace(out=out, keep=keep, result=result, jobs=jobs, fits=fits)
        how = "near-ties"
        print(f"[{tag} compare] the stages after the forward compared from the card's forward "
              "outputs")
    else:
        differ = [f"counter {k}" for k, v in c.out.counters.items()
                  if not torch.equal(g.out.counters[k].cpu(), v.cpu())]
        differ += [f"proposals.{f}" for f in c.out.proposals._fields
                   if not torch.equal(getattr(g.out.proposals, f).cpu(),
                                      getattr(c.out.proposals, f).cpu())]
        if differ and proposals_cpu is not None:
            raise AssertionError(f"{tag}: {', '.join(differ)} differ with the proposals given")
        if differ:
            out = _cluster_replay(tag, g.out, cpu, pts, c.out, differ)
            keep, result, jobs, fits = _cpu_post(cpu, pts, out, None)
            c = c._replace(out=out, keep=keep, result=result, jobs=jobs, fits=fits)
            how = "replay"
            print(f"[{tag} compare] the stages after the forward compared from that CPU forward")
    _check_equal(f"{tag}: kept proposals", g.keep, c.keep)
    gr, cr = g.result, c.result
    for f in ("sem_preds", "ins_preds", "proposal_classes"):
        _check_equal(f"{tag}: {f}", torch.from_numpy(np.asarray(getattr(gr, f))),
                     torch.from_numpy(np.asarray(getattr(cr, f))))
    for f in ("npcs_map", "proposal_scores"):
        _check_close(f"{tag}: {f}", torch.from_numpy(getattr(gr, f)), torch.from_numpy(getattr(cr, f)),
                     rtol=NPCS_RTOL)
    if (g.jobs is None) != (c.jobs is None):
        raise AssertionError(f"{tag}: box jobs on one device only")
    if c.jobs is None:
        print(f"[{tag} compare] no box jobs")
        return how
    for f in ("mask", "owner"):
        _check_equal(f"{tag}: jobs.{f}", torch.from_numpy(getattr(g.jobs, f)),
                     torch.from_numpy(getattr(c.jobs, f)))
    _check_equal(f"{tag}: ok flags", g.fits.ok, c.fits.ok)
    _check_equal(f"{tag}: inlier masks", g.fits.inlier_mask, c.fits.inlier_mask)
    ok = c.fits.ok.cpu()
    for f in ("bbox", "scale", "rotation", "translation"):
        _check_close(f"{tag}: fits.{f} (ok fits)", getattr(g.fits, f).cpu()[ok],
                     getattr(c.fits, f)[ok], rtol=BOX_RTOL)
    print(f"[{tag} compare] card and CPU agree: integers exactly, NPCS and scores within "
          f"{NPCS_RTOL}, {int(ok.sum())} ok boxes within {BOX_RTOL} of scale")
    return how


def render_depth(xyz, rgb):
    """A depth frame of the cloud: DEPTH_OFFSET in front of a DEPTH_HW
    pinhole camera with intrinsics DEPTH_K, each point splatted over a
    (2 * DEPTH_SPLAT + 1)^2 square, nearest point wins.  Returns (depth
    (H, W) float32, K (3, 3), BGR image (H, W, 3) uint8)."""
    import numpy as np

    h, w = DEPTH_HW
    k = np.asarray(DEPTH_K)
    z = xyz[:, 2].astype(np.float64) + DEPTH_OFFSET
    u = np.round(k[0, 0] * xyz[:, 0] / z + k[0, 2]).astype(np.int64)
    v = np.round(k[1, 1] * xyz[:, 1] / z + k[1, 2]).astype(np.int64)
    depth = np.full(h * w, np.inf)
    for dy in range(-DEPTH_SPLAT, DEPTH_SPLAT + 1):
        for dx in range(-DEPTH_SPLAT, DEPTH_SPLAT + 1):
            uu, vv = u + dx, v + dy
            inside = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
            np.minimum.at(depth, vv[inside] * w + uu[inside], z[inside])
    hit = np.isfinite(depth)
    bgr = np.zeros((h * w, 3), np.uint8)
    order = np.argsort(-z, kind="stable")          # nearer points paint last
    for dy in range(-DEPTH_SPLAT, DEPTH_SPLAT + 1):
        for dx in range(-DEPTH_SPLAT, DEPTH_SPLAT + 1):
            uu, vv = u[order] + dx, v[order] + dy
            inside = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
            bgr[vv[inside] * w + uu[inside]] = (rgb[order][inside][:, ::-1] * 255).astype(np.uint8)
    depth = np.where(hit, depth, 0.0).astype(np.float32).reshape(h, w)
    return depth, k, bgr.reshape(h, w, 3)


def phase_joint_angle(xyz, ins):
    """estimate_joint_angle on the card, once per branch, on the largest
    part of the cloud rotated about z around a pivot near it: the
    tolerances of tests/test_infer.py (the CPD branch on 300 shuffled
    points)."""
    import numpy as np

    from gapartnet_tpu_torch.infer.api import estimate_joint_angle

    part = xyz[ins == np.bincount(ins[ins >= 0]).argmax()].astype(np.float64)
    pivot = part.mean(0) + np.array([0.05, -0.03, 0.0])
    for method, angle, sub, (tol_angle, tol_axis, tol_pivot) in (
            ("ransac", 0.7, None, (1e-3, 1e-3, 1e-2)), ("cpd", 0.5, 300, (5e-3, 5e-3, 2e-2))):
        rng = np.random.RandomState(0)
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
        a = part if sub is None else part[rng.choice(len(part), sub, replace=False)]
        b = (a - pivot) @ rot + pivot
        if method == "cpd":
            b = b[rng.permutation(len(b))]
        t0 = time.perf_counter()
        est = estimate_joint_angle(a, b, method=method, device="cuda")
        ms = (time.perf_counter() - t0) * 1e3
        errs = (abs(abs(est["angle_rad"]) - angle), float(np.abs(np.abs(est["axis"]) - [0, 0, 1]).max()),
                float(np.abs(est["pivot"][:2] - pivot[:2]).max()))
        print(f"[joint] {method}: {len(a)} points, angle error {errs[0]:.2e} (tol {tol_angle}), "
              f"axis {errs[1]:.2e} ({tol_axis}), pivot xy {errs[2]:.2e} ({tol_pivot}); {ms:.1f} ms")
        if not (errs[0] <= tol_angle and errs[1] <= tol_axis and errs[2] <= tol_pivot):
            raise AssertionError(f"estimate_joint_angle ({method}) missed the joint: {errs}")


def phase_inference_api(smi):
    """The fourth slice: predict, predict_with_masks and predict_depth of
    GAPartNetInference at the flagship config with the eval capacities, on
    the card, each against the CPU; estimate_joint_angle.  Returns the
    per-phase numbers for the kernel line."""
    import numpy as np

    from gapartnet_tpu_torch.config import GAPartNetConfig, eval_capacity_config
    from gapartnet_tpu_torch.infer.api import backproject_depth, ball_space_normalize, fps_downsample

    cfg = eval_capacity_config(GAPartNetConfig())
    pts, ins = bench_points()
    print(f"[predict] eval capacities: node cap {cfg.hash_node_capacity}, candidate and degree caps "
          f"{cfg.hash_cand_cap}/{cfg.hash_max_degree}, max_proposals {cfg.max_proposals}, dense pool "
          f"{cfg.dense_grid_capacity}; auto_capacity")
    numbers = {}

    # predict on the bench cloud
    card, cpu = inference_pair(cfg)
    times, launches = run_requests("predict", lambda: card.predict(pts), PREDICT_REQUESTS,
                                   PREDICT_WARMUPS, smi)
    print(f"[predict] capacities {card.cfg.input_capacities()}, extent {card.cfg.input_grid_extent}")
    err = phase_api_kernels("predict", card, pts)
    req, split, device = report_split("predict", card, pts)
    numbers["predict"] = dict(launches=launches, **_quantiles(times), split=split, device=device,
                              max_abs_err=err)
    compare_requests("predict", req, cpu, pts)

    # predict_with_masks on the cloud's ground-truth instances
    masks = np.stack([ins == i for i in range(ins.max() + 1)])
    card, cpu = inference_pair(cfg)
    times, launches = run_requests("masks", lambda: card.predict_with_masks(pts, masks),
                                   PREDICT_REQUESTS, PREDICT_WARMUPS, smi)
    err = phase_api_kernels("masks", card, pts)
    req, split, device = report_split("masks", card, pts, card._mask_proposals(masks, len(pts)))
    counters = {k: int(v.sum()) for k, v in req.out.counters.items()}
    if any(counters.values()):
        raise AssertionError(f"masks: capacity counters nonzero: {counters}")
    numbers["masks"] = dict(launches=launches, **_quantiles(times), split=split, device=device,
                            max_abs_err=err)
    compare_requests("masks", req, cpu, pts, cpu._mask_proposals(masks, len(pts)))

    # predict_depth on a depth frame rendered from the cloud
    depth, k, bgr = render_depth(pts[:, :3], pts[:, 3:])
    xyz, colors, _ = backproject_depth(depth, k, bgr)
    print(f"[depth] frame {depth.shape[1]}x{depth.shape[0]}, {len(xyz)} valid pixels")
    card, cpu = inference_pair(cfg)
    fps_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        idx = fps_downsample(xyz, cfg.max_points, device="cuda")
        fps_times.append((time.perf_counter() - t0) * 1e3)
    fps_dev, fps_kernels = busy_ms(lambda: fps_downsample(xyz, cfg.max_points, device="cuda"))
    print(f"[depth] FPS {min(len(xyz), 4 * cfg.max_points)} -> {cfg.max_points} points: "
          f"{statistics.median(fps_times):.3f} ms per call (median of 3, host clock), kernel time "
          f"{_fmt(fps_dev)} ms in {fps_kernels} kernels  ({smi})")
    times, launches = run_requests("depth", lambda: card.predict_depth(depth, k, bgr), DEPTH_REQUESTS,
                                   DEPTH_WARMUPS, smi)
    pts_d = np.concatenate([ball_space_normalize(xyz[idx])[0], colors[idx]], axis=1)
    err = phase_api_kernels("depth", card, pts_d)
    req, split, device = report_split("depth", card, pts_d, requests=DEPTH_REQUESTS)
    numbers["depth"] = dict(launches=launches, **_quantiles(times), split=split, device=device,
                            fps_ms=statistics.median(fps_times), fps_device_ms=fps_dev,
                            max_abs_err=err)
    t0 = time.perf_counter()
    idx_cpu = fps_downsample(xyz, cfg.max_points, device="cpu")
    print(f"[depth compare] CPU FPS {time.perf_counter() - t0:.1f} s")
    if not np.array_equal(idx, idx_cpu):
        raise AssertionError(f"FPS indices differ at {int((idx != idx_cpu).sum())} of {len(idx)}")
    print("[depth compare] FPS indices identical")
    compare_requests("depth", req, cpu, pts_d)

    phase_joint_angle(pts[:, :3], ins)
    return numbers


def write_fit_dataset(root, train_clouds=FIT_TRAIN_CLOUDS, eval_clouds=FIT_EVAL_CLOUDS,
                      eval_only=False):
    """The fit's dataset under `root`, in the .npz layout load_cloud_file
    reads: assets/bench_cloud.npz rotated about z (entry.rotation_z), the
    train split at `train_clouds` angles 2 pi i / train_clouds (none with
    `eval_only`), each eval split at `eval_clouds` of the angles half-way
    between."""
    import numpy as np

    from gapartnet_tpu_torch.entry import BENCH_CLOUD, rotation_z

    d = np.load(BENCH_CLOUD)
    step = 2 * np.pi / train_clouds
    angles = {} if eval_only else {"train": [i * step for i in range(train_clouds)]}
    for si, split in enumerate(("val", "test_intra", "test_inter")):
        angles[split] = [(si * eval_clouds + j + 0.5) * step for j in range(eval_clouds)]
    for split, thetas in angles.items():
        out = root / split / "pth"
        out.mkdir(parents=True)
        for i, theta in enumerate(thetas):
            xyz = (d["xyz"].astype(np.float64) @ rotation_z(theta)).astype(np.float32)
            np.savez(out / f"bench_{split}_{i:02d}.npz", xyz=xyz, rgb=d["rgb"],
                     sem_labels=d["sem_labels"], instance_labels=d["instance_labels"],
                     gt_npcs=d["gt_npcs"])


def fit_overrides(data_root, extra=()):
    return [("data.init_args.root_dir", str(data_root)), *FIT_OVERRIDES, *extra]


def fit_config(data_root, run_dir, extra=()):
    """configs/gapartnet.yaml through the port's reader with the fit's
    overrides; checkpoints and metrics under `run_dir` (the schema reads no
    trainer.ckpt_dir / log_file, so they are set here)."""
    from gapartnet_tpu_torch.train.config import load_config

    cfg = load_config(str(ROOT / "configs" / "gapartnet.yaml"), fit_overrides(data_root, extra))
    cfg.trainer.ckpt_dir = str(run_dir / "checkpoints")
    cfg.trainer.log_file = str(run_dir / "metrics.jsonl")
    return cfg


class FitProbe:
    """Wraps the trainer's train_step, eval_step, evaluate_splits and
    CkptManager.save for the length of a `with` block: each call is timed
    between two synchronizes, and the subm-conv counts are read (not reset)
    around each train step and eval forward."""

    def __init__(self):
        self.steps, self.evals, self.validations, self.saves = [], [], [], []

    def _wrap(self, fn, records, key=None):
        import torch

        from gapartnet_tpu_torch.ops.subm_conv import LAUNCHES

        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            records.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                launches={k: LAUNCHES[k] - before[k] for k in LAUNCHES},
                                key=key(kw) if key else None))
            return out

        return wrapper

    def __enter__(self):
        from gapartnet_tpu_torch.train import trainer

        self._trainer = trainer
        self._saved = dict(train_step=trainer.train_step, eval_step=trainer.eval_step,
                           evaluate_splits=trainer.evaluate_splits, save=trainer.CkptManager.save)
        trainer.train_step = self._wrap(trainer.train_step, self.steps, key=lambda kw: kw["do_npcs"])
        trainer.eval_step = self._wrap(trainer.eval_step, self.evals)
        trainer.evaluate_splits = self._wrap(trainer.evaluate_splits, self.validations)
        trainer.CkptManager.save = self._wrap(trainer.CkptManager.save, self.saves)
        return self

    def __exit__(self, *exc):
        t = self._trainer
        t.train_step, t.eval_step = self._saved["train_step"], self._saved["eval_step"]
        t.evaluate_splits, t.CkptManager.save = self._saved["evaluate_splits"], self._saved["save"]


def _metric_lines(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def check_metric_lines(tag, lines, cfg):
    """Every value finite; each train line holds exactly the JAX trainer's
    train names, each eval line a subset of its eval names
    (trainer.py:574-625) lacking only the recalls of classes absent from a
    split."""
    import math

    from gapartnet_tpu_torch.train.trainer import eval_metric_names, train_metric_names

    for line in lines:
        bad = [k for k, v in line.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{tag}: non-finite metrics {bad}")
        keys = set(line) - {"step"}
        if "epoch" in line:
            want = set(train_metric_names(True))
            if keys != want:
                raise AssertionError(f"{tag}: train line names differ: {sorted(keys ^ want)}")
        else:
            do_instance = any(k.startswith("val/AP@50_") for k in keys)
            want = set(eval_metric_names(cfg, do_instance))
            if not keys <= want or any("/recall_" not in k for k in want - keys):
                raise AssertionError(f"{tag}: eval line names differ: {sorted(keys ^ want)}")


def _check_launches(tag, records, want_of):
    for i, r in enumerate(records):
        want = want_of(r)
        if r["launches"] != want:
            raise AssertionError(f"{tag} {i + 1}: subm_conv launched {r['launches']}, expected {want}")


def _print_counters(tag, lines):
    for line in lines:
        counters = {k: v for k, v in line.items() if "counters/" in k}
        what = f"epoch {int(line['epoch'])} train (mean per step)" if "epoch" in line else "eval"
        print(f"[{tag}] {what} counters at step {line['step']}: "
              + ", ".join(f"{k} {v:g}" for k, v in counters.items()))


def run_cli(tag, args, cwd, torchrun=False):
    """`python -m gapartnet_tpu_torch.train.cli <args>` in `cwd`, on the
    card (no --device), as a user runs it; with `torchrun`, under
    `python -m torch.distributed.run --standalone --nproc_per_node 1` (one
    process, NCCL).  Returns its stdout."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p))
    cwd.mkdir(parents=True, exist_ok=True)
    launcher = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1"]
    cmd = [*(launcher if torchrun else []), "-m", "gapartnet_tpu_torch.train.cli", *args]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *cmd], cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=CLI_TIMEOUT_S)
    print(f"[{tag}] python {' '.join(cmd[:len(cmd) - len(args) + 1])} ...: exit {r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    if r.returncode != 0:
        raise AssertionError(f"{tag}: the CLI failed:\n{r.stdout[-3000:]}\n{r.stderr[-5000:]}")
    return r.stdout


def fit_kernels(cfg, model, train_raw, val_raw, tag="fit"):
    """The forward, dgrad and wgrad kernels against their plain versions at
    the fit's own shapes: the backbone hierarchy of a fit train batch
    (`train_raw`, at the fit's auto_capacity levels) and the proposal grid
    of a train forward on it (clustering on the fitted sem head, on a copy
    of `model` so that its running statistics stay), and the forward at
    every backbone shape of the eval model's hierarchy of `val_raw` (the
    val split's padded batch).  The bf16 kernels (phase 11a's rules) where
    cfg.model computes in bf16.  Returns the largest max|d| of each
    kernel."""
    import torch

    from gapartnet_tpu_torch.config import eval_capacity_config
    from gapartnet_tpu_torch.entry import make_model
    from gapartnet_tpu_torch.models.gapartnet import prepare_input_grid
    from gapartnet_tpu_torch.ops.sparse_conv import build_hierarchy
    from gapartnet_tpu_torch.structures import PointCloudBatch
    from gapartnet_tpu_torch.train.loop import draw_jitter

    def hierarchy(mcfg, batch):
        keys, _, nvox, _ = prepare_input_grid(batch.points, batch.point_mask, mcfg)
        return build_hierarchy(keys, nvox, mcfg.input_capacities(), extent=mcfg.input_grid_extent)

    mcfg = cfg.model
    batch = PointCloudBatch.from_numpy(train_raw, "cuda")
    probe = make_model(mcfg, "cuda", seed=0)
    probe.load_state_dict(model.state_dict())
    with torch.no_grad():
        out = probe.train()(batch, do_cluster=True, do_score=True, do_npcs=True,
                            jitter=draw_jitter(torch.Generator().manual_seed(cfg.trainer.seed)))
    hier, prop = hierarchy(mcfg, batch), out.proposal_grid
    print(f"[{tag} kernel] B={batch.batch_size} train batch: voxels per level (max over B) "
          f"{[int(lv.num_voxels.max()) for lv in hier.levels]} of {mcfg.input_capacities()}; live "
          f"proposals {out.proposals.num_proposals.tolist()}, proposal voxels "
          f"{prop.levels[0].num_voxels.tolist()} of {mcfg.proposal_capacities()}")
    shapes = train_conv_shapes(mcfg, hier, prop)
    ecfg = eval_capacity_config(mcfg)
    ehier = hierarchy(ecfg, PointCloudBatch.from_numpy(val_raw, "cuda"))
    print(f"[{tag} eval kernel] B={val_raw['points'].shape[0]} val batch (the last cloud padded): "
          f"voxels per level {[lv.num_voxels.tolist() for lv in ehier.levels]}")
    if mcfg.conv_compute_dtype == "bfloat16":
        rows = phase_bf16_kernels(bf16_train_shapes(shapes), BF16_KINDS, f"{tag} kernel",
                                  timed=False)
        err = {k: max(r[k]["max_abs_err"] for r in rows) for k in BF16_KINDS}
        erows = phase_bf16_kernels(bf16_inference_shapes(ecfg, ehier), ("fwd_bf16",),
                                   f"{tag} eval kernel", timed=False)
        err["fwd_bf16"] = max(err["fwd_bf16"], *(r["fwd_bf16"]["max_abs_err"] for r in erows))
        return err
    rows = phase_train_kernels(shapes, tag=f"{tag} kernel", timed=False)
    err = {k: max(r[k]["max_abs_err"] for r in rows) for k in ("fwd", "dgrad", "wgrad")}
    erows = phase_kernels(ecfg, ehier, "cuda", tag=f"{tag} eval kernel", timed=False)
    err["fwd"] = max(err["fwd"], *(r["max_abs_err"] for r in erows))
    return err


def compare_fit_eval(cfg, model, device_batch, cpu_batch, tag="fit compare", eval_cfg=None):
    """One reduced eval step (trainer.reduce_eval_outputs of an eval
    forward) on the card and on the CPU with the same weights, on every
    cloud of the batch, at `eval_cfg` (default: the eval capacities of
    cfg.model): conf, accuracies, keep, rep_cls and counters
    exactly, scores and IoUs within FIT_SCORE_RTOL of scale.  On a near-tie
    sem flip (which changes the clustering) the CPU runs its forward on the
    card's proposals instead, and the selection on the card's outputs."""
    import torch

    from gapartnet_tpu_torch.config import eval_capacity_config
    from gapartnet_tpu_torch.models.gapartnet import GAPartNet
    from gapartnet_tpu_torch.train.loop import eval_step
    from gapartnet_tpu_torch.train.trainer import cpu_tree, host_copy, reduce_eval_outputs

    ecfg = eval_capacity_config(cfg.model) if eval_cfg is None else eval_cfg
    card = model.with_config(ecfg)
    cpu = GAPartNet(ecfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    flags = dict(do_cluster=True, do_score=True, do_npcs=True)
    out_g = eval_step(card, device_batch, **flags)
    rg = host_copy(reduce_eval_outputs(out_g, device_batch, ecfg, True))
    t0 = time.perf_counter()
    out_c = eval_step(cpu, cpu_batch, **flags)
    print(f"[{tag}] CPU eval forward {time.perf_counter() - t0:.1f} s")
    flips = _near_ties(tag, out_g.sem_preds.cpu(), out_c.sem_logits)
    print(f"[{tag}] sem_preds differing: {flips} of {out_c.sem_preds.numel()}")
    if flips:
        conf_c = host_copy(reduce_eval_outputs(out_c, cpu_batch, ecfg, False))["conf"]
        moved = float(abs(rg["conf"] - conf_c).sum())
        if moved > 2 * flips:
            raise AssertionError(f"{tag}: conf moved by {moved} for {flips} flipped points")
        with torch.no_grad():
            ref = cpu(cpu_batch, **flags, proposals_override=cpu_tree(out_g.proposals))
        rc = host_copy(reduce_eval_outputs(cpu_tree(out_g), cpu_batch, ecfg, True))
        for k in [k for k in rg if k.startswith("counters/")]:
            rc[k] = ref.counters[k.split("/", 1)[1]].sum().to(torch.float32).numpy()
        same = (out_g.proposal_sem.cpu() == ref.proposal_sem).numpy()
        rc["scores"], rc["ious"] = ref.score_preds.numpy(), ref.ious.numpy()
        mask = {"scores": same, "ious": same}
        print(f"[{tag}] compared through the CPU forward on the card's proposals")
    else:
        rc = host_copy(reduce_eval_outputs(out_c, cpu_batch, ecfg, True))
        mask = {}
    for k in rg:
        if k in ("scores", "ious"):
            got, want = torch.from_numpy(rg[k]), torch.from_numpy(rc[k])
            m = mask.get(k)
            _check_close(f"{tag}: {k}", got, want,
                         None if m is None else torch.from_numpy(m), rtol=FIT_SCORE_RTOL)
        elif k in ("all_accu", "pixel_accu", "conf") and flips:
            continue
        else:
            _check_equal(f"{tag}: {k}", torch.as_tensor(rg[k]), torch.as_tensor(rc[k]))
    pad = ~cpu_batch.point_mask.any(dim=1).numpy()
    if rg["keep"][pad].any():
        raise AssertionError(f"{tag}: a padded cloud kept {int(rg['keep'][pad].sum())} "
                             "proposals")
    counters = {k: float(v) for k, v in rg.items() if k.startswith("counters/")}
    print(f"[{tag}] B={len(pad)} ({int(pad.sum())} padded): card and CPU agree on conf, keep "
          f"({rg['keep'].sum(axis=1).tolist()} kept per cloud), rep_cls, counters {counters} "
          f"exactly; scores and IoUs within {FIT_SCORE_RTOL}")


def phase_fit(smi, keep_last=None):
    """The fifth slice: fit, a frozen-trunk epoch, the CLI's resume and
    test, and a reduced eval step against the CPU.  With `keep_last`, the
    fit's checkpoint `last` is copied there (for phase 14).  Returns the
    launch counts and times for the kernel line."""
    import shutil
    import tempfile
    import zlib

    import torch

    from gapartnet_tpu_torch.ops.subm_conv import LAUNCHES, reset_launches
    from gapartnet_tpu_torch.train import trainer

    numbers = {}
    with tempfile.TemporaryDirectory(prefix="gapartnet_fit_") as tmp:
        tmp = Path(tmp)
        data = tmp / "data"
        write_fit_dataset(data)
        cfg = fit_config(data, tmp / "fit")
        print(f"[fit] configs/gapartnet.yaml + {dict(FIT_OVERRIDES)}: channels {cfg.model.channels}, "
              f"block_repeat {cfg.model.block_repeat}, max_points {cfg.model.max_points}, "
              f"max_proposals {cfg.model.max_proposals}; {FIT_TRAIN_CLOUDS} train clouds, "
              f"{FIT_EVAL_CLOUDS} per eval split")

        # the fit, in process
        reset_launches()
        t0 = time.perf_counter()
        with FitProbe() as probe:
            state = trainer.fit(cfg, device="cuda")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        print(f"[fit] trainer.fit: {fit_s:.1f} s; capacities {cfg.model.input_capacities()}, extent "
              f"{cfg.model.input_grid_extent}, node cap {cfg.model.hash_node_capacity}, cand cap "
              f"{cfg.model.hash_cand_cap}, degree {cfg.model.hash_max_degree}")
        _check_launches("fit step", probe.steps, lambda r: FIT_LAUNCHES_PER_STEP[r["key"]])
        _check_launches("fit eval forward", probe.evals, lambda r: EVAL_FORWARD_LAUNCHES)
        want_total = {k: sum(r["launches"][k] for r in probe.steps + probe.evals) for k in launches}
        n_steps = len(probe.steps)
        if (n_steps != 2 * (FIT_TRAIN_CLOUDS // FIT_BATCH) or launches != want_total
                or len(probe.evals) != 2 * 3 * -(-FIT_EVAL_CLOUDS // FIT_VAL_BATCH)):
            raise AssertionError(f"fit: {n_steps} steps, {len(probe.evals)} eval forwards, launches "
                                 f"{launches} (the steps and eval forwards account for {want_total})")
        if not all(launches[k] for k in ("fwd", "dgrad", "wgrad")):
            raise AssertionError(f"fit: a kernel never launched: {launches}")
        lines = _metric_lines(tmp / "fit" / "metrics.jsonl")
        check_metric_lines("fit", lines, cfg)
        ckpts = sorted(p.name for p in (tmp / "fit" / "checkpoints").iterdir())
        if len(ckpts) != 3 or ckpts[-1] != "last" or not (
                ckpts[0].startswith("epoch_000_mean_mAP_") and ckpts[1].startswith("epoch_001_mean_mAP_")):
            raise AssertionError(f"fit: checkpoints {ckpts}")
        train_lines = [line for line in lines if "epoch" in line]
        for line in train_lines:
            print(f"[fit] epoch {int(line['epoch'])}: epoch_time_s {line['epoch_time_s']:.3f}, "
                  f"train_loss/total_loss {line['train_loss/total_loss']:.4f}  ({smi})")
        for i, r in enumerate(probe.steps):
            print(f"[fit] step {i + 1} (do_npcs {r['key']}): {r['ms']:.3f} ms, launches {r['launches']}")
        windows = {e: [r["ms"] for r in probe.steps if r["key"] == bool(e)][1:] for e in (0, 1)}
        for e, times in windows.items():
            q = _quantiles(times)
            print(f"[fit] B={FIT_BATCH} ms per train step in epoch {e} after its first step, over "
                  f"{len(times)} steps: median {q['median']:.3f}, p10 {q['p10']:.3f}, p90 "
                  f"{q['p90']:.3f}, min {min(times):.3f}, max {max(times):.3f}; "
                  f"{FIT_BATCH / q['median'] * 1e3:.2f} clouds/s  ({smi})")
        step_ms = statistics.median(windows[1])
        split_ms = [r["ms"] / 3 for r in probe.validations]
        save_ms = [r["ms"] for r in probe.saves]
        eval_ms = [r["ms"] for r in probe.evals]
        print(f"[fit] ms per split validation (mean of the 3 splits, {FIT_EVAL_CLOUDS} clouds in "
              f"batches of {FIT_VAL_BATCH}) {', '.join(f'{m:.3f}' for m in split_ms)}; ms per eval "
              f"forward {', '.join(f'{m:.3f}' for m in eval_ms)}; ms per checkpoint save "
              f"{', '.join(f'{m:.3f}' for m in save_ms)}  ({smi})")
        print(f"[fit] launches {launches} in {n_steps} steps and {len(probe.evals)} eval forwards; "
              f"checkpoints {ckpts}")
        _print_counters("fit", lines)
        numbers["fit"] = dict(
            launches=launches, steps=n_steps, eval_forwards=len(probe.evals),
            per_step={"epoch0": FIT_LAUNCHES_PER_STEP[False], "epoch1": FIT_LAUNCHES_PER_STEP[True]},
            epoch_time_s=[line["epoch_time_s"] for line in train_lines], step_ms=step_ms,
            step_ms_window=windows[1],
            split_ms=split_ms, save_ms=save_ms, eval_forward_ms=eval_ms, seconds=fit_s)

        # the kernels at the fit's shapes, and the val split's padded batch
        datasets = trainer.build_datasets(cfg, "fit")
        train_raw = next(trainer._iter_batches(datasets["train"], FIT_BATCH, drop_last=True,
                                               shuffle_seed=cfg.trainer.seed + 1))
        *_, val_raw = trainer._iter_batches(datasets["val"], FIT_VAL_BATCH, drop_last=False)
        numbers["fit"]["max_abs_err"] = fit_kernels(cfg, state.model, train_raw, val_raw)
        # the card-vs-CPU eval step's batch: the val split's last batch of 2, a cloud and a pad
        *_, pair_raw = trainer._iter_batches(datasets["val"], FIT_COMPARE_BATCH, drop_last=False)

        # a frozen-trunk epoch warm-started from `last`
        last = tmp / "fit" / "checkpoints" / "last"
        if keep_last is not None:
            shutil.copyfile(last, keep_last)
        fcfg = fit_config(data, tmp / "frozen", extra=(
            ("model.init_args.training_schedule", "[0, 0]"), ("trainer.max_epochs", "1"),
            ("model.init_args.ckpt", str(last))))
        fcfg.trainer.freeze_prefixes = FREEZE
        reset_launches()
        with FitProbe() as fprobe:
            fstate = trainer.fit(fcfg, device="cuda")
        frozen_launches = dict(LAUNCHES)
        _check_launches("frozen step", fprobe.steps, lambda r: FROZEN_LAUNCHES_PER_STEP)
        ref = trainer.CkptManager.restore(str(last))["model"]
        after = fstate.model.state_dict()
        params = dict(fstate.model.named_parameters())
        (fline,) = [line for line in _metric_lines(tmp / "frozen" / "metrics.jsonl") if "epoch" in line]
        # a branch whose loss was 0 all epoch got no gradient (fresh Adam: no move)
        trained = sum((branch for branch, loss in (
            (("score_unet", "score_head"), "loss_prop_score"),
            (("npcs_unet", "npcs_head"), "loss_prop_npcs")) if fline[f"train_loss/{loss}"] > 0), ())
        if not trained:
            raise AssertionError("frozen: no proposal all epoch, so no branch could train")
        fixed = moved = 0
        for k, v in ref.items():
            top = k.split(".", 1)[0]
            same = torch.equal(after[k], v.to(after[k].device))
            if top in FREEZE and not same:
                raise AssertionError(f"frozen: {k} changed")
            if top in trained and k in params and same:
                raise AssertionError(f"frozen: {k} did not move")
            fixed += top in FREEZE
            moved += top in trained and k in params
        print(f"[frozen] one epoch with {FREEZE} frozen, warm-started from last: {fixed} frozen "
              f"tensors (parameters and running statistics) bitwise unchanged on the card; all "
              f"{moved} parameters of {trained} moved (epoch losses: score "
              f"{fline['train_loss/loss_prop_score']:.4f}, NPCS "
              f"{fline['train_loss/loss_prop_npcs']:.4f}); launches {frozen_launches} in "
              f"{len(fprobe.steps)} steps ({FROZEN_LAUNCHES_PER_STEP} per step) and "
              f"{len(fprobe.evals)} eval forwards")
        numbers["frozen"] = dict(launches=frozen_launches, per_step=FROZEN_LAUNCHES_PER_STEP)

        # the CLI: resume from the epoch-0 checkpoint, then test `last`
        flat = [a for kv in fit_overrides(data) for a in ("--" + kv[0], kv[1])]
        base = ["-c", str(ROOT / "configs" / "gapartnet.yaml"), *flat]
        epoch0 = next(p for p in (tmp / "fit" / "checkpoints").iterdir()
                      if p.name.startswith("epoch_000"))
        saved = trainer.CkptManager.restore(str(epoch0))
        crc = zlib.crc32(saved["generator"].numpy().tobytes())
        out = run_cli("fit resume", ["fit", *base, "--trainer.ckpt_path", str(epoch0)], tmp / "resume",
                      torchrun=True)
        want = (f"at epoch 1 (step {saved['step']}, gstep {saved['gstep']}, jitter generator state "
                f"crc32 {crc:08x})")
        for line in (want, "data parallel: rank 0 of 1 (nccl)"):
            if line not in out:
                raise AssertionError(f"fit resume: no '{line}' in its output:\n{out[-2000:]}")
        rlines = _metric_lines(tmp / "resume" / "metrics.jsonl")
        check_metric_lines("fit resume", rlines, cfg)
        epochs = [int(line["epoch"]) for line in rlines if "epoch" in line]
        if epochs != [1] or rlines[0]["step"] != saved["gstep"] + n_steps // 2:
            raise AssertionError(f"fit resume logged epochs {epochs} at step {rlines[0]['step']}")
        print(f"[fit resume] resumed {want}; logged epoch 1 only, epoch_time_s "
              f"{rlines[0]['epoch_time_s']:.3f}, step {rlines[0]['step']}")
        out = run_cli("test", ["test", *base, "--model.init_args.ckpt", str(last),
                               "--model.init_args.training_schedule", "[0,0]"], tmp / "test")
        printed = [line for line in out.splitlines() if ": " in line and "/" in line.split(": ")[0]]
        if not any(line.startswith("monitor_metrics/mean_mAP: ") for line in printed) or not any(
                "/counters/" in line for line in printed):
            raise AssertionError(f"test: metrics not printed:\n{out[-2000:]}")
        for line in printed:
            if line.startswith("monitor_metrics/") or "/counters/" in line or line.split(": ")[0] in (
                    "val/AP@50", "val/mAP", "val/miou"):
                print(f"[test] {line}")

        # card vs CPU: one reduced eval step on the val split's padded batch
        from gapartnet_tpu_torch.structures import PointCloudBatch

        compare_fit_eval(cfg, state.model, PointCloudBatch.from_numpy(pair_raw, "cuda"),
                         PointCloudBatch.from_numpy(pair_raw, "cpu"))
    return numbers


def dp_reference(cfg, batch, cluster_sem, cluster_off, path):
    """The one-process card step that the data-parallel first step must
    equal: phase 5's first step (seed-0 weights, the first jitter draw of
    seed 0, B = 8) as a forward and backward, and the four probes of phase
    6 at B = 8 for the gradients' rounding allowance; saved to `path`."""
    import torch

    from gapartnet_tpu_torch.train.loop import draw_jitter

    jitter = draw_jitter(torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    model, out, _ = _train_pass(cfg, batch, "cuda", cluster_sem, cluster_off, jitter)
    grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
    own = dict.fromkeys(grads, 0.0)
    for probe in PROBES:
        pm, _, _ = _train_pass(cfg, batch, "cuda", cluster_sem, cluster_off, jitter, probe)
        for k, p in pm.named_parameters():
            own[k] = max(own[k], float((p.grad.cpu() - grads[k]).abs().max()))
    torch.cuda.synchronize()
    torch.save(dict(grads=grads, own=own,
                    stats={k: v.cpu() for k, v in model.state_dict().items() if "running_" in k},
                    losses={f"loss/{k}": float(getattr(out, k).detach()) for k in out.LOSSES}),
               path)
    print(f"[dp] reference: the one-process B={batch.batch_size} card step from phase 5's start "
          f"and {len(PROBES)} probes ({time.perf_counter() - t0:.1f} s)")


def _check_dp_first_step(rank_tag, metrics, model, ref):
    """The first data-parallel step against the one-process reference:
    the ranks' summed losses and the running statistics within 1e-4 of
    magnitude, every gradient within phase 6's allowance."""
    import torch

    for k, want in ref["losses"].items():
        got = metrics[k]
        if not abs(got - want) <= LOSS_RTOL * max(abs(want), 1.0):
            raise AssertionError(f"{rank_tag}: {k} summed over the ranks {got} vs {want}")
    state = model.state_dict()
    worst_stats = 0.0
    for k, want in ref["stats"].items():
        err = float((state[k].cpu() - want).abs().max())
        scale = float(want.abs().max())
        if not err <= STATS_RTOL * scale:
            raise AssertionError(f"{rank_tag}: {k} max|d| {err} > {STATS_RTOL} * {scale}")
        worst_stats = max(worst_stats, err / scale)
    top = max(float(g.abs().max()) for g in ref["grads"].values())
    worst, failures = 0.0, []
    for k, p in model.named_parameters():
        want = ref["grads"][k]
        scale = max(float(want.abs().max()), GRAD_FLOOR * top)
        err = float((p.grad.cpu() - want).abs().max())
        allowed = GRAD_RTOL * scale + KINK_FACTOR * ref["own"][k]
        worst = max(worst, err / allowed)
        if err > allowed:
            failures.append(f"{k}: max|d| {err} > {GRAD_RTOL} * {scale} + {KINK_FACTOR} * "
                            f"{ref['own'][k]}")
    if failures:
        raise AssertionError(f"{rank_tag}: gradients vs the one-process step:\n"
                             + "\n".join(failures))
    print(f"[{rank_tag}] first step vs the one-process B={TRAIN_BATCH} step: losses within "
          f"{LOSS_RTOL}, running statistics worst max|d| / max|ref| {worst_stats:.3e}, gradients "
          f"worst max|d| / allowed {worst:.3f}")
    return dict(worst_grad=worst, worst_stats=worst_stats)


def _dp_step_rank(rank, dev, tmp):
    """Part (a) on one rank: the kernels against their plain versions at
    this rank's shapes, then the data-parallel train step at B = DP_BATCH:
    the first step against the reference, DP_WARMUP_STEPS - 1 more, then
    DP_TIMED_STEPS timed ones (launches and all-reduces counted), the
    parameters and buffers bitwise against rank 0's, and the gradient
    all-reduce alone timed."""
    import torch
    import torch.distributed as dist

    from gapartnet_tpu_torch.entry import make_model
    from gapartnet_tpu_torch.models.gapartnet import prepare_input_grid
    from gapartnet_tpu_torch.ops.sparse_conv import build_hierarchy
    from gapartnet_tpu_torch.ops.subm_conv import LAUNCHES, reset_launches
    from gapartnet_tpu_torch.parallel import dist as pdist
    from gapartnet_tpu_torch.train.loop import adam, train_step

    tag = f"dp rank {rank}"
    inp = torch.load(tmp / "inputs.pt", weights_only=False)
    cfg = inp["cfg"]
    lo, hi = rank * DP_BATCH, (rank + 1) * DP_BATCH
    sub = _clouds(inp["batch"], lo, hi).to(dev)
    sem, off = inp["sem"][lo:hi].to(dev), inp["off"][lo:hi].to(dev)

    keys, _, nvox, _ = prepare_input_grid(sub.points, sub.point_mask, cfg)
    hier = build_hierarchy(keys, nvox, cfg.input_capacities(), extent=cfg.input_grid_extent)
    rows = phase_train_kernels(train_conv_shapes(cfg, hier, proposal_geometry(cfg, sub, sem, off)),
                               tag=f"{tag} kernel", timed=False)
    err = {k: max(r[k]["max_abs_err"] for r in rows) for k in ("fwd", "dgrad", "wgrad")}

    model = make_model(cfg, dev, seed=0).train()
    opt = adam(model.named_parameters(), 1e-3)
    gen = torch.Generator().manual_seed(0)

    def step():
        return train_step(model, opt, sub, gen, True, True, True,
                          cluster_sem_override=sem, cluster_offset_override=off)

    first = step()
    # the step's losses of the whole batch: the sum of the ranks' parts
    names = [k for k in first if k.startswith("loss/")]
    summed = pdist.all_reduce_(torch.stack([first[k] for k in names]))
    compared = None
    if rank == 0:
        compared = _check_dp_first_step(tag, dict(zip(names, summed.tolist())), model,
                                        torch.load(tmp / "reference.pt", weights_only=False))
    history = [first] + [step() for _ in range(DP_WARMUP_STEPS - 1)]
    torch.cuda.synchronize()

    calls = [0]
    all_reduce = dist.all_reduce

    def counted(*a, **kw):
        calls[0] += 1
        return all_reduce(*a, **kw)

    dist.all_reduce = counted
    reset_launches()
    times = []
    try:
        for _ in range(DP_TIMED_STEPS):
            t0 = time.perf_counter()
            history.append(step())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        dist.all_reduce = all_reduce
    launches = dict(LAUNCHES)
    want = {k: n * DP_TIMED_STEPS for k, n in LAUNCHES_PER_STEP.items()}
    if launches != want:
        raise AssertionError(f"{tag}: {DP_TIMED_STEPS} steps launched {launches}, expected {want}")
    for i, m in enumerate(history):
        bad = [k for k, v in m.items() if not bool(torch.isfinite(v))]
        nonzero = {k: float(v) for k, v in m.items() if k.startswith("counters/") and float(v)}
        if bad or nonzero:
            raise AssertionError(f"{tag} step {i + 1}: non-finite {bad}, counters {nonzero}")

    flat = torch.cat([t.detach().reshape(-1).view(torch.uint8)
                      for t in [*model.parameters(), *model.buffers()]])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    if not torch.equal(ref, flat):
        raise AssertionError(f"{tag}: parameters or buffers differ from rank 0's after "
                             f"{len(history)} steps")

    params = [p for group in opt.param_groups for p in group["params"]]
    grads = torch.cat([p.grad.reshape(-1) for p in params])
    event_ms, host_ms = [], []
    for _ in range(DP_ALLREDUCE_RUNS):
        buf = grads.clone()
        pdist.barrier()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        pdist.all_reduce_(buf)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
    q = _quantiles(times)
    print(f"[{tag}] B={DP_BATCH} ms per data-parallel step over {DP_TIMED_STEPS} steps: median "
          f"{q['median']:.3f}, p10 {q['p10']:.3f}, p90 {q['p90']:.3f} (two ranks share one card and "
          f"its host: not a scaling figure); {calls[0] // DP_TIMED_STEPS} all-reduces per step, "
          f"{grads.numel() * grads.element_size()} gradient bytes per step; gradient all-reduce "
          f"alone {statistics.median(event_ms):.3f} ms (CUDA events; host {statistics.median(host_ms):.3f})"
          f"; launches {launches}; counters 0; bitwise equal to rank 0")
    return dict(ms=times, median_ms=q["median"], p10_ms=q["p10"], p90_ms=q["p90"],
                allreduces_per_step=calls[0] / DP_TIMED_STEPS,
                grad_bytes=grads.numel() * grads.element_size(),
                allreduce_ms=statistics.median(event_ms),
                allreduce_host_ms=statistics.median(host_ms), launches=launches,
                max_abs_err=err, first_step=compared,
                losses_first={k: float(v) for k, v in zip(names, summed.tolist())})


def _dp_fit_rank(rank, dev, tmp):
    """Part (b) on one rank: trainer.fit on the cut dataset, recording this
    rank's file shards, its train steps and eval forwards, and every
    metric dict the trainer logs (rank 0 writes it; every rank holds it)."""
    from gapartnet_tpu_torch.ops.subm_conv import LAUNCHES, reset_launches
    from gapartnet_tpu_torch.train import trainer

    cfg = fit_config(tmp / "fitdata", tmp / f"fit_rank{rank}", extra=DP_FIT_OVERRIDES)
    seen = dict(paths={}, logged=[])
    build, log = trainer.build_datasets, trainer.MetricLogger.log

    def record_build(*a, **kw):
        datasets = build(*a, **kw)
        seen["paths"] = {k: [Path(p).name for p in ds.paths] for k, ds in datasets.items()}
        return datasets

    def record_log(self, metrics, step):
        seen["logged"].append(dict(metrics, step=step))
        return log(self, metrics, step)

    trainer.build_datasets, trainer.MetricLogger.log = record_build, record_log
    reset_launches()
    try:
        with FitProbe() as probe:
            trainer.fit(cfg, device=dev)
    finally:
        trainer.build_datasets, trainer.MetricLogger.log = build, log
    _check_launches(f"dp rank {rank} fit step", probe.steps, lambda r: LAUNCHES_PER_STEP)
    _check_launches(f"dp rank {rank} fit eval forward", probe.evals, lambda r: EVAL_FORWARD_LAUNCHES)
    print(f"[dp rank {rank} fit] {len(probe.steps)} steps: "
          + ", ".join(f"{r['ms']:.3f}" for r in probe.steps) + f" ms; {len(probe.evals)} eval "
          f"forwards; train shard {len(seen['paths']['train'])} clouds")
    return dict(seen, steps=len(probe.steps), step_ms=[r["ms"] for r in probe.steps],
                evals=len(probe.evals), launches=dict(LAUNCHES),
                model=repr(cfg.model))


def dp_rank(rank, world, device, tmp):
    """One rank of phase 10, in a spawned process: a gloo group over a file
    store in `tmp` on `device`, then parts (a) and (b); the results go to
    tmp/rank<r>.json.  Any failure raises (and the parent's spawn kills the
    other rank)."""
    import datetime

    import torch
    import torch.distributed as dist

    from gapartnet_tpu_torch.entry import use_fp32_math

    tmp = Path(tmp)
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    use_fp32_math()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    try:
        res = dict(step=_dp_step_rank(rank, dev, tmp), fit=_dp_fit_rank(rank, dev, tmp))
    finally:
        dist.destroy_process_group()
    (tmp / f"rank{rank}.json").write_text(json.dumps(res))


def phase_dp(cfg, batch, cluster_sem, cluster_off, smi):
    """The sixth slice: data-parallel training, two gloo ranks on the one
    card.  Returns the per-rank numbers for the kernel line."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="gapartnet_dp_") as tmp:
        tmp = Path(tmp)
        dp_reference(cfg, batch, cluster_sem, cluster_off, tmp / "reference.pt")
        torch.save(dict(cfg=cfg, batch=batch.to("cpu"), sem=cluster_sem.cpu(),
                        off=cluster_off.cpu()), tmp / "inputs.pt")
        write_fit_dataset(tmp / "fitdata", train_clouds=DP_FIT_TRAIN_CLOUDS)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mp.spawn(dp_rank, args=(DP_WORLD, "cuda:0", str(tmp)), nprocs=DP_WORLD, join=True)
        print(f"[dp] {DP_WORLD} ranks on one card: {time.perf_counter() - t0:.1f} s")
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(DP_WORLD)]

        fits = [r["fit"] for r in ranks]
        for split in fits[0]["paths"]:
            shards = [set(f["paths"][split]) for f in fits]
            files = {p.name for p in (tmp / "fitdata" / split / "pth").iterdir()}
            if set.intersection(*shards) or set.union(*shards) != files:
                raise AssertionError(f"dp fit: {split} shards {shards} are not a partition of {files}")
        steps = [f["steps"] for f in fits]
        if steps != [DP_FIT_STEPS] * DP_WORLD:
            raise AssertionError(f"dp fit: steps per rank {steps}, expected {DP_FIT_STEPS} on each")
        logged = [[{k: v for k, v in m.items() if k != "epoch_time_s"} for m in f["logged"]]
                  for f in fits]
        if any(lg != logged[0] for lg in logged) or len(logged[0]) != 2:
            raise AssertionError(f"dp fit: the ranks logged different metrics: {logged}")
        if any(f["model"] != fits[0]["model"] for f in fits):
            raise AssertionError("dp fit: the ranks built different model configs")
        wrote = [sorted(p.name for p in (tmp / f"fit_rank{r}").rglob("*"))
                 if (tmp / f"fit_rank{r}").exists() else [] for r in range(DP_WORLD)]
        if any(wrote[1:]) or "metrics.jsonl" not in wrote[0] or "last" not in wrote[0]:
            raise AssertionError(f"dp fit: files written per rank {wrote}")
        written = _metric_lines(tmp / "fit_rank0" / "metrics.jsonl")
        if [{k: v for k, v in m.items() if k != "epoch_time_s"} for m in written] != logged[0]:
            raise AssertionError("dp fit: metrics.jsonl differs from the logged metrics")
        dps = [r["step"] for r in ranks]
        print(f"[dp] ms per data-parallel step per rank (B={DP_BATCH}, {DP_TIMED_STEPS} steps; two "
              f"ranks share one card and its host: not a scaling figure): median "
              f"{[round(r['median_ms'], 3) for r in dps]}, p10 "
              f"{[round(r['p10_ms'], 3) for r in dps]}, p90 {[round(r['p90_ms'], 3) for r in dps]}"
              f"; all-reduces per step {dps[0]['allreduces_per_step']:g}, gradient bytes per step "
              f"{dps[0]['grad_bytes']}, gradient all-reduce alone "
              f"{[round(r['allreduce_ms'], 3) for r in dps]} ms; first step vs the one-process "
              f"step: gradients {dps[0]['first_step']['worst_grad']:.3f} of the allowance, "
              f"running statistics {dps[0]['first_step']['worst_stats']:.3e} of scale  ({smi})")
        print(f"[dp fit] shards {[{s: len(p) for s, p in f['paths'].items()} for f in fits]} "
              f"(disjoint, covering); {steps} steps (the fewer full batches of {DP_BATCH}); both "
              f"ranks logged the same {len(logged[0])} lines; rank 0 alone wrote {wrote[0]}; "
              f"train_loss/total_loss {logged[0][0]['train_loss/total_loss']:.4f}  ({smi})")
    return ranks


@contextlib.contextmanager
def bn_ulp_probe(seed):
    """Within the block every MaskedBatchNorm output of the port moves by a
    seeded -1, 0 or +1 fp32 ulp of its magnitude (another fp32 rounding,
    as a fused multiply-add or a sum in another order gives)."""
    import torch

    from gapartnet_tpu_torch.models import norm

    gen = torch.Generator().manual_seed(seed)
    orig = norm.MaskedBatchNorm.forward

    def moved(self, x, mask=None):
        y = orig(self, x, mask)
        r = torch.randint(-1, 2, y.shape, generator=gen).to(device=y.device, dtype=y.dtype)
        return y + r * torch.finfo(torch.float32).eps * y.abs().detach()

    norm.MaskedBatchNorm.forward = moved
    try:
        yield
    finally:
        norm.MaskedBatchNorm.forward = orig


def _bf16_err(got, want):
    """max over elements of |got - want| - (one bf16 ulp of |want|), and
    max|want|: a result rounded to bf16 may sit one ulp from the plain
    version's where their fp32 sums round apart."""
    import torch

    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -126))) - 7)
    return float(((got - want).abs() - ulp).clamp(min=0).max()), float(want.abs().max())


def bf16_bytes(kind, b, v, cin, cout):
    """Bytes a bf16 kernel must move: its inputs as it reads them (the bf16
    operand copies, rows padded to 8 channels, and the int32 neighbour
    table) once, its f32 output once."""
    p8 = lambda c: -(-c // 8) * 8  # noqa: E731
    nbr = 4 * 27 * b * v
    if kind == "fwd_bf16":
        return 2 * b * v * p8(cin) + nbr + 2 * 27 * cin * cout + 4 * b * v * cout
    if kind == "dgrad_bf16":
        return 2 * b * v * p8(cout) + nbr + 2 * 27 * cin * cout + 4 * b * v * cin
    return 2 * b * v * (p8(cin) + p8(cout)) + nbr + 4 * 27 * cin * cout


def bf16_read_bytes(kind, b, v, cin, cout):
    """Bytes a bf16 call moves as it now reads its inputs: the fp32 rows
    and weights the network holds (each once; no bf16 operand copy), the
    int32 neighbour table once, its f32 output once.  Printed beside
    `bf16_bytes`, which stays the (stricter) bound."""
    nbr = 4 * 27 * b * v
    if kind == "fwd_bf16":
        return 4 * b * v * cin + nbr + 4 * 27 * cin * cout + 4 * b * v * cout
    if kind == "dgrad_bf16":
        return 4 * b * v * cout + nbr + 4 * 27 * cin * cout + 4 * b * v * cin
    return 4 * b * v * (cin + cout) + nbr + 4 * 27 * cin * cout


KERNEL_COUNT_CALLS = 10


def kernels_per_call(fn):
    """The CUDA kernels one call of `fn()` launches, as torch.profiler
    records them over KERNEL_COUNT_CALLS calls: the most over
    PROFILE_WINDOWS windows (a window now and then loses kernels, never adds
    them), up to twice as many more while none has seen a kernel; None if
    none did."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most = 0
    for window in range(3 * PROFILE_WINDOWS):
        if window >= PROFILE_WINDOWS and most:
            break
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(KERNEL_COUNT_CALLS):
                fn()
            torch.cuda.synchronize()
        most = max(most, sum(e.count for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA))
    return most / KERNEL_COUNT_CALLS if most else None


def bf16_launches_expected(sc, kind, b, v, cin, cout):
    """Kernels a bf16 call may launch by its plan: one, or two with a tap
    split or a row-chunk sum.  None for a port without the plans."""
    if not hasattr(sc, "bf16_forward_plan"):
        return None
    import torch

    sms = sc._sm_count(torch.cuda.current_device())
    if kind == "wgrad_bf16":
        return 1 + (sc.bf16_wgrad_plan(b, v, cin, cout, sms)["chunks"] > 1)
    k, n = (cin, cout) if kind == "fwd_bf16" else (cout, cin)
    return 1 + (sc.bf16_forward_plan(b, v, k, n, sms)["splits"] > 1)


def phase_bf16_kernels(shapes, kinds, tag, timed=True):
    """The bf16 kernels of `kinds` against their plain versions at every
    shape of `shapes` (train_conv_shapes' dicts), each run twice and held
    bitwise equal; when `timed`, CUDA-event medians of kernel and plain and
    the kernel's device time per launch (profiler, median of three
    windows).  Returns the rows."""
    import torch

    from gapartnet_tpu_torch.ops import subm_conv as sc

    gen = torch.Generator(device="cuda").manual_seed(5678)
    rows = []
    for sh in shapes:
        nbr, cin, cout = sh["nbr"], sh["cin"], sh["cout"]
        b, _, v = nbr.shape
        x = torch.randn((b, v, cin), generator=gen, device="cuda")
        w = torch.randn((27, cin, cout), generator=gen, device="cuda") / (27 * cin) ** 0.5
        g = torch.randn((b, v, cout), generator=gen, device="cuda")
        calls = {
            "fwd_bf16": (lambda: sc.subm_conv_forward_bf16(x, nbr, w),
                         lambda: sc.subm_conv_bf16_reference(x, nbr, w), KERNEL_RTOL, False),
            "dgrad_bf16": (lambda: sc.subm_conv_dgrad_bf16(g, nbr, w),
                           lambda: sc.subm_conv_dgrad_bf16_reference(g, nbr, w), KERNEL_RTOL, True),
            "wgrad_bf16": (lambda: sc.subm_conv_wgrad_bf16(x, nbr, g),
                           lambda: sc.subm_conv_wgrad_bf16_reference(x, nbr, g), WGRAD_RTOL, True),
        }
        pairs = int((nbr >= 0).sum())
        flops = 2 * cin * cout * pairs
        row = dict(net=sh["net"], level=sh["level"], cin=cin, cout=cout, B=b, V=v, pairs=pairs,
                   per_step=sh["per_step"], flops=flops)
        for kind in kinds:
            kernel, plain, rtol, rounded = calls[kind]
            got, ref = kernel(), plain()
            again = kernel()
            torch.cuda.synchronize()
            if rounded:
                err, scale = _bf16_err(got, ref)
            else:
                err, scale = float((got - ref).abs().max()), float(ref.abs().max())
            if not err <= rtol * scale:
                raise AssertionError(
                    f"{kind} disagrees at {sh['net']} level {sh['level']} ({cin}->{cout}, "
                    f"V={v}): max|d|{' beyond one bf16 ulp' if rounded else ''} {err} > "
                    f"{rtol} * max|ref| {scale}")
            if not torch.equal(got, again):
                raise AssertionError(f"{kind} not bitwise repeatable at {cin}->{cout}, V={v}")
            nbytes = bf16_bytes(kind, b, v, cin, cout)
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
            want_launches = bf16_launches_expected(sc, kind, b, v, cin, cout)
            launched = kernels_per_call(kernel)
            # more kernels than the plan's would be an operand copy or a
            # fallback; fewer only a window that lost some
            if want_launches is not None and launched is not None and launched > want_launches:
                raise AssertionError(
                    f"{kind} at {cin}->{cout}, V={v}: {launched} kernels per call, its plan "
                    f"launches {want_launches} (no operand copy)")
            row[kind] = dict(max_abs_err=err, max_ref=scale, bytes=nbytes, bound_ms=bound_ms,
                             bound_by=bound_by, read_bytes=bf16_read_bytes(kind, b, v, cin, cout),
                             kernels_per_call=launched)
            if timed:
                row[kind].update(ms=cuda_ms(kernel, TIMED_LAUNCHES),
                                 device_ms=device_ms(kernel, TIMED_LAUNCHES, KERNEL_NAMES[kind]),
                                 plain_ms=cuda_ms(plain, TIMED_LAUNCHES))
        rows.append(row)
        print(f"[{tag}] {sh['net']:<8} level {sh['level']} {cin:>3}->{cout:<3} B={b} V={v:<6} "
              f"pairs={pairs:<8} " + "  ".join(
                  f"{k} x{sh['per_step'][k]} "
                  + (f"{row[k]['ms']:.4f}/{_fmt(row[k]['device_ms'])}/{row[k]['plain_ms']:.4f} ms "
                     + (f"(x{row[k]['device_ms'] / row[k]['bound_ms']:.1f} the bound) "
                        if row[k]["device_ms"] else "") if timed else "")
                  + f"bound {row[k]['bound_ms']:.4f} ({row[k]['bound_by']}; reads "
                  f"{row[k]['read_bytes'] / 1e6:.2f} MB, kernels per call "
                  f"{_fmt_count(row[k]['kernels_per_call'])}) "
                  f"d {row[k]['max_abs_err']:.1e}/{row[k]['max_ref']:.1e}" for k in kinds)
              + ("  (call/device/plain; bitwise repeatable)" if timed else "  (bitwise repeatable)"))
    for kind in kinds:
        if hasattr(sc, "bf16_forward_plan") and all(r[kind]["kernels_per_call"] is None
                                                    for r in rows):
            raise AssertionError(f"{kind}: the profiler saw no kernel at any shape, so the "
                                 f"launches per call are not shown")
    return rows


def interleaved(tag, fns, n, smi):
    """{name: median ms} of the callables in `fns`, called in turns n times
    each after one warm-up each (host clock, each call ending in a
    synchronize): an A/B within one stretch of the call, so that the
    host's drift over the call falls on both alike."""
    import torch

    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(n):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"[{tag}] in turns, {n} calls each: " + ", ".join(
        f"{k} median {m:.3f} ms (p10 {statistics.quantiles(times[k], n=10)[0]:.3f}, p90 "
        f"{statistics.quantiles(times[k], n=10)[-1]:.3f})" for k, m in med.items()) + f"  ({smi})")
    return med


BF16_KINDS = ("fwd_bf16", "dgrad_bf16", "wgrad_bf16")


def bf16_inference_shapes(cfg, hierarchy):
    """The bf16 forward's shapes of one bare forward: every backbone conv of
    `hierarchy` with its launches per forward."""
    return [dict(net="backbone", level=li, cin=cin, cout=cout, nbr=hierarchy.levels[li].subm_nbr,
                 per_step={"fwd_bf16": per})
            for li, cin, cout, per in backbone_conv_shapes(cfg.channels)]


def bf16_train_shapes(shapes):
    """train_conv_shapes' dicts with the bf16 counters' names."""
    return [dict(sh, per_step={f"{k}_bf16": n for k, n in sh["per_step"].items()})
            for sh in shapes]


def kernel_sums(tag, rows, kinds, what, smi):
    """Prints and returns {kind: (device ms, call ms)} summed over `rows`
    weighted by their launches (per step, or per forward)."""
    sums = {}
    for kind in kinds:
        per = [(r[kind], r["per_step"][kind]) for r in rows if r["per_step"].get(kind)]
        dev = _weighted([dict(k, per=n) for k, n in per], "device_ms", "per")
        call = sum(k["ms"] * n for k, n in per)
        sums[kind] = (dev, call)
    print(f"[{tag}] {what}: " + ", ".join(
        f"{k} device {_fmt(d)} ms, call {c:.4f} ms" for k, (d, c) in sums.items()) + f"  ({smi})")
    return sums


def phase_bf16(fp32_forward_ms, smi):
    """Phase 11: bf16 conv compute, bench.py's configuration
    (GAPartNetConfig(conv_compute_dtype="bfloat16")), on the card.

    The bf16 forward, dgrad and wgrad kernels against their plain versions
    at every backbone shape of bench_cloud_setup and every training shape
    of train_setup at bf16; the bare forward (5 warm-ups, 20 timed, 53
    fwd_bf16 launches each and no fp32 one, zero counters, a profile), and
    in turns with the fp32 forward;
    the same forward on the CPU at B = 1 (integers exactly, floats within
    the probes' allowance); train_step at B = 8 (3 warm-ups, 10 timed,
    77 / 76 / 77 bf16 launches, zero counters, moving losses, a profile),
    and in turns with the fp32 step;
    one card step against the CPU step at B = 2 (phase 6's allowance and
    the bf16 terms).  Returns the numbers for the kernel line."""
    import torch

    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.entry import bench_cloud_setup, make_model, train_setup
    from gapartnet_tpu_torch.models.gapartnet import prepare_input_grid
    from gapartnet_tpu_torch.ops.sparse_conv import build_hierarchy
    from gapartnet_tpu_torch.train.loop import adam, train_step

    t = time.perf_counter()
    bf16 = GAPartNetConfig(conv_compute_dtype="bfloat16")
    cfg, batch, sem, off = bench_cloud_setup(bf16, device="cuda")
    keys, _, nvox, _ = prepare_input_grid(batch.points, batch.point_mask, cfg)
    hier = build_hierarchy(keys, nvox, cfg.input_capacities(), extent=cfg.input_grid_extent)
    inf_rows = phase_bf16_kernels(bf16_inference_shapes(cfg, hier), ("fwd_bf16",), "bf16 kernel")
    tcfg, tbatch, tsem, toff = train_setup(bf16, batch_size=TRAIN_BATCH, device="cuda")
    tkeys, _, tnvox, _ = prepare_input_grid(tbatch.points, tbatch.point_mask, tcfg)
    thier = build_hierarchy(tkeys, tnvox, tcfg.input_capacities(), extent=tcfg.input_grid_extent)
    shapes = bf16_train_shapes(
        train_conv_shapes(tcfg, thier, proposal_geometry(tcfg, tbatch, tsem, toff)))
    train_rows = phase_bf16_kernels(shapes, BF16_KINDS, "bf16 train kernel")
    t = lap("phase 11a (bf16 kernels vs plain)", t)

    model, out, launches, times = phase_forward(cfg, batch, sem, off, smi, kind="fwd_bf16",
                                                tag="bf16 forward")
    med = statistics.median(times)
    print(f"[bf16 forward] median {med:.3f} ms per cloud, {1e3 / med:.2f} clouds/s "
          f"(bench.py's e2e_inference_throughput at its configuration); the fp32 forward in "
          f"this run (phase 3): median {fp32_forward_ms:.3f} ms  ({smi})")
    phase_profile(lambda: run_forward(model, batch, sem, off), med, tag="bf16 profile")
    model32 = make_model(dataclasses.replace(cfg, conv_compute_dtype="float32"), "cuda", seed=0)
    ab_forward = interleaved("bf16 vs fp32 forward", {
        "fp32": lambda: run_forward(model32, batch, sem, off),
        "bf16": lambda: run_forward(model, batch, sem, off)}, AB_CALLS, smi)
    del model32
    phase_compare(cfg, batch, sem, off, model, out, probes=NET_PROBES)
    t = lap("phase 11b (bf16 forward, vs CPU)", t)

    step, train_launches, step_times = phase_train(tcfg, tbatch, tsem, toff, smi,
                                                   per_step=BF16_LAUNCHES_PER_STEP, tag="bf16 train")
    phase_profile(step, statistics.median(step_times), tag="bf16 train profile",
                  what=f"one bf16 train step (B={TRAIN_BATCH})")
    model32 = _train_model(dataclasses.replace(tcfg, conv_compute_dtype="float32"))
    opt32, gen32 = adam(model32.named_parameters(), 1e-3), torch.Generator().manual_seed(0)
    ab_step = interleaved("bf16 vs fp32 train step", {
        "fp32": lambda: train_step(model32, opt32, tbatch, gen32, True, True, True,
                                   cluster_sem_override=tsem, cluster_offset_override=toff),
        "bf16": step}, AB_STEPS, smi)
    del step, model32, opt32
    torch.cuda.empty_cache()
    phase_train_compare(tcfg, tbatch, tsem, toff, runs=1, tag="bf16 train compare")
    lap("phase 11c (bf16 training, vs CPU)", t)
    return dict(inf_rows=inf_rows, train_rows=train_rows, forward_launches=launches,
                forward_ms=med, train_launches=train_launches,
                step_ms=statistics.median(step_times), ab_forward=ab_forward, ab_step=ab_step)


def bf16_kernel_entries(numbers, tools=None, sustained=None):
    """The bf16 kernels' entries of the kernel line, with phase 11's
    numbers: launches in its timed train steps (the forward's also in its
    timed bare forwards), times summed over one B = 8 train step, bounds at
    the bf16 peak; with `tools` (phase 14), the forward's launches in
    eval_parity --bf16 added; with `sustained` (phase 15), each kernel's
    launches in the sustained run and its diagnostics added."""
    rows = numbers["train_rows"]
    sources = {
        "fwd_bf16": ("subm_conv_bf16", "gapartnet_tpu_torch/csrc/subm_conv_bf16.cu",
                     "gapartnet_tpu/ops/pallas_conv.py:32", "gapartnet_tpu/ops/sparse_conv.py:250"),
        "dgrad_bf16": ("subm_conv_dgrad_bf16", "gapartnet_tpu_torch/csrc/subm_conv_bf16.cu",
                       "gapartnet_tpu/ops/pallas_conv.py:95", "gapartnet_tpu/ops/sparse_conv.py:286"),
        "wgrad_bf16": ("subm_conv_wgrad_bf16", "gapartnet_tpu_torch/csrc/subm_conv_wgrad_bf16.cu",
                       "gapartnet_tpu/ops/pallas_conv.py:105", "gapartnet_tpu/ops/sparse_conv.py:297"),
    }
    entries = []
    for kind, (name, source, replaces, reference) in sources.items():
        per = [(r, r["per_step"][kind]) for r in rows if r["per_step"][kind]]
        flops = sum(r["flops"] * n for r, n in per)
        nbytes = sum(r[kind]["bytes"] * n for r, n in per)
        bound, by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "reference": reference, "launches": numbers["train_launches"][kind],
            "max_abs_err": max(r[kind]["max_abs_err"] for r, _ in per),
            "ms": sum(r[kind]["ms"] * n for r, n in per),
            "device_ms": _weighted([dict(r[kind], per=n) for r, n in per], "device_ms", "per"),
            "plain_ms": sum(r[kind]["plain_ms"] * n for r, n in per),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "per_step": BF16_LAUNCHES_PER_STEP[kind],
            "work": f"the {BF16_LAUNCHES_PER_STEP[kind]} {kind} launches of one B = {TRAIN_BATCH} "
                    f"train step at bf16 ({TIMED_STEPS} steps counted)",
            "shapes": [{"net": r["net"], "level": r["level"], "cin": r["cin"], "cout": r["cout"],
                        "B": r["B"], "V": r["V"], "pairs": r["pairs"], "per_step": n,
                        **{k: r[kind][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms")}}
                       for r, n in per],
        }
        if kind == "fwd_bf16":
            inf = numbers["inf_rows"]
            iflops = sum(r["flops"] * r["per_step"][kind] for r in inf)
            ibytes = sum(r[kind]["bytes"] * r["per_step"][kind] for r in inf)
            ib, iby = _bound(iflops, ibytes, PEAK_BF16_FLOPS)
            entry["max_abs_err"] = max(entry["max_abs_err"], max(r[kind]["max_abs_err"] for r in inf))
            entry["inference"] = {
                "launches": numbers["forward_launches"],
                "ms": sum(r[kind]["ms"] * r["per_step"][kind] for r in inf),
                "device_ms": _weighted([dict(r[kind], per=r["per_step"][kind]) for r in inf],
                                       "device_ms", "per"),
                "plain_ms": sum(r[kind]["plain_ms"] * r["per_step"][kind] for r in inf),
                "bound_ms": ib, "bound_by": iby, "forward_ms": numbers["forward_ms"],
                "forward_ms_in_turns": numbers["ab_forward"],
                "step_ms": numbers["step_ms"], "step_ms_in_turns": numbers["ab_step"],
                "work": f"the 53 backbone convs of one bench-cloud forward at bf16 (B = 1; "
                        f"{TIMED_REQUESTS} forwards counted)",
            }
            if tools is not None:
                entry["phase14"] = tools_entry(tools, kind)
                entry["launches"] += tools["launches"][kind]
                entry["max_abs_err"] = max(entry["max_abs_err"], tools["max_abs_err"][kind])
        if sustained is not None:
            entry["phase15"] = sustained_entry(sustained, kind)
            entry["launches"] += sustained["launches"][kind]
            entry["max_abs_err"] = max(entry["max_abs_err"], sustained["max_abs_err"][kind])
        entries.append(entry)
    return entries


def sustained_entry(sustained, kind):
    """Phase 15's part of a bf16 kernel's entry: its launches in the
    sustained run (per train step of each phase, per eval forward) and in
    the diagnostics, and the run's times."""
    return {
        "launches": sustained["launches"][kind],
        "per_step": {"phase_a": SUSTAINED_LAUNCHES_PER_STEP[False][kind],
                     "phase_b_frozen": SUSTAINED_LAUNCHES_PER_STEP[True][kind]},
        "per_eval_forward": SUSTAINED_EVAL_LAUNCHES[kind],
        "steps": {"phase_a": sustained["steps"][False], "phase_b": sustained["steps"][True]},
        "max_abs_err": sustained["max_abs_err"][kind],
        "work": "tools/sustained_run --two-phase --freeze-trunk-b --sem-alpha auto --add-zoom at "
                f"B = {SUSTAINED_BATCH} on 10 distant and 2 close-up rendered views (phase A "
                f"{SUSTAINED_EPOCHS_A} epochs, phase B {SUSTAINED_EPOCHS_B}, a validation each, "
                "two tests); confusion_diag, proposal_diag, margin_diag and a "
                f"{VALLEY_EPOCHS}-epoch valley_probe on its checkpoints",
    }


# phase 12: the model's other two configurations.  12a: exact clustering
# (the reference's first-K ball query and list CCL) at B = 1, in turns with
# the hash forward; 12b: the PointNet backbone's train step at B = 8, whose
# only subm convs are the two proposal UNets' 12 + 12 (each with a dgrad:
# their input, the backbone's features, needs a gradient)
EXACT_WARMUPS = 3
EXACT_FORWARDS = 20
EXACT_CALL_RUNS = 5
EXACT_PREDICTS = 3
POINTNET_WARMUPS = 2
POINTNET_STEPS = 10
POINTNET_LAUNCHES_PER_STEP = launch_counts(fwd=24, dgrad=24, wgrad=24)


def _ulps(d2, r2):
    """(d2 - r2) in float32 ulps of r2."""
    import numpy as np

    return (np.float64(d2) - np.float64(r2)) / float(np.spacing(np.float32(r2)))


def _check_neighbours(name, got, want, pts, radius):
    """Card and CPU neighbour lists equal; on a difference, print each
    differing pair's d2 - r2 in ulps (the JAX rounding, ops/ball_query.
    fma_sq_dist) before failing."""
    import numpy as np
    import torch

    from gapartnet_tpu_torch.ops.ball_query import JAX_QUERY_BLOCK, fma_sq_dist

    g, w = got.cpu(), want.cpu()
    if torch.equal(g, w):
        return
    rows = (g != w).any(dim=1).nonzero()[:, 0][:10]
    r2 = np.float32(radius * radius)
    p = pts.cpu()
    for q in rows.tolist():
        pairs = sorted(set(g[q].tolist()) ^ set(w[q].tolist()) - {-1})
        d2 = fma_sq_dist(p[q:q + 1], p[pairs], y_first=len(p) <= JAX_QUERY_BLOCK)[0]
        print(f"[exact ops] {name}: query {q} differs at points {pairs}, d2 - r2 in ulps "
              f"{[round(_ulps(v, r2), 2) for v in d2.tolist()]}")
    raise AssertionError(f"{name}: card and CPU neighbour lists differ at {int((g != w).any(1).sum())}"
                         " queries")


def phase_exact_ops(cfg, batch, cluster_sem, cluster_off, smi):
    """The ball query and the CCL of both clustering sets of the forward
    (cloud 0 under the overrides), alone: ms per call (CUDA events, median
    of EXACT_CALL_RUNS), kernel ms and launches (profiler), tiles, exactly
    decided pairs and CCL iterations (each one host sync); then the same on
    the CPU: neighbour lists, counts and labels exactly.  The search runs
    over the valid (foreground) points only, so each set is also timed with
    every point valid (4e8 pairs, the load of a forward whose sem head marks
    all points foreground).  Returns the rows."""
    import torch

    from gapartnet_tpu_torch.ops import ball_query as bq
    from gapartnet_tpu_torch.ops import ccl

    xyz = batch.points[0, :, :3]
    sem = cluster_sem[0].to(torch.int32)
    valid = (sem > 0) & batch.point_mask[0]
    rows = {}
    for name, pts, k in (("xyz", xyz, cfg.max_num_points_per_query),
                         ("xyz+offsets", xyz + cluster_off[0], cfg.max_num_points_per_query_shift)):
        def query():
            return bq.ball_query_single(pts, sem, valid, cfg.ball_query_radius, k)

        bq.STATS.update(calls=0, tiles=0, exact_pairs=0)
        nbr, cnt = query()
        torch.cuda.synchronize()
        stats = dict(bq.STATS)
        ccl.STATS.update(calls=0, iterations=0)
        lab = ccl.connected_components_single(nbr, valid)
        torch.cuda.synchronize()
        iters = ccl.STATS["iterations"]

        def label():
            return ccl.connected_components_single(nbr, valid)

        row = dict(k=k, tiles=stats["tiles"], exact_pairs=stats["exact_pairs"], ccl_iterations=iters,
                   bq_ms=cuda_ms(query, EXACT_CALL_RUNS), ccl_ms=cuda_ms(label, EXACT_CALL_RUNS))
        row["bq_device_ms"], row["bq_kernels"] = busy_ms(query)
        row["ccl_device_ms"], row["ccl_kernels"] = busy_ms(label)
        everyone = batch.point_mask[0]

        def query_all():
            return bq.ball_query_single(pts, sem, everyone, cfg.ball_query_radius, k)

        bq.STATS.update(calls=0, tiles=0, exact_pairs=0)
        nbr_all, _ = query_all()
        row["all_valid"] = dict(tiles=bq.STATS["tiles"], bq_ms=cuda_ms(query_all, EXACT_CALL_RUNS))
        row["all_valid"]["bq_device_ms"], row["all_valid"]["bq_kernels"] = busy_ms(query_all)
        ccl.STATS.update(calls=0, iterations=0)
        row["all_valid"]["ccl_ms"] = cuda_ms(
            lambda: ccl.connected_components_single(nbr_all, everyone), EXACT_CALL_RUNS)
        row["all_valid"]["ccl_iterations"] = ccl.STATS["iterations"] // (EXACT_CALL_RUNS + 3)
        t0 = time.perf_counter()
        nbr_c, cnt_c = bq.ball_query_single(pts.cpu(), sem.cpu(), valid.cpu(), cfg.ball_query_radius, k)
        lab_c = ccl.connected_components_single(nbr_c, valid.cpu())
        row["cpu_s"] = time.perf_counter() - t0
        _check_neighbours(f"set {name}", nbr, nbr_c, pts, cfg.ball_query_radius)
        _check_equal(f"set {name}: neighbour counts", cnt, cnt_c)
        _check_equal(f"set {name}: CCL labels", lab, lab_c)
        hits = cnt.float()
        print(f"[exact ops] set {name}, K={k}: ball query {row['bq_ms']:.3f} ms per call (kernel "
              f"{_fmt(row['bq_device_ms'])} ms in {row['bq_kernels']} launches; {row['tiles']} tiles, "
              f"one host sync each; {row['exact_pairs']} pairs decided by the exact chain); "
              f"neighbours per point mean {float(hits[valid].mean()):.1f}, at the cap "
              f"{int((cnt == k).sum())}; CCL {row['ccl_ms']:.3f} ms per call (kernel "
              f"{_fmt(row['ccl_device_ms'])} ms in {row['ccl_kernels']} launches), {iters} "
              f"iterations (one host sync each), {len(torch.unique(lab[valid]))} components  ({smi})")
        a = row["all_valid"]
        print(f"[exact ops] set {name}, all {len(pts)} points valid: ball query {a['bq_ms']:.3f} ms "
              f"per call (kernel {_fmt(a['bq_device_ms'])} ms in {a['bq_kernels']} launches, "
              f"{a['tiles']} tiles); CCL {a['ccl_ms']:.3f} ms per call, {a['ccl_iterations']} "
              f"iterations  ({smi})")
        print(f"[exact ops] set {name}: CPU {row['cpu_s']:.1f} s; neighbour lists, counts, CCL labels "
              "identical to the card's")
        rows[name] = row
    return rows


def phase_exact(hash_cfg, hash_batch, hash_sem, hash_off, smi):
    """Phase 12a: GAPartNetConfig(clustering_impl="exact") on the bench
    cloud with the clustering overrides, capacities fitted
    (entry.bench_cloud_setup).  EXACT_WARMUPS forwards, then EXACT_FORWARDS
    in turns with the hash forward of phase 3's setup, each exact forward
    with the counts set to 0 just before and read just after (53 forward
    launches, 2 ball queries, 2 CCLs); zero counters; the ball query and
    the CCL alone (phase_exact_ops); the forward against the CPU (phase 4's
    rules); then EXACT_PREDICTS GAPartNetInference.predict requests at the
    eval capacities against the CPU (phase 7's rules).  Returns the numbers."""
    import torch

    from gapartnet_tpu_torch.config import GAPartNetConfig, eval_capacity_config
    from gapartnet_tpu_torch.entry import bench_cloud_setup, make_model
    from gapartnet_tpu_torch.ops import ball_query as bq
    from gapartnet_tpu_torch.ops import ccl
    from gapartnet_tpu_torch.ops.subm_conv import LAUNCHES, reset_launches

    t = time.perf_counter()
    cfg, batch, sem, off = bench_cloud_setup(GAPartNetConfig(clustering_impl="exact"), device="cuda")
    print(f"[exact] fitted to the exact clustering: max_proposals {cfg.max_proposals}, dense pool "
          f"{cfg.dense_grid_capacity} (hash setup: {hash_cfg.max_proposals}, "
          f"{hash_cfg.dense_grid_capacity}); setup {time.perf_counter() - t:.1f} s")
    model = make_model(cfg, "cuda", seed=0)
    model_h = make_model(hash_cfg, "cuda", seed=0)
    for _ in range(EXACT_WARMUPS):
        run_forward(model, batch, sem, off)
    run_forward(model_h, hash_batch, hash_sem, hash_off)
    torch.cuda.synchronize()
    times = {"exact": [], "hash": []}
    launches = launch_counts()
    bq_calls = ccl_calls = iters = 0
    for _ in range(EXACT_FORWARDS):
        reset_launches()
        bq.STATS.update(calls=0, tiles=0, exact_pairs=0)
        ccl.STATS.update(calls=0, iterations=0)
        t0 = time.perf_counter()
        out = run_forward(model, batch, sem, off)
        torch.cuda.synchronize()
        times["exact"].append((time.perf_counter() - t0) * 1e3)
        if LAUNCHES != launch_counts(fwd=CONVS_PER_FORWARD):
            raise AssertionError(f"exact forward: subm_conv launched {LAUNCHES}")
        if (bq.STATS["calls"], ccl.STATS["calls"]) != (2, 2):
            raise AssertionError(f"exact forward: {bq.STATS['calls']} ball queries, "
                                 f"{ccl.STATS['calls']} CCLs (expected 2 and 2)")
        launches["fwd"] += LAUNCHES["fwd"]
        bq_calls += bq.STATS["calls"]
        ccl_calls += ccl.STATS["calls"]
        iters += ccl.STATS["iterations"]
        t0 = time.perf_counter()
        run_forward(model_h, hash_batch, hash_sem, hash_off)
        torch.cuda.synchronize()
        times["hash"].append((time.perf_counter() - t0) * 1e3)
    counters = {k: int(v.sum()) for k, v in out.counters.items()}
    if any(counters.values()):
        raise AssertionError(f"exact forward: capacity counters nonzero: {counters}")
    for name in ("sem_logits", "offset_preds", "score_preds", "npcs_preds"):
        if not bool(torch.isfinite(getattr(out, name)).all()):
            raise AssertionError(f"exact forward: {name} has non-finite values")
    q = {k: _quantiles(v) for k, v in times.items()}
    print(f"[exact] ms per cloud, {EXACT_FORWARDS} each in turns (after {EXACT_WARMUPS} warm-ups): "
          + "; ".join(f"{k} median {v['median']:.3f}, p10 {v['p10']:.3f}, p90 {v['p90']:.3f}"
                      for k, v in q.items()) + f"  ({smi})")
    print(f"[exact] per forward: {launches['fwd'] // EXACT_FORWARDS} subm_conv fwd launches, "
          f"{bq_calls // EXACT_FORWARDS} ball queries, {ccl_calls // EXACT_FORWARDS} CCLs, "
          f"{iters / EXACT_FORWARDS:.1f} CCL iterations; proposals "
          f"{out.proposals.num_proposals.tolist()}; counters {counters}")
    ops = phase_exact_ops(cfg, batch, sem, off, smi)
    phase_compare(cfg, batch, sem, off, model, out)
    del model, model_h
    t = lap("phase 12a (exact forward, ball query and CCL, vs CPU)", t)

    pts, _ = bench_points()
    card, cpu = inference_pair(eval_capacity_config(GAPartNetConfig(clustering_impl="exact")))
    ptimes, plaunches = run_requests("exact predict", lambda: card.predict(pts), EXACT_PREDICTS, 1, smi)
    req, split = timed_request(card, pts)
    print(f"[exact predict] split (CUDA events; ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f"; proposals "
        f"{int(req.out.proposals.num_proposals[0])}, kept {int(req.keep.sum())}; counters "
        f"{ {k: int(v.sum()) for k, v in req.out.counters.items()} }")
    compare_requests("exact predict", req, cpu, pts)
    lap("phase 12a (exact predict, vs CPU)", t)
    return dict(forward_launches=launches, forward_ms=q["exact"], hash_forward_ms=q["hash"],
                ops=ops, predict_launches=plaunches, predict_ms=_quantiles(ptimes),
                ccl_iterations_per_forward=iters / EXACT_FORWARDS)


def phase_pointnet(tcfg, tbatch, tsem, toff, smi):
    """Phase 12b: GAPartNetConfig(backbone_type="PointNet") at phase 5's
    capacities and B = 8 batch: the forward, dgrad and wgrad kernels
    against their plain versions at the proposal UNets' shapes of this
    step; POINTNET_WARMUPS + POINTNET_STEPS train steps (24 / 24 / 24
    launches per step, zero counters, a profile); one B = 2 step against the
    CPU (phase 6's allowance); one B = 1 eval forward against the CPU
    (phase 4's rules, the bench cloud at its fitted capacities).  Returns
    the numbers."""
    import torch

    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.entry import bench_cloud_setup, make_model

    t = time.perf_counter()
    cfg = dataclasses.replace(tcfg, backbone_type="PointNet")
    shapes = train_conv_shapes(cfg, None, proposal_geometry(cfg, tbatch, tsem, toff))
    rows = phase_train_kernels(shapes, tag="pointnet train kernel", timed=False)
    step, launches, times = phase_train(cfg, tbatch, tsem, toff, smi,
                                        per_step=POINTNET_LAUNCHES_PER_STEP, tag="pointnet train",
                                        warmups=POINTNET_WARMUPS, steps=POINTNET_STEPS)
    phase_profile(step, statistics.median(times), tag="pointnet train profile",
                  what=f"one PointNet train step (B={tbatch.batch_size})")
    del step
    torch.cuda.empty_cache()
    phase_train_compare(cfg, tbatch, tsem, toff, runs=1, tag="pointnet train compare")
    t = lap("phase 12b (PointNet training, vs CPU)", t)
    ecfg, batch, sem, off = bench_cloud_setup(GAPartNetConfig(backbone_type="PointNet"),
                                              device="cuda")
    model = make_model(ecfg, "cuda", seed=0)
    out = run_forward(model, batch, sem, off)
    torch.cuda.synchronize()
    counters = {k: int(v.sum()) for k, v in out.counters.items()}
    if any(counters.values()):
        raise AssertionError(f"PointNet eval forward: capacity counters nonzero: {counters}")
    phase_compare(ecfg, batch, sem, off, model, out)
    lap("phase 12b (PointNet eval forward vs CPU)", t)
    return dict(train_launches=launches, step_ms=_quantiles(times),
                max_abs_err={k: max(r[k]["max_abs_err"] for r in rows)
                             for k in ("fwd", "dgrad", "wgrad")})


# phase 13, dataset generation -> predict_depth -> train steps (the tenth
# slice): the JAX defaults (800 x 800 views, 1,000,000 surface samples,
# 20000 points, GAPartNetConfig()), the three synthetic archetypes
DATAGEN_ASSETS = {"Box": 1, "Remote": 1, "Microwave": 1}
DATAGEN_SEED = 0
DATAGEN_VIEWS = 2                  # views ingested per asset, until DATAGEN_CLOUDS
DATAGEN_CLOUDS = 4
DATAGEN_BATCH = 4
DATAGEN_WARMUPS = 1
DATAGEN_STEPS = 3
DATAGEN_SPLIT_REQUESTS = 2
# the trace of one train step must name the fp32 subm-conv kernels
DATAGEN_TRACE_KERNELS = ("subm_conv_fwd_kernel", "subm_conv_wgrad_kernel")


def _same_npz(got_path, want_path):
    """Every array of two .npz files equal exactly (names, dtypes, values)."""
    import numpy as np

    got, want = np.load(got_path), np.load(want_path)
    if sorted(got.files) != sorted(want.files):
        raise AssertionError(f"{got_path}: arrays {sorted(got.files)} != {sorted(want.files)}")
    for k in want.files:
        if got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k]):
            diff = int((got[k] != want[k]).sum()) if got[k].shape == want[k].shape else "shape"
            raise AssertionError(f"{os.path.basename(str(got_path))}: {k} differs ({diff})")
    return sorted(want.files)


def datagen_batch(cfg, items, device="cuda"):
    """(cfg with capacities fitted to the clouds, batch, cluster_sem,
    cluster_off) from dataset items: train_setup's capacity rules (the
    maximum over the clouds) and its clustering overrides (ground-truth
    labels, offsets to the instance centres)."""
    import numpy as np
    import torch

    from gapartnet_tpu_torch.data.loader import collate
    from gapartnet_tpu_torch.entry import _fitted_capacities, _overrides, max_fitted
    from gapartnet_tpu_torch.structures import PointCloudBatch

    fitted, offsets = [], []
    for it in items:
        m = it["point_mask"]
        xyz, sem, ins = it["points"][m, :3], it["sem_labels"][m], it["instance_labels"][m]
        fields, centers = _fitted_capacities(cfg, xyz, sem, ins)
        fitted.append(fields)
        off = np.zeros((len(m), 3), np.float32)
        off[m] = _overrides(xyz, centers, ins)
        offsets.append(off)
    cfg = dataclasses.replace(cfg, **max_fitted(fitted))
    arrays = collate(items)
    batch = PointCloudBatch.from_numpy(arrays, device)
    cluster_sem = torch.as_tensor(np.where(arrays["point_mask"], arrays["sem_labels"], 0),
                                  device=device)
    return cfg, batch, cluster_sem, torch.as_tensor(np.stack(offsets), device=device)


def phase_datagen(smi, tmp):
    """Phase 13: generated assets -> SAPIEN-free renders -> predict_depth
    through the demo's --asset path -> ingested .npz clouds -> the native
    dataset -> train steps, timed by utils/profiling.StepTimer and traced
    by its maybe_trace, in the directory `tmp`.  Returns the numbers for
    the kernel line."""
    import numpy as np
    import torch

    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.data.loader import GAPartNetDataset
    from gapartnet_tpu_torch.datagen.assets import ingest_asset, render_asset_view, render_view_maps
    from gapartnet_tpu_torch.datagen.convert import backproject_labeled, fps_indices
    from gapartnet_tpu_torch.datagen.synthetic import generate_assets
    from gapartnet_tpu_torch.demo import asset_request
    from gapartnet_tpu_torch.infer.api import GAPartNetInference
    from gapartnet_tpu_torch.models.gapartnet import prepare_input_grid
    from gapartnet_tpu_torch.ops.sparse_conv import build_hierarchy
    from gapartnet_tpu_torch.ops.subm_conv import LAUNCHES, reset_launches
    from gapartnet_tpu_torch.train.loop import adam, train_step
    from gapartnet_tpu_torch.utils.profiling import StepTimer, device_memory_stats, maybe_trace

    cfg = GAPartNetConfig()
    num_points = cfg.max_points
    timer = StepTimer()
    t = time.perf_counter()

    # 13a: assets, one view of each, FPS on the card; one ingest card vs CPU
    dirs = generate_assets(str(Path(tmp) / "assets"), DATAGEN_ASSETS, seed=DATAGEN_SEED)
    fg, rejected = {}, 0
    for d in dirs:
        with timer.time(f"render {Path(d).name}"):
            maps = render_view_maps(d, seed=DATAGEN_SEED)
        pcs = backproject_labeled(maps["rgb"], maps["depth"], maps["sem"], maps["ins"],
                                  maps["npcs"], maps["K"])[0]
        fg[d] = len(pcs)
        if fg[d] < num_points:
            rejected += 1
            fps_ms = None
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx = fps_indices(pcs, num_points, device="cuda")
            fps_ms = (time.perf_counter() - t0) * 1e3
            if not (len(idx) == num_points == len(np.unique(idx))):
                raise AssertionError(f"{d}: FPS gave {len(np.unique(idx))} distinct of {len(idx)}")
        print(f"[datagen] {Path(d).name}: {maps['depth'].shape[1]}x{maps['depth'].shape[0]} view, "
              f"host render {timer.times[f'render {Path(d).name}'] * 1e3:.1f} ms, {fg[d]} foreground "
              f"pixels, {int((maps['ins'] >= 0).sum())} on {len(maps['link_to_inst'])} parts; FPS "
              f"{fg[d]} -> {num_points} on the card {_fmt(fps_ms)} ms  ({smi})")
    usable = [d for d in dirs if fg[d] >= num_points]
    if not usable:
        raise AssertionError(f"no view has {num_points} foreground pixels: {fg}")
    small = min(usable, key=fg.get)
    names = {}
    for dev in ("cuda", "cpu"):
        with timer.time(f"ingest one view, FPS on {dev}"):
            names[dev] = render_asset_view(small, str(Path(tmp) / f"view_{dev}"), seed=DATAGEN_SEED,
                                           num_points=num_points, device=dev)
    if names["cuda"] is None or names["cuda"] != names["cpu"]:
        raise AssertionError(f"render_asset_view of {small}: {names}")
    arrays = _same_npz(Path(tmp) / "view_cuda" / "pth" / f"{names['cuda']}.npz",
                       Path(tmp) / "view_cpu" / "pth" / f"{names['cpu']}.npz")
    print(f"[datagen] render_asset_view of {Path(small).name} ({fg[small]} foreground pixels): "
          f"FPS on the card and on the CPU give the same .npz, every array equal ({', '.join(arrays)}); "
          f"{timer.summary()['ingest one view, FPS on cuda']:.1f} ms with FPS on the card, "
          f"{timer.summary()['ingest one view, FPS on cpu']:.1f} ms on the CPU")
    t = lap("phase 13a (assets, renders, FPS, card vs CPU ingest)", t)

    # 13b: predict_depth on a rendered view through the demo's --asset path
    infer = GAPartNetInference(cfg, seed=0, auto_capacity=True, device="cuda")
    asset_request(infer, usable[0], DATAGEN_SEED)                   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    view = asset_request(infer, usable[0], DATAGEN_SEED)
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - t0) * 1e3
    depth_launches = dict(LAUNCHES)
    if depth_launches != launch_counts(fwd=CONVS_PER_FORWARD):
        raise AssertionError(f"the asset's predict_depth launched {depth_launches}, expected "
                             f"{CONVS_PER_FORWARD} forward launches")
    res = view["result"]
    if not (np.isfinite(res.npcs_map).all() and np.isfinite(res.proposal_scores).all()):
        raise AssertionError("the asset's predict_depth: non-finite outputs")
    maps = view["maps"]
    bgr = np.ascontiguousarray(maps["rgb"][..., ::-1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    infer.predict_depth(maps["depth"], maps["K"], bgr)
    torch.cuda.synchronize()
    depth_ms = (time.perf_counter() - t0) * 1e3
    print(f"[datagen depth] {Path(usable[0]).name}: render + predict_depth {request_ms:.1f} ms, "
          f"predict_depth alone {depth_ms:.1f} ms ({fg[usable[0]]} pixels, FPS to {num_points}); "
          f"{depth_launches['fwd']} subm_conv forward launches; sem agreement vs render labels "
          f"{view['agreement']:.3f} (random weights); {len(res.bboxes)} boxes  ({smi})")
    err = phase_api_kernels("datagen depth", infer, view["points"])
    _, split, device = report_split("datagen depth", infer, view["points"],
                                    requests=DATAGEN_SPLIT_REQUESTS)
    t = lap("phase 13b (predict_depth on a rendered view)", t)

    # 13c: ingested clouds -> the native dataset -> train steps
    root = Path(tmp) / "dataset" / "pth"
    ingested = []
    for d in dirs:
        if len(ingested) >= DATAGEN_CLOUDS:
            break
        with timer.time(f"ingest {Path(d).name}"):
            got = ingest_asset(d, str(root.parent), num_views=DATAGEN_VIEWS, seed=DATAGEN_SEED + 1,
                               num_points=num_points, device="cuda")
        rejected += DATAGEN_VIEWS - len(got)
        ingested += got
        print(f"[datagen ingest] {Path(d).name}: {len(got)} of {DATAGEN_VIEWS} views ingested in "
              f"{timer.summary()[f'ingest {Path(d).name}']:.1f} ms (render, FPS on the card, save)")
    if len(ingested) < DATAGEN_CLOUDS:
        raise AssertionError(f"only {len(ingested)} clouds ingested: {ingested}")
    print(f"[datagen ingest] {len(ingested)} clouds; views rejected for fewer than {num_points} "
          f"foreground pixels: {rejected}")
    with timer.time("load"):
        ds = GAPartNetDataset(str(root), max_points=num_points, max_instances=cfg.max_instances)
        items = [ds[i] for i in range(DATAGEN_BATCH)]
    plain = GAPartNetDataset(str(root), max_points=num_points, max_instances=cfg.max_instances,
                             native=False)
    for i, it in enumerate(items):
        if not 0 < it["num_instances"] < cfg.max_instances:
            raise AssertionError(f"{it['pc_id']}: {it['num_instances']} instances")
        want = plain[i]
        for k, v in want.items():
            if k != "pc_id" and not (np.asarray(it[k]).dtype == np.asarray(v).dtype
                                     and np.array_equal(it[k], v)):
                raise AssertionError(f"{it['pc_id']}: native {k} != the plain NumPy version's")
    print(f"[datagen data] {DATAGEN_BATCH} items through the native instance statistics in "
          f"{timer.summary()['load']:.1f} ms, equal to the plain NumPy version's; instances "
          f"{[int(it['num_instances']) for it in items]}")
    tcfg, batch, csem, coff = datagen_batch(cfg, items)
    tkeys, _, tnvox, _ = prepare_input_grid(batch.points, batch.point_mask, tcfg)
    thier = build_hierarchy(tkeys, tnvox, tcfg.input_capacities(), extent=tcfg.input_grid_extent)
    print(f"[datagen train] B={DATAGEN_BATCH} capacities {tcfg.input_capacities()}, voxels per level "
          f"(max over B) {[int(lv.num_voxels.max()) for lv in thier.levels]}")
    rows = phase_train_kernels(train_conv_shapes(tcfg, thier, proposal_geometry(tcfg, batch, csem, coff)),
                               tag="datagen train kernel", timed=False)
    model = _train_model(tcfg)
    opt = adam(model.named_parameters(), 1e-3)
    gen = torch.Generator().manual_seed(0)

    def step():
        return train_step(model, opt, batch, gen, True, True, True,
                          cluster_sem_override=csem, cluster_offset_override=coff)

    history = [step() for _ in range(DATAGEN_WARMUPS)]
    torch.cuda.synchronize()
    reset_launches()
    for i in range(DATAGEN_STEPS):
        with timer.time(f"step {i + 1}"):
            history.append(step())
            torch.cuda.synchronize()
    train_launches = dict(LAUNCHES)
    want = {k: n * DATAGEN_STEPS for k, n in LAUNCHES_PER_STEP.items()}
    if train_launches != want:
        raise AssertionError(f"datagen train steps launched {train_launches}, expected {want}")
    trace_dir = Path(tmp) / "trace"
    reset_launches()
    with maybe_trace(str(trace_dir)):
        history.append(step())
        torch.cuda.synchronize()
    trace_launches = dict(LAUNCHES)
    if trace_launches != LAUNCHES_PER_STEP:
        raise AssertionError(f"the traced step launched {trace_launches}")
    traces = sorted(trace_dir.glob("trace-*.json"))
    if len(traces) != 1:
        raise AssertionError(f"maybe_trace wrote {traces}")
    names_in_trace = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]}
    missing = [k for k in DATAGEN_TRACE_KERNELS if not any(k in n for n in names_in_trace)]
    if missing:
        raise AssertionError(f"the trace {traces[0].name} names no {missing}")
    for i, m in enumerate(history):
        bad = [k for k, v in m.items() if not bool(torch.isfinite(v))]
        if bad:
            raise AssertionError(f"datagen step {i + 1}: non-finite {bad}")
        nonzero = {k: float(v) for k, v in m.items() if k.startswith("counters/") and float(v) != 0}
        if nonzero:
            raise AssertionError(f"datagen step {i + 1}: capacity counters nonzero: {nonzero}")
    summary = timer.summary()
    step_ms = [summary[f"step {i + 1}"] for i in range(DATAGEN_STEPS)]
    print(f"[datagen train] B={DATAGEN_BATCH} ms per step (StepTimer around a synchronize): "
          f"{step_ms}, median {statistics.median(step_ms):.2f}; launches in {DATAGEN_STEPS} steps "
          f"{train_launches}; all counters 0; losses finite  ({smi})")
    print(f"[datagen train] step 1: " + ", ".join(
        f"{k} {float(v):.4f}" for k, v in history[0].items() if not k.startswith("counters/")))
    print(f"[datagen trace] {traces[0].name}: {traces[0].stat().st_size} bytes, "
          f"{len(names_in_trace)} event names, names {', '.join(DATAGEN_TRACE_KERNELS)}")
    print(f"[datagen memory] {device_memory_stats()}")
    print(f"[datagen timer] {summary}")
    lap("phase 13c (ingest, native dataset, train steps)", t)
    return dict(
        depth_launches=depth_launches["fwd"], depth_ms=depth_ms, depth_split=split,
        depth_device=device, train_launches=train_launches, trace_launches=trace_launches,
        step_ms=step_ms, max_abs_err={
            "fwd": max(err, *(r["fwd"]["max_abs_err"] for r in rows)),
            "dgrad": max(r["dgrad"]["max_abs_err"] for r in rows),
            "wgrad": max(r["wgrad"]["max_abs_err"] for r in rows)},
        render_ms={Path(d).name: summary[f"render {Path(d).name}"] for d in dirs},
        foreground=[fg[d] for d in dirs], clouds=len(ingested), rejected=rejected)


# phase 14: the checkpoint tools (the eleventh slice): the trainer's `last`
# of phase 9 through a reference-layout .ckpt and eval_parity on a small
# tree of rotated bench clouds (fp32 with exact clustering, then --bf16),
# and visu with --ckpt on the bench cloud and on an OBJ that needs FPS
TOOLS_EVAL_CLOUDS = 2               # rotated bench clouds per eval split
TOOLS_BATCH = 2                     # eval_parity --batch: one batch per split
# the card-vs-CPU reduced eval step: the val split's last cloud alone (the
# CPU's exact-clustering eval forward takes ~11 s per cloud)
TOOLS_COMPARE_BATCH = 1
TOOLS_OBJ_EXTRA = 4000              # vertices beyond the bench cloud's 20000
TOOLS_OBJ_JITTER = 2e-3             # std of the OBJ's seeded jitter
TOOLS_OBJ_SEED = 14


def reference_state_dict(sd, channels, block_repeat=2, spatial_order="xyz"):
    """The inverse of train/ckpt_convert.convert_reference_state_dict: the
    port's state_dict -> the reference's (spconv / Lightning) names and
    layouts, float32 CPU tensors.  SubMConv3d / SparseConv3d /
    SparseInverseConv3d kernels (k^3, in, out) -> (out, k, k, k, in), a
    shortcut (in, out) -> (out, 1, 1, 1, in), nn.Linear and BatchNorm
    tensors as they are; the score and NPCS branches only where the port's
    state_dict has them.  Every tensor of `sd` must be written."""
    import numpy as np
    import torch

    src = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    out, used = {}, set()
    inverse = (3, 2, 1, 0, 4) if spatial_order == "zyx" else (3, 0, 1, 2, 4)

    def take(name):
        used.add(name)
        return src[name]

    def put(name, value):
        out[name] = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))

    def conv(port, ref):
        w = take(port)
        k = {27: 3, 8: 2}[w.shape[0]]
        w = np.transpose(w, (0, 2, 1)).reshape(k, k, k, w.shape[2], w.shape[1])
        put(ref, np.transpose(w, inverse))

    def linear(port, ref):
        for leaf in ("weight", "bias"):
            put(f"{ref}.{leaf}", take(f"{port}.{leaf}"))

    def bn(port, ref):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            put(f"{ref}.{leaf}", take(f"{port}.{leaf}"))

    def resblock(port, ref):
        conv(f"{port}.conv1.kernel", f"{ref}.conv1.0.weight")
        bn(f"{port}.bn1", f"{ref}.conv1.1")
        conv(f"{port}.conv2.kernel", f"{ref}.conv2.0.weight")
        bn(f"{port}.bn2", f"{ref}.conv2.1")
        if f"{port}.shortcut_kernel" in src:
            w = take(f"{port}.shortcut_kernel")
            put(f"{ref}.shortcut.0.weight", w.T.reshape(w.shape[1], 1, 1, 1, w.shape[0]))
            bn(f"{port}.shortcut_bn", f"{ref}.shortcut.1")

    def ublock(port, ref, levels):
        for r in range(block_repeat):
            resblock(f"{port}.enc{r}", f"{ref}.encoder_blocks.{r}")
        if levels > 1:
            conv(f"{port}.down_kernel", f"{ref}.downsample.0.weight")
            bn(f"{port}.down_bn", f"{ref}.downsample.1")
            ublock(f"{port}.ublock", f"{ref}.ublock", levels - 1)
            conv(f"{port}.up_kernel", f"{ref}.upsample.0.weight")
            bn(f"{port}.up_bn", f"{ref}.upsample.1")
            for r in range(block_repeat):
                resblock(f"{port}.dec{r}", f"{ref}.decoder_blocks.{r}")

    def sparse_unet(name, levels, without_stem):
        if without_stem:
            bn(f"{name}.stem_bn", f"{name}.stem.0")
        else:
            conv(f"{name}.stem_conv.kernel", f"{name}.stem.0.weight")
            bn(f"{name}.stem_bn", f"{name}.stem.1")
        ublock(f"{name}.ublock", f"{name}.ublock", levels)

    sparse_unet("backbone", len(channels), without_stem=False)
    linear("sem_seg_head", "sem_seg_head")
    linear("offset_mlp0", "offset_head.0")
    bn("offset_bn", "offset_head.1")
    linear("offset_mlp1", "offset_head.3")
    for unet, head in (("score_unet", "score_head"), ("npcs_unet", "npcs_head")):
        if f"{head}.weight" in src:
            sparse_unet(unet, 2, without_stem=True)
            linear(head, head)
    left = sorted(set(src) - used)
    if left:
        raise ValueError(f"reference_state_dict: {len(left)} tensors not written: {left[:5]}")
    return out


def write_reference_ckpt(path, sd, channels, block_repeat=2, spatial_order="xyz"):
    """`sd` as the reference's Lightning checkpoint, {"state_dict": ...}."""
    import torch

    torch.save({"state_dict": reference_state_dict(sd, channels, block_repeat, spatial_order)},
               str(path))


def write_obj(path, xyz, rgb):
    """'v x y z r g b' lines, as tools/visu.load_obj_points reads them."""
    import numpy as np

    with open(path, "w") as f:
        f.write("# seeded jitter of assets/bench_cloud.npz\n")
        np.savetxt(f, np.concatenate([xyz, rgb], axis=1), fmt="v %.6f %.6f %.6f %.6f %.6f %.6f")


class CallProbe:
    """Replaces attribute `name` of `owner` for the length of a `with`
    block by a wrapper that times each call between two synchronizes and
    reads the subm-conv counts (not reset) around it; keeps each call's
    result, and with `keep_args` its arguments."""

    def __init__(self, owner, name, keep_args=False):
        self.owner, self.name, self.records, self.keep_args = owner, name, [], keep_args

    def __enter__(self):
        import torch

        from gapartnet_tpu_torch.ops.subm_conv import LAUNCHES

        self.saved = getattr(self.owner, self.name)
        fn = self.saved

        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.records.append(dict(ms=(time.perf_counter() - t0) * 1e3, result=out,
                                     launches={k: LAUNCHES[k] - before[k] for k in LAUNCHES}))
            if self.keep_args:
                self.records[-1].update(args=args, kw=kw)
            return out

        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.saved)


def tools_parity(tag, argv, run_dir, cfg, smi, kind):
    """eval_parity.main(argv) in its own directory under a FitProbe: every
    eval metric name logged (the recalls of absent classes aside) and
    finite, 53 `kind` launches and no other per eval batch.  Returns
    (metrics, probe, seconds)."""
    import math

    from gapartnet_tpu_torch.ops.subm_conv import LAUNCHES, reset_launches
    from gapartnet_tpu_torch.tools import eval_parity
    from gapartnet_tpu_torch.train import trainer

    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True)
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(run_dir), FitProbe() as probe:
        metrics = eval_parity.main(argv)
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    lines = _metric_lines(run_dir / "parity_metrics.jsonl")
    if len(lines) != 1:
        raise AssertionError(f"{tag}: {len(lines)} lines in parity_metrics.jsonl")
    check_metric_lines(tag, lines, cfg)
    names = trainer.eval_metric_names(cfg, True)
    if not all(math.isfinite(v) for v in metrics.values()) or not any(
            k.startswith("val/AP@50_") for k in metrics):
        raise AssertionError(f"{tag}: metrics not all finite, or no per-class AP: {metrics}")
    want = launch_counts(**{kind: CONVS_PER_FORWARD})
    _check_launches(f"{tag} eval batch", probe.evals, lambda r: want)
    batches = 3 * -(-TOOLS_EVAL_CLOUDS // TOOLS_BATCH)
    if len(probe.evals) != batches or launches != launch_counts(**{kind: CONVS_PER_FORWARD * batches}):
        raise AssertionError(f"{tag}: {len(probe.evals)} eval batches, launches {launches}")
    (split_ms,) = [r["ms"] for r in probe.validations]
    clouds = 3 * TOOLS_EVAL_CLOUDS
    batch_ms = ", ".join("%.1f" % r["ms"] for r in probe.evals)
    print(f"[{tag}] eval_parity.main {' '.join(argv[4:])}: {seconds:.1f} s in all (conversion, "
          f"datasets, evaluation); evaluate_splits {split_ms / 1e3:.3f} s for 3 splits of "
          f"{TOOLS_EVAL_CLOUDS} clouds: {split_ms / 3e3:.3f} s per split, "
          f"{clouds / split_ms * 1e3:.2f} clouds/s; ms per eval batch (B = {TOOLS_BATCH}) "
          f"{batch_ms}; {launches[kind]} {kind} launches ({CONVS_PER_FORWARD} per batch); "
          f"{len(metrics)} of the {len(names)} eval metric names logged (the others recalls of "
          f"classes absent from a split), all finite  ({smi})")
    print(f"[{tag}] counters: " + ", ".join(
        f"{k} {v:g}" for k, v in sorted(metrics.items()) if "/counters/" in k))
    print(f"[{tag}] " + ", ".join(f"{k} {metrics[k]:.2f}" for k in (
        "val/AP@50", "val/mAP", "val/miou", "monitor_metrics/mean_mAP")))
    return metrics, dict(seconds=seconds, split_s=split_ms / 3e3,
                         clouds_per_s=clouds / split_ms * 1e3,
                         eval_batch_ms=[r["ms"] for r in probe.evals], launches=launches[kind])


def phase_tools(smi, last, tmp):
    """Phase 14: the checkpoint tools, at GAPartNetConfig() widths, in the
    directory `tmp`, with phase 9's trainer checkpoint `last`.  14a: `last`
    written as a reference-layout Lightning .ckpt and read back through
    eval_parity's own loading, bitwise equal; 14b: eval_parity.main on 2
    rotated bench clouds per split (exact clustering), the kernel against
    its plain version on the hierarchy of the tool's val batch, one reduced
    eval step (the val split's last cloud) card vs CPU;
    then with --bf16 (the bf16 forward against its plain version); 14c:
    visu.run with --ckpt on the bench cloud's .npz and on an OBJ of 24000
    jittered vertices (FPS to 20000): FPS indices and predict card vs CPU
    (phase 7's rules); the panels where cv2 is importable, else the writer
    must refuse, naming cv2.  Returns the numbers for the kernel line.
    Phase 9's `last` has the widths of GAPartNetConfig(), which both tools
    build."""
    import numpy as np
    import torch

    from gapartnet_tpu_torch.entry import BENCH_CLOUD
    from gapartnet_tpu_torch.infer import api
    from gapartnet_tpu_torch.models.gapartnet import prepare_input_grid
    from gapartnet_tpu_torch.ops.sparse_conv import build_hierarchy
    from gapartnet_tpu_torch.ops.subm_conv import reset_launches
    from gapartnet_tpu_torch.structures import PointCloudBatch
    from gapartnet_tpu_torch.tools import eval_parity
    from gapartnet_tpu_torch.tools import visu as visu_tool
    from gapartnet_tpu_torch.train import trainer
    from gapartnet_tpu_torch.utils import visu

    tmp = Path(tmp)
    t = time.perf_counter()
    numbers = {}

    # 14a: the trainer's weights -> a reference-layout .ckpt -> eval_parity's loading
    data, ref_ckpt = tmp / "data", tmp / "reference.ckpt"
    write_fit_dataset(data, eval_clouds=TOOLS_EVAL_CLOUDS, eval_only=True)
    argv = ["--data", str(data), "--ckpt", str(ref_ckpt), "--batch", str(TOOLS_BATCH),
            "--clustering", "exact", "--device", "cuda"]
    cfg = eval_parity.build_config(eval_parity.parse_args(argv))
    trained = trainer.CkptManager.restore(str(last))["model"]
    write_reference_ckpt(ref_ckpt, trained, cfg.model.channels, cfg.model.block_repeat)
    back = eval_parity.load_weights(str(ref_ckpt), cfg)
    if sorted(back) != sorted(trained):
        raise AssertionError(f"round trip: keys differ: {sorted(set(back) ^ set(trained))[:5]}")
    for k, v in trained.items():
        if back[k].dtype != v.dtype or not torch.equal(back[k], v):
            raise AssertionError(f"round trip: {k} not bitwise equal")
    print(f"[tools round trip] phase 9's last ({len(trained)} tensors, channels "
          f"{cfg.model.channels}, block_repeat {cfg.model.block_repeat}) -> reference layout "
          f"{ref_ckpt.name} ({ref_ckpt.stat().st_size} bytes) -> eval_parity.load_weights: every "
          "tensor bitwise equal")
    t = lap("phase 14a (reference-layout round trip)", t)

    # 14b: eval_parity on the card, fp32 exact, then --bf16
    metrics, numbers["parity"] = tools_parity("tools parity", argv, tmp / "parity", cfg, smi, "fwd")
    datasets = trainer.build_datasets(cfg, "test")
    *_, raw = trainer._iter_batches(datasets["val"], TOOLS_BATCH, drop_last=False)
    *_, pair_raw = trainer._iter_batches(datasets["val"], TOOLS_COMPARE_BATCH, drop_last=False)
    model = eval_parity.build_model(cfg, back, "cuda")
    batch = PointCloudBatch.from_numpy(raw, "cuda")
    keys, _, nvox, _ = prepare_input_grid(batch.points, batch.point_mask, cfg.model)
    hier = build_hierarchy(keys, nvox, cfg.model.input_capacities(),
                           extent=cfg.model.input_grid_extent)
    print(f"[tools parity kernel] the tool's capacities {cfg.model.input_capacities()}, extent "
          f"{cfg.model.input_grid_extent}; val batch voxels per level "
          f"{[lv.num_voxels.tolist() for lv in hier.levels]}")
    rows = phase_kernels(cfg.model, hier, "cuda", tag="tools parity kernel", timed=False)
    numbers["max_abs_err"] = {"fwd": max(r["max_abs_err"] for r in rows)}
    compare_fit_eval(cfg, model, PointCloudBatch.from_numpy(pair_raw, "cuda"),
                     PointCloudBatch.from_numpy(pair_raw, "cpu"), tag="tools parity compare",
                     eval_cfg=cfg.model)
    del model
    t = lap("phase 14b (eval_parity fp32, exact clustering)", t)
    bf16_cfg = eval_parity.build_config(eval_parity.parse_args(argv + ["--bf16"]))
    _, numbers["parity_bf16"] = tools_parity("tools parity bf16", argv + ["--bf16"],
                                             tmp / "parity_bf16", bf16_cfg, smi, "fwd_bf16")
    bf16_rows = phase_bf16_kernels(bf16_inference_shapes(bf16_cfg.model, hier), ("fwd_bf16",),
                                   "tools parity bf16 kernel", timed=False)
    numbers["max_abs_err"]["fwd_bf16"] = max(r["fwd_bf16"]["max_abs_err"] for r in bf16_rows)
    t = lap("phase 14b (eval_parity --bf16)", t)

    # 14c: visu --ckpt on the bench cloud and on an OBJ that needs FPS
    rng = np.random.RandomState(TOOLS_OBJ_SEED)
    bench = np.load(BENCH_CLOUD)
    n = len(bench["xyz"])
    pick = np.concatenate([np.arange(n), rng.choice(n, TOOLS_OBJ_EXTRA, replace=False)])
    obj = tmp / "bench_jitter.obj"
    write_obj(obj, bench["xyz"][pick] + rng.normal(0, TOOLS_OBJ_JITTER, (len(pick), 3)),
              bench["rgb"][pick])
    cpu = api.GAPartNetInference(ckpt_path=str(last), device="cpu")
    visu_numbers = {}
    for what, kw in (("npz", dict(input=str(BENCH_CLOUD))), ("obj", dict(obj=str(obj)))):
        tag = f"tools visu {what}"
        reset_launches()
        with CallProbe(api.GAPartNetInference, "_request") as requests, \
                CallProbe(api, "fps_downsample") as fps:
            r = visu_tool.run(ckpt=str(last), device="cuda", **kw)
        (req,) = requests.records
        if req["launches"] != launch_counts(fwd=CONVS_PER_FORWARD):
            raise AssertionError(f"{tag}: predict launched {req['launches']}")
        counters = {k: int(v.sum()) for k, v in req["result"].out.counters.items()}
        print(f"[{tag}] {r.name}: {len(r.points)} points, predict {req['ms']:.1f} ms "
              f"({CONVS_PER_FORWARD} forward launches), {len(r.result.bboxes)} boxes, classes "
              f"{r.result.proposal_classes.tolist()}; counters {counters}  ({smi})")
        visu_numbers[what] = dict(predict_ms=req["ms"], launches=req["launches"]["fwd"])
        if what == "obj":
            (f,) = fps.records
            xyz = visu_tool.load_obj_points(str(obj))[:, :3]
            t0 = time.perf_counter()
            idx_cpu = api.fps_downsample(xyz, cpu.cfg.max_points, device="cpu")
            print(f"[{tag}] FPS {len(xyz)} -> {len(r.index)} points on the card {f['ms']:.1f} ms "
                  f"(host clock around synchronizes)  ({smi}); on the CPU "
                  f"{time.perf_counter() - t0:.1f} s")
            if not np.array_equal(r.index, idx_cpu):
                raise AssertionError(f"{tag}: FPS indices differ at "
                                     f"{int((r.index != idx_cpu).sum())} of {len(idx_cpu)}")
            print(f"[{tag}] FPS indices identical on the card and the CPU")
            visu_numbers[what]["fps_ms"] = f["ms"]
        elif fps.records:
            raise AssertionError(f"{tag}: a dataset cloud went through FPS")
        compare_requests(tag, req["result"], cpu, r.points)
        out_dir = tmp / "visu_out"
        if visu.have_cv2():
            panels = visu_tool.write_panels(str(out_dir), r)
            print(f"[{tag}] wrote {len(panels)} panels under {out_dir}/tool/")
        else:
            try:
                visu_tool.write_panels(str(out_dir), r)
            except RuntimeError as e:
                if "cv2" not in str(e):
                    raise
                print(f"[{tag}] no panels: cv2 is not installed, and write_panels says so: {e}")
            else:
                raise AssertionError(f"{tag}: write_panels ran without cv2")
    numbers["visu"] = visu_numbers
    numbers["launches"] = launch_counts(
        fwd=numbers["parity"]["launches"] + sum(v["launches"] for v in visu_numbers.values()),
        fwd_bf16=numbers["parity_bf16"]["launches"])
    lap("phase 14c (visu)", t)
    return numbers



# phase 15: the sustained staged-training tool (tools/sustained_run.py) and
# its four diagnostics, at GAPartNetConfig() widths (make_cfg's bf16, hash
# clustering, auto_capacity, B = 8), in a temporary directory.  Cuts: the
# reference's two real assets are generated stand-ins; the view plans are
# cut to 10 distant and 2 zoom views, every split non-empty; the epochs are
# cut so that each phase validates once
SUSTAINED_STANDINS = {"Box": 1, "Microwave": 1}    # REAL_SEEN, REAL_INTER
SUSTAINED_STANDIN_SEED = 1
SUSTAINED_EPOCHS_A = 2                              # phase A validates every 2 epochs
SUSTAINED_EPOCHS_B = 3                              # phase B every 3
SUSTAINED_BATCH = TRAIN_BATCH                       # make_cfg's --batch default
SUSTAINED_CONFUSION_LIMIT = 2
VALLEY_EPOCHS = 1
SPLIT_NAMES = ("train", "val", "test_intra", "test_inter")
# bf16 launches per train step by do_npcs: sem + offset only (phase A, the
# valley probe: the 53 backbone convs, a dgrad for all but the stem), and
# all stages with the trunk frozen (phase B: the 24 proposal-UNet convs
# alone run a dgrad and a wgrad)
SUSTAINED_LAUNCHES_PER_STEP = {False: launch_counts(fwd_bf16=53, dgrad_bf16=52, wgrad_bf16=53),
                               True: launch_counts(fwd_bf16=77, dgrad_bf16=24, wgrad_bf16=24)}
SUSTAINED_EVAL_LAUNCHES = launch_counts(fwd_bf16=CONVS_PER_FORWARD)


def sustained_view_plan(by_name):
    """sustained_run.view_plan cut to 10 distant views of four of its
    assets: train 6, val 2, test_intra 1, test_inter 1."""
    from gapartnet_tpu_torch.tools import sustained_run as sr

    return {
        "real_seen": (sr.REAL_SEEN, 5, (0,), [("train", 2), ("val", 2), ("test_intra", 1)]),
        "Box_0": (by_name["Box_0"], 2, (0,), [("train", 2)]),
        "Remote_0": (by_name["Remote_0"], 2, (0,), [("train", 2)]),
        "real_inter": (sr.REAL_INTER, 1, (0, 1), [("test_inter", 1)]),
    }


def sustained_zoom_plan(by_name):
    """sustained_run.zoom_plan cut to its first two assets, one close-up
    each, both to train (which then holds one B = 8 batch)."""
    from gapartnet_tpu_torch.tools import sustained_run as sr

    return [(sr.REAL_SEEN, (sr.HANDLE, sr.ROUND_HANDLE), 0.10, 1, [("train", 1)]),
            (by_name.get("Box_0"), (sr.HANDLE,), 0.15, 1, [("train", 1)])]


def planned_counts(plan, rendered, zoom_allocs):
    """Clouds per split under the tool's rules: each distant asset's
    rendered names cut by its allocations in order (a skipped view costs
    the last allocation only), plus each close-up asset's allocation after
    zoom_allocation."""
    counts = dict.fromkeys(SPLIT_NAMES, 0)
    for (_, _, _, alloc), got in zip(plan.values(), rendered):
        pos = 0
        for split, count in alloc:
            counts[split] += max(0, min(pos + count, got) - pos)
            pos += count
    for alloc in zoom_allocs:
        for split, count in alloc:
            counts[split] += count
    return counts


def split_instances(split_dir, num_classes):
    """GT instances per class in a split's .npz files: each instance id's
    class is the label of its first point (data/instances.py)."""
    import numpy as np

    counts = np.zeros(num_classes, np.int64)
    for f in sorted(Path(split_dir).glob("*.npz")):
        d = np.load(f)
        ids, first = np.unique(d["instance_labels"], return_index=True)
        for i, j in zip(ids, first):
            if i >= 0:
                counts[int(d["sem_labels"][j])] += 1
    return counts


def phase_sustained(smi, tmp):
    """Phase 15: `python -m gapartnet_tpu_torch.tools.sustained_run
    --two-phase --freeze-trunk-b --sem-alpha auto --add-zoom --device cuda`
    through its main(argv) in the directory `tmp`, the real assets replaced
    by generated stand-ins, the view plans and epochs cut; then the four
    diagnostics on its checkpoints.  Checks: (a) each split's clouds are
    the cut plan's allocation under the tool's skip rule; (b) phase A wrote
    phase_a_done and a _recall_gmp_ checkpoint; (c) phase B left every
    frozen parameter and running statistic bitwise at best_a's; (d) both
    tests ran under the zero-overflow contract (the tool raises on a
    nonzero counter; GAPARTNET_ALLOW_OVERFLOW is unset for the run) and
    wrote their metrics; (e) the bf16 kernels against their plain versions
    at the run's shapes; (f) confusion_diag card vs CPU (integer tables
    equal up to near-tie flips), proposal_diag's and margin_diag's tables
    consistent, valley_probe's trajectory.  Every train step and eval
    forward is checked for its bf16 launches.  Returns the numbers for the
    kernel line."""
    import math

    import numpy as np
    import torch

    from gapartnet_tpu_torch.datagen.synthetic import generate_assets
    from gapartnet_tpu_torch.ops.subm_conv import LAUNCHES, reset_launches
    from gapartnet_tpu_torch.tools import confusion_diag, margin_diag, proposal_diag, valley_probe
    from gapartnet_tpu_torch.tools import sustained_run as sr
    from gapartnet_tpu_torch.train import trainer

    tmp = Path(tmp)
    t = time.perf_counter()
    data, wd = tmp / "data", tmp / "run"
    seen, inter = generate_assets(str(tmp / "standins"), SUSTAINED_STANDINS,
                                  seed=SUSTAINED_STANDIN_SEED)
    argv = ["--workdir", str(wd), "--data", str(data), "--two-phase", "--freeze-trunk-b",
            "--sem-alpha", "auto", "--add-zoom", "--epochs-a", str(SUSTAINED_EPOCHS_A),
            "--epochs", str(SUSTAINED_EPOCHS_B), "--device", "cuda"]
    full = sum(v[1] for v in sr.view_plan(collections.defaultdict(str)).values())
    cut = sum(v[1] for v in sustained_view_plan(collections.defaultdict(str)).values())
    defaults = sr.parse_args(["--data", str(data)])
    print(f"[sustained] [cut] REAL_SEEN and REAL_INTER (the reference's 45780 and 102442, not "
          f"yet committed under assets/example_assets) -> generated stand-ins {Path(seen).name}, {Path(inter).name} (seed "
          f"{SUSTAINED_STANDIN_SEED}); distant views {full} -> {cut}, close-ups "
          f"{sum(z[3] for z in sr.zoom_plan({}))} -> {sum(z[3] for z in sustained_zoom_plan({}))}; "
          f"epochs: phase A {defaults.epochs_a} -> {SUSTAINED_EPOCHS_A}, phase B "
          f"{defaults.epochs} -> {SUSTAINED_EPOCHS_B} (one validation each); widths not cut "
          f"(GAPartNetConfig(), {defaults.points} points, B = {defaults.batch})")
    rendered, zoom_allocs, fits = [], [], []
    render_views, zoom_allocation, fit = sr.render_views, sr.zoom_allocation, trainer.fit

    def counted_render_views(*args, **kw):
        names = render_views(*args, **kw)
        rendered.append(len(names))
        return names

    def recorded_zoom_allocation(alloc, n):
        out = zoom_allocation(alloc, n)
        zoom_allocs.append(out)
        return out

    def recorded_fit(cfg, device="cuda"):
        t0 = time.perf_counter()
        state = fit(cfg, device=device)
        torch.cuda.synchronize()
        fits.append(dict(cfg=cfg, state=state, s=time.perf_counter() - t0))
        return state

    # the environment is put back afterwards (run_test sets GAPARTNET_CHECKS);
    # the contract binds: GAPARTNET_ALLOW_OVERFLOW is unset for the run
    with contextlib.ExitStack() as patches:
        patches.enter_context(unittest.mock.patch.dict(os.environ))
        for k in ("GAPARTNET_CHECKS", "GAPARTNET_ALLOW_OVERFLOW"):
            os.environ.pop(k, None)
        for owner, name, value in (
                (sr, "REAL_SEEN", seen), (sr, "REAL_INTER", inter),
                (sr, "view_plan", sustained_view_plan), (sr, "zoom_plan", sustained_zoom_plan),
                (sr, "render_views", counted_render_views),
                (sr, "zoom_allocation", recorded_zoom_allocation), (trainer, "fit", recorded_fit)):
            patches.enter_context(unittest.mock.patch.object(owner, name, value))
        reset_launches()
        t0 = time.perf_counter()
        with FitProbe() as probe, CallProbe(trainer, "test") as tests, \
                CallProbe(sr, "build_dataset") as build, \
                CallProbe(sr, "append_zoom_views") as zoom:
            sr.main(argv)
        main_s = time.perf_counter() - t0
        main_launches = dict(LAUNCHES)
        plan = sustained_view_plan({p.name: str(p) for p in (data / "synth_assets").iterdir()})
    print(f"[sustained] sustained_run.main {' '.join(argv[4:])}: {main_s:.1f} s in all; "
          f"renders {build.records[0]['ms'] / 1e3:.1f} s for {sum(rendered)} distant views, "
          f"{zoom.records[0]['ms'] / 1e3:.1f} s for {sum(sum(c for _, c in a) for a in zoom_allocs)} "
          f"close-ups (host render, FPS on the card); fits "
          f"{', '.join('%.1f' % f['s'] for f in fits)} s; tests "
          f"{', '.join('%.1f' % (r['ms'] / 1e3) for r in tests.records)} s  ({smi})")
    t = lap("phase 15 (sustained_run.main)", t)

    # (a) the data tree
    want = planned_counts(plan, rendered, zoom_allocs)
    got = {s: len(list((data / s / "pth").glob("*.npz"))) for s in SPLIT_NAMES}
    if got != want or not all(got.values()):
        raise AssertionError(f"sustained (a): clouds per split {got}, the plan's allocation "
                             f"under the skip rule {want} (rendered {rendered}, zoom {zoom_allocs})")
    print(f"[sustained] (a) clouds per split {got} = the cut plan's allocation (rendered "
          f"{rendered} of {[v[1] for v in plan.values()]} distant views, zoom allocations "
          f"{zoom_allocs}); every split non-empty")

    # (b) phase A's outputs
    best_a = sr.best_ckpt(wd / "checkpoints_a", "val/recall_gmp")
    if not (wd / "phase_a_done").exists() or best_a is None or "_recall_gmp_" not in best_a.name:
        raise AssertionError(f"sustained (b): phase_a_done {(wd / 'phase_a_done').exists()}, "
                             f"best_a {best_a}")
    print(f"[sustained] (b) phase_a_done written; best_ckpt(checkpoints_a, val/recall_gmp) = "
          f"{best_a.name}")

    # (c) the frozen trunk
    _, fit_b = fits
    if tuple(fit_b["cfg"].trainer.freeze_prefixes) != FREEZE:
        raise AssertionError(f"sustained (c): phase B froze {fit_b['cfg'].trainer.freeze_prefixes}")
    ref = trainer.CkptManager.restore(str(best_a))["model"]
    last = trainer.CkptManager.restore(str(wd / "checkpoints" / "last"))["model"]
    frozen = [k for k in ref if k.split(".", 1)[0] in FREEZE]
    changed = [k for k in frozen if not torch.equal(last[k], ref[k])]
    if changed or not frozen:
        raise AssertionError(f"sustained (c): {len(changed)} frozen tensors changed: {changed[:5]}")
    heads = ("score_unet", "score_head", "npcs_unet", "npcs_head")
    moved = sum(k.split(".", 1)[0] in heads and not torch.equal(last[k], ref[k]) for k in ref)
    print(f"[sustained] (c) phase B (warm start {best_a.name}, {FREEZE} frozen): all "
          f"{len(frozen)} frozen tensors (parameters and running statistics) in checkpoints/last "
          f"bitwise equal to best_a's; {moved} score / NPCS tensors moved")

    # (d) the tests under the zero-overflow contract
    for tag in ("last", "best"):
        m = json.loads((wd / f"test_metrics_{tag}.json").read_text())
        counters = {k: v for k, v in m.items() if "counters" in k}
        if not counters or any(v != 0 for v in counters.values()) or not all(
                math.isfinite(v) for v in m.values()):
            raise AssertionError(f"sustained (d): test_metrics_{tag}.json counters {counters}")
        print(f"[sustained] (d) test[{tag}]: {len(m)} metrics, all finite; {len(counters)} "
              f"counters all 0; mean_mAP {m['monitor_metrics/mean_mAP']:.2f}, val/pixel_accu "
              f"{m['val/pixel_accu']:.2f}, val/miou {m['val/miou']:.2f}")
    if len(tests.records) != 2 or not (wd / "test_metrics.json").exists():
        raise AssertionError(f"sustained (d): {len(tests.records)} tests, test_metrics.json "
                             f"{(wd / 'test_metrics.json').exists()}")

    # the launches of every train step and eval forward of the run
    _check_launches("sustained step", probe.steps,
                    lambda r: SUSTAINED_LAUNCHES_PER_STEP[r["key"]])
    _check_launches("sustained eval forward", probe.evals, lambda r: SUSTAINED_EVAL_LAUNCHES)
    steps_per_epoch = got["train"] // SUSTAINED_BATCH
    want_steps = {False: SUSTAINED_EPOCHS_A * steps_per_epoch,
                  True: SUSTAINED_EPOCHS_B * steps_per_epoch}
    n_steps = {k: sum(r["key"] == k for r in probe.steps) for k in (False, True)}
    total = {k: sum(r["launches"][k] for r in probe.steps + probe.evals) for k in main_launches}
    if n_steps != want_steps or main_launches != total or any(main_launches[k] for k in KINDS[:3]):
        raise AssertionError(f"sustained: steps {n_steps} (expected {want_steps}), launches "
                             f"{main_launches} (steps and eval forwards: {total})")
    step_ms = {k: [r["ms"] for r in probe.steps if r["key"] == k] for k in (False, True)}
    print(f"[sustained] launches {main_launches} in {n_steps[False]} phase-A and {n_steps[True]} "
          f"phase-B steps ({SUSTAINED_LAUNCHES_PER_STEP[False]} / "
          f"{SUSTAINED_LAUNCHES_PER_STEP[True]} per step) and {len(probe.evals)} eval forwards "
          f"({SUSTAINED_EVAL_LAUNCHES['fwd_bf16']} fwd_bf16 each); no fp32 launch")
    print(f"[sustained] ms per train step: phase A {', '.join('%.1f' % m for m in step_ms[False])}; "
          f"phase B {', '.join('%.1f' % m for m in step_ms[True])}; ms per eval forward "
          f"{', '.join('%.1f' % r['ms'] for r in probe.evals)}; ms per split validation "
          f"{', '.join('%.1f' % (r['ms'] / 3) for r in probe.validations)}  ({smi})")
    _print_counters("sustained phase A", _metric_lines(wd / "fit_phase_a.jsonl"))
    _print_counters("sustained phase B", _metric_lines(wd / "fit_phase_b.jsonl"))

    # (f) the diagnostics on the run's checkpoints, on the card
    t = time.perf_counter()
    ckpt = str(wd / "checkpoints" / "last")
    conf_argv = ["--data", str(data), "--ckpt", ckpt, "--splits", "val", "--limit",
                 str(SUSTAINED_CONFUSION_LIMIT)]
    t0 = time.perf_counter()
    with CallProbe(trainer, "eval_step") as card_views:
        card_conf = confusion_diag.main(conf_argv + ["--workdir", str(tmp / "conf_card"),
                                                     "--device", "cuda"])
    conf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = proposal_diag.main(["--workdir", str(wd), "--data", str(data), "--split", "val",
                                "--device", "cuda"])
    proposal_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = margin_diag.main(["--workdir", str(wd), "--data", str(data), "--device", "cuda"])
    margin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with FitProbe() as vprobe:
        trajectory = valley_probe.main(["--data", str(data), "--workdir", str(tmp / "valley"),
                                        "--tag", "chip", "--epochs", str(VALLEY_EPOCHS),
                                        "--device", "cuda"])
    valley_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    diag_launches = {k: LAUNCHES[k] - main_launches[k] for k in LAUNCHES}
    _check_launches("valley step", vprobe.steps, lambda r: SUSTAINED_LAUNCHES_PER_STEP[r["key"]])
    _check_launches("confusion view", card_views.records, lambda r: SUSTAINED_EVAL_LAUNCHES)
    print(f"[sustained diag] on the card: confusion_diag {conf_s:.1f} s ({len(card_views.records)} "
          f"views at B = 1, sem only), proposal_diag {proposal_s:.1f} s, margin_diag "
          f"{margin_s:.1f} s, valley_probe {valley_s:.1f} s ({len(vprobe.steps)} steps); "
          f"launches {diag_launches}  ({smi})")

    # confusion_diag on the CPU from the same checkpoint; its views' eval
    # steps once more with every BatchNorm output moved by +-1 fp32 ulp (the
    # bf16 allowance)
    t0 = time.perf_counter()
    with CallProbe(trainer, "eval_step", keep_args=True) as cpu_views:
        cpu_conf = confusion_diag.main(conf_argv + ["--workdir", str(tmp / "conf_cpu"),
                                                    "--device", "cpu"])
    with bn_ulp_probe(NET_PROBES[0]):
        probes = [trainer.eval_step(*r["args"], **r["kw"]) for r in cpu_views.records]
    print(f"[sustained diag] confusion_diag on the CPU, and its views' BatchNorm-ulp probe: "
          f"{time.perf_counter() - t0:.1f} s")
    flips = 0
    for i, (g, c, p) in enumerate(zip(card_views.records, cpu_views.records, probes)):
        g, c = g["result"], c["result"]
        allow = _probe_allow("sem_logits", [p], c)
        tol = FORWARD_RTOL * float(c.sem_logits.abs().max()) + allow
        flips += _near_ties(f"confusion view {i}", g.sem_preds.cpu(), c.sem_logits.cpu(), tol=tol)
    (agg_g, rows_g), = card_conf.values()
    (agg_c, rows_c), = cpu_conf.values()
    moved = int(np.abs(agg_g - agg_c).sum())
    if len(card_views.records) != SUSTAINED_CONFUSION_LIMIT or moved > 2 * flips or (
            not flips and [r[:2] for r in rows_g] != [r[:2] for r in rows_c]):
        raise AssertionError(f"sustained (f): confusion card vs CPU: {moved} entries moved by "
                             f"{flips} near-tie flips")
    print(f"[sustained] (f) confusion_diag val --limit {SUSTAINED_CONFUSION_LIMIT}: card and CPU "
          f"tables {'equal' if not moved else f'{moved} entries apart'}; sem_preds differing at "
          f"{flips} near-ties (tolerance with the probe's allowance); {int(agg_g.sum())} points")

    # proposal_diag's table against the split's instances; margin_diag's rows
    counts = split_instances(data / "val" / "pth", len(agg_g))
    for c_id in range(1, len(counts)):
        gt, _, born, iou50, scored, kept, match_gt, _ = table.get(c_id, [0] * 8)
        if gt != counts[c_id] or not (born >= iou50 >= match_gt and born >= scored >= kept):
            raise AssertionError(f"sustained (f): proposal_diag class {c_id}: {table.get(c_id)}, "
                                 f"{counts[c_id]} GT instances in the split")
    print(f"[sustained] (f) proposal_diag val: gt per class = the split's instances "
          f"{counts[1:].tolist()}; born >= iou50 >= match-gt and born >= scored >= kept in every "
          f"row ({len(table)} rows)")
    names = sorted(p.name for p in (wd / "checkpoints").iterdir()
                   if p.name.startswith("epoch_")) + ["last"]
    if [r[0] for r in rows] != names or not all(
            all(math.isfinite(v) for v in r[1:]) and 0 <= r[4] <= 1 and 0 <= r[5] <= 100
            and r[2] <= r[3] for r in rows):
        raise AssertionError(f"sustained (f): margin_diag rows {rows}")
    print(f"[sustained] (f) margin_diag: {len(rows)} rows ({', '.join(names)}), finite, "
          f"p50 <= p90, frac>0 in [0, 1], predfg% in [0, 100]")
    if not trajectory or "train_pixel_accu" not in trajectory[0]:
        raise AssertionError(f"sustained (f): valley_probe trajectory {trajectory}")
    print(f"[sustained] (f) valley_probe {VALLEY_EPOCHS} epoch: trajectory {trajectory}")
    t = lap("phase 15f (diagnostics)", t)

    # (e) the bf16 kernels at the run's shapes: phase B's train batch and
    # the val split's padded batch
    cfg_b, model_b = fit_b["cfg"], fit_b["state"].model
    datasets = trainer.build_datasets(cfg_b, "fit")
    train_raw = next(trainer._iter_batches(datasets["train"], SUSTAINED_BATCH, drop_last=True,
                                           shuffle_seed=cfg_b.trainer.seed + 1))
    *_, val_raw = trainer._iter_batches(datasets["val"], SUSTAINED_BATCH, drop_last=False)
    err = fit_kernels(cfg_b, model_b, train_raw, val_raw, tag="sustained")
    print(f"[sustained] (e) bf16 kernels vs plain at the run's shapes: max|d| {err}")
    lap("phase 15e (kernels)", t)
    launches = {k: main_launches[k] + diag_launches[k] for k in LAUNCHES}
    return dict(launches=launches, steps=n_steps, max_abs_err=err)


def tools_entry(tools, kind):
    """Phase 14's part of a forward kernel's entry: its launches in
    eval_parity's eval batches (and, fp32, visu's two requests), and the
    tools' times."""
    parity = tools["parity_bf16" if kind == "fwd_bf16" else "parity"]
    entry = {
        "launches": tools["launches"][kind], "per_eval_batch": CONVS_PER_FORWARD,
        "eval_batches": len(parity["eval_batch_ms"]), "eval_batch_ms": parity["eval_batch_ms"],
        "split_s": parity["split_s"], "clouds_per_s": parity["clouds_per_s"],
        "max_abs_err": tools["max_abs_err"][kind],
        "work": f"eval_parity{' --bf16' if kind == 'fwd_bf16' else ''} (exact clustering) over 3 "
                f"splits of {TOOLS_EVAL_CLOUDS} rotated bench clouds, batch {TOOLS_BATCH}"
                + (f"; visu --ckpt on the bench cloud and on an OBJ of it with {TOOLS_OBJ_EXTRA} "
                   "more jittered vertices (FPS)" if kind == "fwd" else ""),
    }
    if kind == "fwd":
        entry["visu"] = tools["visu"]
    return entry


def kernel_line(rows, entry_rows, launches, train_rows, train_launches, api=None, fit=None,
                dp=None, exact=None, pointnet=None, datagen=None, tools=None):
    """The {"kernels": [...]} entries: per kernel, its launches in the main
    path's run (None when it did not run), its times summed over one B = 8
    train step (forward: with the 53 inference convs beside them, and the
    launches and times of the inference API's requests, `api`), bounds and
    errors, and its per-shape rows; with `fit`, each kernel's launches in
    phase 9's fit and frozen-trunk runs; with `dp`, each rank's launches in
    phase 10's timed data-parallel steps and its fit; with `exact` and
    `pointnet` (phase 12), the launches of the exact-clustering forwards and
    requests and of the PointNet train steps, added to `launches`; with
    `datagen` (phase 13), the launches of the rendered view's predict_depth
    and of the train steps on the ingested clouds, added to `launches`; with
    `tools` (phase 14), the forward launches of eval_parity's batches and
    visu's requests, added to the forward's `launches`."""
    flops = sum(r["flops"] * r["per_forward"] for r in rows)
    nbytes = sum(r["bytes"] * r["per_forward"] for r in rows)
    inference_bound, inference_by = _bound(flops, nbytes)
    inference = {
        "launches": launches,
        "ms": sum(r["ms"] * r["per_forward"] for r in rows),
        "device_ms": _weighted(rows, "device_ms", "per_forward"),
        "plain_ms": sum(r["plain_ms"] * r["per_forward"] for r in rows),
        "bound_ms": inference_bound,
        "bound_by": inference_by,
        "bound_fp32_ms": _bound(flops, nbytes, PEAK_FP32_FLOPS)[0],
        "max_abs_err": max(r["max_abs_err"] for r in rows + entry_rows),
        "work": "the 53 backbone convs of one bench-cloud forward (B = 1)",
        "shapes": [
            {k: r[k] for k in ("level", "cin", "cout", "V", "pairs", "per_forward",
                               "ms", "device_ms", "plain_ms", "bound_ms", "bound_fp32_ms")}
            for r in rows
        ],
    }
    sources = {"fwd": ("subm_conv", "gapartnet_tpu_torch/csrc/subm_conv.cu",
                       "gapartnet_tpu/ops/pallas_conv.py:32"),
               "dgrad": ("subm_conv_dgrad", "gapartnet_tpu_torch/csrc/subm_conv.cu",
                         "gapartnet_tpu/ops/pallas_conv.py:95"),
               "wgrad": ("subm_conv_wgrad", "gapartnet_tpu_torch/csrc/subm_conv_wgrad.cu",
                         "gapartnet_tpu/ops/pallas_conv.py:105")}
    kernels = []
    for kind, (kname, source, replaces) in sources.items():
        kflops = sum(r["flops"] * r["per_step"][kind] for r in train_rows)
        kbytes = sum(r["bytes"] * r["per_step"][kind] for r in train_rows)
        bound, by = _bound(kflops, kbytes)
        entry_ = {
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train_launches[kind],
            "max_abs_err": max(r[kind]["max_abs_err"] for r in train_rows),
            "ms": sum(r[kind]["ms"] * r["per_step"][kind] for r in train_rows),
            "device_ms": _weighted([dict(r[kind], per=r["per_step"][kind]) for r in train_rows],
                                   "device_ms", "per"),
            "plain_ms": sum(r[kind]["plain_ms"] * r["per_step"][kind] for r in train_rows),
            "bound_ms": bound, "bound_by": by,
            "bound_fp32_ms": _bound(kflops, kbytes, PEAK_FP32_FLOPS)[0], "library_ms": None,
            "per_step": LAUNCHES_PER_STEP[kind],
            "work": f"the {LAUNCHES_PER_STEP[kind]} {kind} launches of one B = {TRAIN_BATCH} "
                    f"train step ({TIMED_STEPS} steps counted)",
            "shapes": [
                {"net": r["net"], "level": r["level"], "cin": r["cin"], "cout": r["cout"],
                 "B": r["B"], "V": r["V"], "pairs": r["pairs"], "per_step": r["per_step"][kind],
                 "ms": r[kind]["ms"], "device_ms": r[kind]["device_ms"],
                 "plain_ms": r[kind]["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_fp32_ms": r["bound_fp32_ms"]}
                for r in train_rows if r["per_step"][kind]
            ],
        }
        if kind == "fwd":
            entry_["inference"] = inference
            entry_["inference_api"] = api
        if fit is not None:
            entry_["fit"] = {
                "launches": fit["fit"]["launches"][kind],
                "per_step": {e: n[kind] for e, n in fit["fit"]["per_step"].items()},
                "per_eval_forward": EVAL_FORWARD_LAUNCHES[kind],
                "steps": fit["fit"]["steps"], "eval_forwards": fit["fit"]["eval_forwards"],
                "frozen_launches": fit["frozen"]["launches"][kind],
                "frozen_per_step": fit["frozen"]["per_step"][kind],
                "max_abs_err": fit["fit"]["max_abs_err"][kind],
                "work": f"trainer.fit at B = {FIT_BATCH}: 2 epochs of {FIT_TRAIN_CLOUDS // FIT_BATCH} "
                        "steps (schedule [0, 1]) and a validation of 3 splits after each (one "
                        f"padded batch of {FIT_VAL_BATCH} per split)",
            }
            entry_["max_abs_err"] = max(entry_["max_abs_err"], fit["fit"]["max_abs_err"][kind])
            if kind == "fwd":
                entry_["fit"].update({k: fit["fit"][k] for k in (
                    "step_ms", "step_ms_window", "split_ms", "save_ms", "eval_forward_ms",
                    "epoch_time_s")})
        if dp is not None:
            entry_["dp"] = {
                "launches": [r["step"]["launches"][kind] for r in dp],
                "per_step": LAUNCHES_PER_STEP[kind], "steps": DP_TIMED_STEPS,
                "fit_launches": [r["fit"]["launches"][kind] for r in dp],
                "fit_steps": [r["fit"]["steps"] for r in dp],
                "max_abs_err": max(r["step"]["max_abs_err"][kind] for r in dp),
                "work": f"{DP_WORLD} gloo ranks on one card, B = {DP_BATCH} each: "
                        f"{DP_TIMED_STEPS} timed train steps per rank (all stages), then "
                        f"trainer.fit for one epoch of {DP_FIT_STEPS} steps per rank",
            }
            entry_["max_abs_err"] = max(entry_["max_abs_err"], entry_["dp"]["max_abs_err"])
            if kind == "fwd":
                entry_["dp"].update({k: [r["step"][k] for r in dp] for k in (
                    "median_ms", "p10_ms", "p90_ms", "allreduces_per_step", "grad_bytes",
                    "allreduce_ms")}, first_step=dp[0]["step"]["first_step"],
                    fit_step_ms=[r["fit"]["step_ms"] for r in dp])
        if exact is not None and pointnet is not None:
            p12 = {
                "pointnet_launches": pointnet["train_launches"][kind],
                "pointnet_per_step": POINTNET_LAUNCHES_PER_STEP[kind],
                "pointnet_steps": POINTNET_STEPS,
                "pointnet_step_ms": pointnet["step_ms"],
                "max_abs_err": pointnet["max_abs_err"][kind],
                "work": f"{POINTNET_STEPS} PointNet train steps at B = {TRAIN_BATCH} (the proposal "
                        f"UNets' convs); {EXACT_FORWARDS} exact-clustering forwards and "
                        f"{EXACT_PREDICTS} exact predict requests (the 53 backbone convs each)",
            }
            if kind == "fwd":
                p12.update(exact_launches=exact["forward_launches"]["fwd"],
                           exact_predict_launches=exact["predict_launches"],
                           exact_forward_ms=exact["forward_ms"],
                           hash_forward_ms_in_turns=exact["hash_forward_ms"])
            entry_["phase12"] = p12
            entry_["launches"] += (p12["pointnet_launches"] + p12.get("exact_launches", 0)
                                   + p12.get("exact_predict_launches", 0))
            entry_["max_abs_err"] = max(entry_["max_abs_err"], p12["max_abs_err"])
        if datagen is not None:
            p13 = {
                "launches": datagen["train_launches"][kind] + datagen["trace_launches"][kind],
                "per_step": LAUNCHES_PER_STEP[kind],
                "steps": DATAGEN_STEPS + 1, "step_ms": datagen["step_ms"],
                "max_abs_err": datagen["max_abs_err"][kind],
                "work": f"{DATAGEN_STEPS} timed and 1 traced train steps at B = {DATAGEN_BATCH} on "
                        "ingested synthetic-asset views; one predict_depth on a rendered 800x800 "
                        "view (the 53 backbone convs)",
            }
            if kind == "fwd":
                p13.update(depth_launches=datagen["depth_launches"],
                           predict_depth_ms=datagen["depth_ms"])
                p13["launches"] += datagen["depth_launches"]
            entry_["phase13"] = p13
            entry_["launches"] += p13["launches"]
            entry_["max_abs_err"] = max(entry_["max_abs_err"], p13["max_abs_err"])
        if tools is not None and kind == "fwd":
            entry_["phase14"] = tools_entry(tools, kind)
            entry_["launches"] += tools["launches"][kind]
            entry_["max_abs_err"] = max(entry_["max_abs_err"], tools["max_abs_err"][kind])
        kernels.append(entry_)
    return kernels


def lap(what, since):
    """Prints the wall time since `since` and returns the time now."""
    now = time.perf_counter()
    print(f"[time] {what}: {now - since:.1f} s")
    return now


def main():
    import argparse
    import tempfile

    # cuBLAS reads it when it first makes a handle; deterministic_ops
    # (phases 11c and 12b) needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--card-runs", type=int, default=CARD_RUNS,
                        help="card steps held against the CPU step in phase 6 "
                             f"(default {CARD_RUNS})")
    parser.add_argument("--kernels-only", action="store_true",
                        help="run phases 1 and 2, the kernel half of phase 5 and phase 11a "
                             "only, print per-step and per-forward device and call ms, then "
                             "the kernel line (launches null) and the nvidia-smi line; for "
                             "comparing kernel versions in one call")
    parser.add_argument("--compare-draws", type=int, default=0, metavar="N",
                        help="build, then hold N bf16 card train steps with atomic and N "
                             "with deterministic scatter-adds against the CPU step (phase "
                             "11c's check as a distribution) and stop")
    parser.add_argument("--visu-draws", type=int, default=0, metavar="N",
                        help="build, run phase 9's fit, then hold N rotated bench clouds "
                             "through visu's default-capacity request on the card against "
                             "the CPU (phase 14c's check as a distribution) and stop")
    parser.add_argument("--port-root", type=Path, default=ROOT,
                        help="the checkout whose gapartnet_tpu_torch is measured (default: "
                             "this script's); with another, the SASS design check only prints")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    own = args.port_root.resolve() == ROOT
    sys.path.insert(0, str(args.port_root.resolve()))
    try:
        from gapartnet_tpu_torch.config import GAPartNetConfig
        from gapartnet_tpu_torch.entry import bench_cloud_setup, train_setup, use_fp32_math
        from gapartnet_tpu_torch.models.gapartnet import prepare_input_grid
        from gapartnet_tpu_torch.ops import subm_conv as sc
        from gapartnet_tpu_torch.ops.sparse_conv import build_hierarchy
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        sys.exit(1)

    # phase 1: the card, the toolchain, the build
    start = t = time.perf_counter()
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, nvcc: {nvcc_version(sc.find_nvcc())}")
    t0 = time.perf_counter()
    libs = sc.build()
    print(f"[build] {sc.__file__}: {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    for line in sc.build_log().splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            print(f"[build] {line.strip()}")
    for lib in libs.values():
        for kname, ops in sass_counts(lib).items():
            print(f"[build] sass {lib.name.split('-')[0]} {kname}: " +
                  ", ".join(f"{op} {n}" for op, n in ops.items()))
            if own and kname.startswith(("subm_conv_fwd_kernel", "subm_conv_wgrad_kernel")) and not (
                    ops["HMMA"] + ops["HGMMA"] and ops["LDGSTS"] + ops["UBLKCP"]):
                raise AssertionError(f"{kname} uses no tensor-core or no asynchronous-copy "
                                     f"instruction: {ops}")
            if own and kname.startswith(BF16_KERNELS) and not ops["HGMMA"]:
                raise AssertionError(f"{kname} has no wgmma (HGMMA): {ops}")
    use_fp32_math()
    t = lap("phase 1 (build)", t)
    if args.compare_draws:
        phase_compare_draws(args.compare_draws, smi)
        lap("compare draws", t)
        print(smi)
        return
    if args.visu_draws:
        phase_visu_draws(args.visu_draws, smi)
        lap("visu draws", t)
        print(smi)
        return

    # phase 2: kernel vs plain on every backbone shape of the real hierarchy
    cfg, batch, cluster_sem, cluster_off = bench_cloud_setup(GAPartNetConfig(), device="cuda")
    print(f"[setup] bench cloud capacities {cfg.input_capacities()}, extent "
          f"{cfg.input_grid_extent}, node cap {cfg.hash_node_capacity}, cand cap "
          f"{cfg.hash_cand_cap}, degree {cfg.hash_max_degree}, dense pool "
          f"{cfg.dense_grid_capacity}")
    keys, _, nvox, _ = prepare_input_grid(batch.points, batch.point_mask, cfg)
    hierarchy = build_hierarchy(keys, nvox, cfg.input_capacities(), extent=cfg.input_grid_extent)
    print(f"[setup] voxels per level {[int(lv.num_voxels[0]) for lv in hierarchy.levels]}")
    rows = phase_kernels(cfg, hierarchy, "cuda")
    t = lap("phase 2 (kernels vs plain)", t)

    if not args.kernels_only:
        # phase 3: the flagship forward on the card
        model, out, launches, times = phase_forward(cfg, batch, cluster_sem, cluster_off, smi)
        phase_profile(lambda: run_forward(model, batch, cluster_sem, cluster_off),
                      statistics.median(times))
        entry_rows = phase_entry()
        t = lap("phase 3 (forward)", t)

        # phase 4: the same forward on the CPU
        phase_compare(cfg, batch, cluster_sem, cluster_off, model, out)
        t = lap("phase 4 (forward vs CPU)", t)

    # phase 5: training, the second slice's main path, on B = 8 rotated clouds
    tcfg, tbatch, tsem, toff = train_setup(GAPartNetConfig(), batch_size=TRAIN_BATCH, device="cuda")
    tkeys, _, tnvox, _ = prepare_input_grid(tbatch.points, tbatch.point_mask, tcfg)
    thier = build_hierarchy(tkeys, tnvox, tcfg.input_capacities(), extent=tcfg.input_grid_extent)
    print(f"[train setup] B={TRAIN_BATCH} capacities {tcfg.input_capacities()}, extent "
          f"{tcfg.input_grid_extent}, node cap {tcfg.hash_node_capacity}, cand cap "
          f"{tcfg.hash_cand_cap}, degree {tcfg.hash_max_degree}; voxels per level (max over B) "
          f"{[int(lv.num_voxels.max()) for lv in thier.levels]}")
    shapes = train_conv_shapes(tcfg, thier, proposal_geometry(tcfg, tbatch, tsem, toff))
    train_rows = phase_train_kernels(shapes)
    if args.kernels_only:
        # the bf16 kernels at the same shapes: the forward at the bare
        # forward's, all three at the train step's
        kernel_sums("kernels-only", train_rows, ("fwd", "dgrad", "wgrad"),
                    f"per B = {TRAIN_BATCH} step", smi)
        kernel_sums("kernels-only", [dict(fwd=dict(ms=r["ms"], device_ms=r["device_ms"]),
                                          per_step={"fwd": r["per_forward"]}) for r in rows],
                    ("fwd",), "per B = 1 forward", smi)
        bf16_inf = phase_bf16_kernels(bf16_inference_shapes(cfg, hierarchy), ("fwd_bf16",),
                                      "bf16 kernel")
        bf16_train = phase_bf16_kernels(bf16_train_shapes(shapes), BF16_KINDS, "bf16 train kernel")
        kernel_sums("kernels-only", bf16_train, BF16_KINDS, f"per B = {TRAIN_BATCH} step", smi)
        kernel_sums("kernels-only", bf16_inf, ("fwd_bf16",), "per B = 1 forward", smi)
        numbers = dict(inf_rows=bf16_inf, train_rows=bf16_train, forward_launches=None,
                       forward_ms=None, train_launches=dict.fromkeys(BF16_KINDS), step_ms=None,
                       ab_forward=None, ab_step=None)
        print(json.dumps({"kernels": kernel_line(rows, [], None, train_rows,
                                                 dict.fromkeys(LAUNCHES_PER_STEP))
                          + bf16_kernel_entries(numbers)}))
        print(smi)
        return
    step, train_launches, step_times = phase_train(tcfg, tbatch, tsem, toff, smi)
    phase_profile(step, statistics.median(step_times), tag="train profile",
                  what=f"one train step (B={TRAIN_BATCH})")
    t = lap("phase 5 (training)", t)

    # phase 6: one train step at B = 2, card vs CPU
    phase_train_compare(tcfg, tbatch, tsem, toff, runs=args.card_runs)
    t = lap("phase 6 (train step vs CPU)", t)

    # phase 7: the inference API (the fourth slice's main path)
    api = phase_inference_api(smi)
    t = lap("phase 7 (inference API)", t)

    # phase 9: the trainer (the fifth slice's main path); its `last` is
    # kept for phase 14
    tools_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tools_")
    last = Path(tools_tmp.name) / "fit_last"
    fit = phase_fit(smi, keep_last=last)
    t = lap("phase 9 (trainer)", t)

    # phase 10: data-parallel training (the sixth slice's main path)
    dp = phase_dp(tcfg, tbatch, tsem, toff, smi)
    t = lap("phase 10 (data parallel)", t)

    # phase 11: bf16 conv compute, bench.py's configuration (the seventh
    # slice's main path)
    bf16 = phase_bf16(statistics.median(times), smi)
    t = lap("phase 11 (bf16)", t)

    # phase 12: the model's other two configurations (the ninth slice):
    # exact clustering, and the PointNet backbone
    torch.cuda.empty_cache()
    exact = phase_exact(cfg, batch, cluster_sem, cluster_off, smi)
    pointnet = phase_pointnet(tcfg, tbatch, tsem, toff, smi)
    t = lap("phase 12 (exact clustering, PointNet)", t)

    # phase 13: dataset generation -> predict_depth -> train steps (the
    # tenth slice), in a temporary directory
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_datagen_") as tmp:
        datagen = phase_datagen(smi, tmp)
    t = lap("phase 13 (datagen, predict_depth, train steps)", t)

    # phase 14: the checkpoint tools (the eleventh slice) on phase 9's `last`
    torch.cuda.empty_cache()
    tools = phase_tools(smi, last, tools_tmp.name)
    tools_tmp.cleanup()
    t = lap("phase 14 (tools: eval_parity, visu)", t)

    # phase 15: the sustained staged-training tool and its diagnostics (the
    # twelfth slice), in a temporary directory
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sustained_") as tmp:
        sustained = phase_sustained(smi, tmp)
    lap("phase 15 (sustained_run, diagnostics)", t)
    lap("total", start)

    # phase 8: the kernel line, then the device line
    print(json.dumps({"kernels": kernel_line(rows, entry_rows, launches, train_rows,
                                             train_launches, api, fit, dp, exact, pointnet,
                                             datagen, tools)
                      + bf16_kernel_entries(bf16, tools, sustained)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
