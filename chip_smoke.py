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
     around each call (median of 20 launches, wrapper host time included),
     and the kernel alone by its device time per launch (torch.profiler,
     median of three windows of 20 launches);
  3. drives the flagship inference forward on the card (bench-cloud
     capacities and clustering overrides, seeded random weights): 5
     warm-ups, then 100 timed requests (median and spread); it checks that
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
     median of 20) and the three kernels' device time (profiler); then
     drives `train_step` (all three stages, Adam 1e-3): 3 warm-ups and 20
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
     (3 warm-ups, 20 timed requests each), predict_depth on a depth frame
     rendered from the cloud (1 warm-up, 5 timed requests; FPS timed
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
  8. prints the wall time of each phase, one {"kernels": [...]} JSON line,
     the nvidia-smi line and, last, the device line {"ok": true, "device":
     {...}}, after phase 9;
  9. the trainer (the fifth slice's main path), in a temporary directory:
     a dataset of assets/bench_cloud.npz rotated about z (88 train clouds,
     3 per eval split, so each eval split ends in a padded batch);
     configs/gapartnet.yaml read by the port's reader with the overrides
     of FIT_OVERRIDES (8 clouds per step, widths, points and proposals not
     cut); `trainer.fit(cfg, device="cuda")` in process: 2 epochs of 11
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
     jitter generator, logs epoch 1 only) and `test` of `last`; last, one
     reduced eval step on the val split's batch of 4 (its last cloud
     padded, with no valid point) at the eval capacities with the fit's
     weights on the card and on the CPU (conf, keep, rep_cls and counters
     exactly, scores and IoUs within 1e-4, no proposal kept in the padded
     cloud; a near-tie sem flip switches to the CPU forward on the card's
     proposals, as in phase 7).

Any failure raises and exits non-zero.  Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.

To compare two versions of the kernels on one card, in one call:

    python3 chip_smoke.py --kernels-only --port-root <other checkout>
    python3 chip_smoke.py --kernels-only

runs phases 1, 2 and the kernel half of 5 on that checkout's package and
prints the kernel line (launches null) and the nvidia-smi line.
"""

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
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
# the kernels of each wrapper, as torch.profiler names them
KERNEL_NAMES = {"fwd": ("subm_conv_fwd_kernel", "sum_splits_kernel"),
                "dgrad": ("subm_conv_fwd_kernel", "sum_splits_kernel"),
                "wgrad": ("subm_conv_wgrad_kernel", "sum_chunks_kernel")}
SASS_OPS = ("HMMA", "HGMMA", "LDGSTS", "UBLKCP")
TIMED_LAUNCHES = 20
PROFILE_WINDOWS = 3
WARMUP_REQUESTS = 5
TIMED_REQUESTS = 100
CONVS_PER_FORWARD = 53
TRAIN_BATCH = 8
WARMUP_STEPS = 3
TIMED_STEPS = 20
# per train step: 53 backbone + 12 + 12 proposal-UNet convs; every conv but
# the backbone stem (whose input needs no gradient) runs a dgrad
LAUNCHES_PER_STEP = {"fwd": 77, "dgrad": 76, "wgrad": 77}
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
PREDICT_REQUESTS = 20
DEPTH_WARMUPS = 1
DEPTH_REQUESTS = 5
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
# 11 steps per epoch, so that epoch 1 times 10 steps after its first
FIT_BATCH = TRAIN_BATCH                            # the reference's 64 over 8 cards
FIT_TRAIN_CLOUDS = 11 * FIT_BATCH
FIT_EVAL_CLOUDS = 3
FIT_VAL_BATCH = 4
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
FIT_LAUNCHES_PER_STEP = {False: {"fwd": 65, "dgrad": 64, "wgrad": 65}, True: LAUNCHES_PER_STEP}
FROZEN_LAUNCHES_PER_STEP = {"fwd": 77, "dgrad": 24, "wgrad": 24}
EVAL_FORWARD_LAUNCHES = {"fwd": CONVS_PER_FORWARD, "dgrad": 0, "wgrad": 0}
FREEZE = ("backbone", "sem_seg_head", "offset_mlp0", "offset_bn", "offset_mlp1")
# card vs CPU reduced eval step: scores and IoUs
FIT_SCORE_RTOL = 1e-4
CLI_TIMEOUT_S = 600


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
                               r"sum_chunks_kernel)", m.group(1))
            name = (kernel.group(1) if kernel else m.group(1)) + "<" + ",".join(
                re.findall(r"L[ib](\d+)E", m.group(1))) + ">"
            current = counts.setdefault(name, dict.fromkeys(SASS_OPS, 0))
        elif current is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
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


def phase_forward(cfg, batch, cluster_sem, cluster_off, smi):
    """The flagship forward on the card.

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
    launches = LAUNCHES["fwd"]
    if LAUNCHES != {"fwd": CONVS_PER_FORWARD * TIMED_REQUESTS, "dgrad": 0, "wgrad": 0}:
        raise AssertionError(
            f"subm_conv launched {LAUNCHES} in {TIMED_REQUESTS} forwards, "
            f"expected {CONVS_PER_FORWARD} forward launches per forward"
        )
    counters = {k: int(v.sum()) for k, v in out.counters.items()}
    if any(counters.values()):
        raise AssertionError(f"capacity counters nonzero: {counters}")
    for name in ("sem_logits", "offset_preds", "score_preds", "npcs_preds"):
        t = getattr(out, name)
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} has non-finite values")
    print(f"[forward] counters {counters}")
    deciles = statistics.quantiles(times, n=10)
    print(f"[forward] ms per cloud over {TIMED_REQUESTS} requests: "
          f"median {statistics.median(times):.3f}, p10 {deciles[0]:.3f}, "
          f"p90 {deciles[-1]:.3f}, min {min(times):.3f}, max {max(times):.3f}  ({smi})")
    print(f"[forward] proposals {out.proposals.num_proposals.tolist()}, "
          f"subm_conv launches {launches} ({launches // TIMED_REQUESTS} per forward)")
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
    if LAUNCHES != {"fwd": CONVS_PER_FORWARD, "dgrad": 0, "wgrad": 0}:
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


def _check_close(name, got, want, mask=None, rtol=FORWARD_RTOL):
    got, want = got.cpu(), want.cpu()
    if mask is not None:
        got, want = got[mask], want[mask]
    if got.numel() == 0:
        print(f"[compare] {name}: nothing to compare")
        return
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1e-30)
    print(f"[compare] {name}: max|d| {err:.3e}, max|cpu| {scale:.3e}, n={got.numel()}")
    if not err <= rtol * scale:
        raise AssertionError(f"{name}: card vs CPU max|d| {err} > {rtol} * {scale}")


def _check_equal(name, got, want):
    import torch

    if not torch.equal(got.cpu(), want.cpu()):
        n = int((got.cpu() != want.cpu()).sum())
        raise AssertionError(f"{name}: card and CPU differ at {n} entries")


def phase_compare(cfg, batch, cluster_sem, cluster_off, model_gpu, out_gpu):
    """The same forward on the CPU; integers exact, floats within tolerance."""
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

    _check_close("sem_logits", out_gpu.sem_logits, out_cpu.sem_logits)
    _check_close("offset_preds", out_gpu.offset_preds, out_cpu.offset_preds)
    # argmax may flip only at near-ties of the two largest logits
    lc = out_cpu.sem_logits.cpu()
    flip = out_gpu.sem_preds.cpu() != out_cpu.sem_preds.cpu()
    print(f"[compare] sem_preds differing: {int(flip.sum())} of {flip.numel()}")
    if flip.any():
        top2 = lc[flip].topk(2, dim=-1).values
        tol = FORWARD_RTOL * float(lc.abs().max())
        if not bool(((top2[:, 0] - top2[:, 1]) <= 2 * tol).all()):
            raise AssertionError("sem_preds differ at a point that is not a near-tie")
    # a proposal's class is the sem pred at its representative point
    sem_agree = out_gpu.proposal_sem.cpu() == out_cpu.proposal_sem.cpu()
    n_sem = int((~sem_agree & prop_ok).sum())
    print(f"[compare] proposal classes differing: {n_sem}")
    if n_sem > int(flip.sum()):
        raise AssertionError("proposal classes differ beyond the sem_preds near-ties")
    prop_ok &= sem_agree
    _check_close("score_logits", out_gpu.score_logits, out_cpu.score_logits, prop_ok)
    _check_close("score_preds", out_gpu.score_preds, out_cpu.score_preds, prop_ok)
    ep = out_cpu.proposals.entry_point.cpu().long()
    bidx = torch.arange(ep.shape[0])[:, None]
    entry_ok = out_cpu.proposals.entry_mask.cpu() & ~flip[bidx, ep]
    entry_ok &= prop_ok[bidx, pid.clamp(min=0).long()]
    _check_close("npcs_preds", out_gpu.npcs_preds, out_cpu.npcs_preds, entry_ok)


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
    grid.  The backbone stem's input needs no gradient, so it has no dgrad."""
    out = []
    for li, cin, cout, per in backbone_conv_shapes(cfg.channels, cfg.in_channels):
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


def phase_train(cfg, batch, cluster_sem, cluster_off, smi):
    """train_step on the card: warm-ups, then timed steps with the launch
    counts read around them.  Returns (model, optimizer, generator,
    launches, ms per step)."""
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

    history = [step() for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    reset_launches()
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        history.append(step())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(LAUNCHES)
    want = {k: n * TIMED_STEPS for k, n in LAUNCHES_PER_STEP.items()}
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
    print(f"[train] B={batch.batch_size} ms per step over {TIMED_STEPS} steps: median {med:.3f}, "
          f"p10 {deciles[0]:.3f}, p90 {deciles[-1]:.3f}, min {min(times):.3f}, "
          f"max {max(times):.3f}; {batch.batch_size / med * 1e3:.2f} clouds/s  ({smi})")
    print(f"[train] launches in {TIMED_STEPS} steps {launches} "
          f"(per step {dict((k, v // TIMED_STEPS) for k, v in launches.items())}); "
          f"all counters 0; {moved} BN running statistics moved")
    print("[train] step 1: " + ", ".join(f"{k} {float(v):.4f}" for k, v in history[0].items()
                                         if not k.startswith("counters/")))
    print(f"[train] step {len(history)}: " + ", ".join(
        f"{k} {float(v):.4f}" for k, v in history[-1].items() if not k.startswith("counters/")))
    return step, launches, times


def _first(batch, n):
    """The first n clouds of a batch."""
    import torch

    return type(batch)(**{
        f.name: (getattr(batch, f.name)[:n] if isinstance(getattr(batch, f.name), torch.Tensor)
                 else getattr(batch, f.name)[:n] if isinstance(getattr(batch, f.name), list)
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


def phase_train_compare(cfg, batch, cluster_sem, cluster_off, n=2, runs=CARD_RUNS):
    """One train forward + backward on n clouds: `runs` times on the card,
    once on the CPU with the same weights, jitter and inputs, and once on
    the CPU per probe of PROBES.  Returns the worst gradient deviation
    over the card runs (max|d| / scale) and the worst running-statistics
    deviation (max|d| / max|cpu|)."""
    import torch

    from gapartnet_tpu_torch.models.gapartnet import prepare_input_grid
    from gapartnet_tpu_torch.ops.sparse_conv import build_hierarchy

    jitter = torch.rand((2, 3), generator=torch.Generator().manual_seed(7))
    sub, sem, off = _first(batch, n), cluster_sem[:n], cluster_off[:n]

    def run(dev, what, probe=None):
        t0 = time.perf_counter()
        res = _train_pass(cfg, sub, dev, sem, off, jitter, probe)
        if dev == "cuda":
            torch.cuda.synchronize()
        print(f"[train compare] {what} at B={n}: {time.perf_counter() - t0:.2f} s")
        return res

    mc, oc, bc = run("cpu", "cpu step")
    cards = [run("cuda", f"card step {r + 1}") for r in range(runs)]
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
    for r, (_, og, _) in enumerate(cards):
        _check_same_graph(f"card step {r + 1}", og, oc)
    print(f"[train compare] voxel keys, rulebooks, downsample maps; in all {runs} card steps: "
          "proposals, proposal-grid keys and rulebooks, entry_voxel_id, sem_preds, proposal "
          "classes, npcs_valid, ious: identical to the CPU's")
    # a probe may flip an argmax near-tie of sem_preds (and with it
    # npcs_valid); the proposals and grids it must not change
    for i, (_, op, _) in enumerate(probes):
        _check_same_graph(f"probe {i + 1}", op, oc, fields=("entry_voxel_id", "proposal_sem", "ious"))
        flips = int((op.sem_preds != oc.sem_preds).sum())
        print(f"[train compare] probe {i + 1}: proposals and grids as the CPU step's; "
              f"sem_preds differing at {flips} points")

    for k in oc.LOSSES:
        b = float(getattr(oc, k).detach())
        got = [float(getattr(og, k).detach()) for _, og, _ in cards]
        worst_loss = max(abs(a - b) for a in got)
        print(f"[train compare] {k}: cpu {b:.7f}, card {', '.join(f'{a:.7f}' for a in got)}, "
              f"max|d| {worst_loss:.2e}")
        if not worst_loss <= LOSS_RTOL * max(abs(b), 1.0):
            raise AssertionError(f"{k}: card {got} vs CPU {b}")

    grads_c = {k: p.grad for k, p in mc.named_parameters()}
    top = max(float(g.abs().max()) for g in grads_c.values())
    scale = {k: max(float(g.abs().max()), GRAD_FLOOR * top) for k, g in grads_c.items()}
    grads_p = [{k: p.grad for k, p in mp.named_parameters()} for mp, _, _ in probes]
    own = {k: max(float((gp[k] - g).abs().max()) for gp in grads_p) for k, g in grads_c.items()}
    steady = [k for k in grads_c if own[k] <= GRAD_RTOL * scale[k]]
    print(f"[train compare] {len(grads_c)} parameter gradients; the probes move "
          f"{len(grads_c) - len(steady)} of them by more than {GRAD_RTOL} of their scale, the "
          "five most (max over probes / scale): " + "; ".join(
              f"{k} {own[k] / scale[k]:.2e}"
              for k in sorted(grads_c, key=lambda k: own[k] / scale[k], reverse=True)[:5]))
    failures, worst = [], 0.0
    for r, (mg, _, _) in enumerate(cards):
        ratio, worst_steady = {}, (0.0, "")
        for k, p in mg.named_parameters():
            err = float((p.grad.cpu() - grads_c[k]).abs().max())
            allowed = GRAD_RTOL * scale[k] + KINK_FACTOR * own[k]
            ratio[k] = err / allowed
            worst = max(worst, err / scale[k])
            if k in steady:
                worst_steady = max(worst_steady, (err / scale[k], k))
            if err > allowed:
                failures.append(f"card step {r + 1}, grad {k}: max|d| {err} > {GRAD_RTOL} * "
                                f"{scale[k]} + {KINK_FACTOR} * {own[k]}")
        k = max(ratio, key=ratio.get)
        print(f"[train compare] card step {r + 1}: worst max|d| / allowed {ratio[k]:.3f} ({k}); "
              f"among the {len(steady)} tensors the probes leave within {GRAD_RTOL}: worst "
              f"max|d| / scale {worst_steady[0]:.3e} ({worst_steady[1]})")
    if failures:
        raise AssertionError("card vs CPU gradients:\n" + "\n".join(failures))

    sc_ = mc.state_dict()
    worst_stats = (0.0, "")
    for r, (mg, _, _) in enumerate(cards):
        sg_ = mg.state_dict()
        for k in sc_:
            if "running_" not in k:
                continue
            err = float((sg_[k].cpu() - sc_[k]).abs().max())
            scale_k = float(sc_[k].abs().max())
            if not err <= STATS_RTOL * scale_k:
                raise AssertionError(f"card step {r + 1}, {k}: card vs CPU max|d| {err} > "
                                     f"{STATS_RTOL} * {scale_k}")
            worst_stats = max(worst_stats, (err / scale_k, k))
    print(f"[train compare] running statistics: worst max|d| / max|cpu| {worst_stats[0]:.3e} "
          f"({worst_stats[1]}), tolerance {STATS_RTOL}")
    return worst, worst_stats[0]


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
    if launches != {"fwd": CONVS_PER_FORWARD * requests, "dgrad": 0, "wgrad": 0}:
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


def _near_ties(name, got, want_logits):
    """sem_preds may differ only where the CPU's two largest logits are
    within the forward's tolerance of each other."""
    want = want_logits.argmax(dim=-1)
    flip = got != want
    if flip.any():
        top2 = want_logits[flip].topk(2, dim=-1).values
        tol = FORWARD_RTOL * float(want_logits.abs().max())
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
    flipped point picks the class) and counters."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    c = cpu._request(pts, proposals_cpu)
    print(f"[{tag} compare] CPU request {time.perf_counter() - t0:.1f} s")
    g = card_req
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
        print(f"[{tag} compare] the stages after the forward compared from the card's forward "
              "outputs")
    else:
        for k, v in c.out.counters.items():
            _check_equal(f"{tag}: counter {k}", g.out.counters[k], v)
        for f in c.out.proposals._fields:
            _check_equal(f"{tag}: proposals.{f}", getattr(g.out.proposals, f),
                         getattr(c.out.proposals, f))
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
        return
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


def write_fit_dataset(root):
    """The fit's dataset under `root`, in the .npz layout load_cloud_file
    reads: assets/bench_cloud.npz rotated about z (entry.rotation_z), the
    train split at FIT_TRAIN_CLOUDS angles 2 pi i / FIT_TRAIN_CLOUDS, each
    eval split at FIT_EVAL_CLOUDS of the angles half-way between."""
    import numpy as np

    from gapartnet_tpu_torch.entry import BENCH_CLOUD, rotation_z

    d = np.load(BENCH_CLOUD)
    step = 2 * np.pi / FIT_TRAIN_CLOUDS
    angles = {"train": [i * step for i in range(FIT_TRAIN_CLOUDS)]}
    for si, split in enumerate(("val", "test_intra", "test_inter")):
        angles[split] = [(si * FIT_EVAL_CLOUDS + j + 0.5) * step for j in range(FIT_EVAL_CLOUDS)]
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


def run_cli(tag, args, cwd):
    """`python -m gapartnet_tpu_torch.train.cli <args>` in `cwd`, on the
    card (no --device), as a user runs it; returns its stdout."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p))
    cwd.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "gapartnet_tpu_torch.train.cli", *args], cwd=cwd,
                       env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    print(f"[{tag}] python -m gapartnet_tpu_torch.train.cli {args[0]} ...: exit {r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    if r.returncode != 0:
        raise AssertionError(f"{tag}: the CLI failed:\n{r.stdout[-3000:]}\n{r.stderr[-5000:]}")
    return r.stdout


def fit_kernels(cfg, model, train_raw, val_raw):
    """The forward, dgrad and wgrad kernels against their plain versions at
    the fit's own shapes: the backbone hierarchy of a fit train batch
    (`train_raw`, at the fit's auto_capacity levels) and the proposal grid
    of a train forward on it (clustering on the fitted sem head, on a copy
    of `model` so that its running statistics stay), and the forward at
    every backbone shape of the eval model's hierarchy of `val_raw` (the
    val split's padded batch).  Returns the largest max|d| of each
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
    print(f"[fit kernel] B={batch.batch_size} train batch: voxels per level (max over B) "
          f"{[int(lv.num_voxels.max()) for lv in hier.levels]} of {mcfg.input_capacities()}; live "
          f"proposals {out.proposals.num_proposals.tolist()}, proposal voxels "
          f"{prop.levels[0].num_voxels.tolist()} of {mcfg.proposal_capacities()}")
    rows = phase_train_kernels(train_conv_shapes(mcfg, hier, prop), tag="fit kernel", timed=False)
    err = {k: max(r[k]["max_abs_err"] for r in rows) for k in ("fwd", "dgrad", "wgrad")}
    ecfg = eval_capacity_config(mcfg)
    ehier = hierarchy(ecfg, PointCloudBatch.from_numpy(val_raw, "cuda"))
    print(f"[fit eval kernel] B={val_raw['points'].shape[0]} val batch (the last cloud padded): "
          f"voxels per level {[lv.num_voxels.tolist() for lv in ehier.levels]}")
    erows = phase_kernels(ecfg, ehier, "cuda", tag="fit eval kernel", timed=False)
    err["fwd"] = max(err["fwd"], *(r["max_abs_err"] for r in erows))
    return err


def compare_fit_eval(cfg, model, device_batch, cpu_batch):
    """One reduced eval step (trainer.reduce_eval_outputs of an eval
    forward) on the card and on the CPU with the same weights, on every
    cloud of the batch: conf, accuracies, keep, rep_cls and counters
    exactly, scores and IoUs within FIT_SCORE_RTOL of scale.  On a near-tie
    sem flip (which changes the clustering) the CPU runs its forward on the
    card's proposals instead, and the selection on the card's outputs."""
    import torch

    from gapartnet_tpu_torch.config import eval_capacity_config
    from gapartnet_tpu_torch.models.gapartnet import GAPartNet
    from gapartnet_tpu_torch.train.loop import eval_step
    from gapartnet_tpu_torch.train.trainer import cpu_tree, host_copy, reduce_eval_outputs

    ecfg = eval_capacity_config(cfg.model)
    card = model.with_config(ecfg)
    cpu = GAPartNet(ecfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    flags = dict(do_cluster=True, do_score=True, do_npcs=True)
    out_g = eval_step(card, device_batch, **flags)
    rg = host_copy(reduce_eval_outputs(out_g, device_batch, ecfg, True))
    t0 = time.perf_counter()
    out_c = eval_step(cpu, cpu_batch, **flags)
    print(f"[fit compare] CPU eval forward {time.perf_counter() - t0:.1f} s")
    flips = _near_ties("fit compare", out_g.sem_preds.cpu(), out_c.sem_logits)
    print(f"[fit compare] sem_preds differing: {flips} of {out_c.sem_preds.numel()}")
    if flips:
        conf_c = host_copy(reduce_eval_outputs(out_c, cpu_batch, ecfg, False))["conf"]
        moved = float(abs(rg["conf"] - conf_c).sum())
        if moved > 2 * flips:
            raise AssertionError(f"fit compare: conf moved by {moved} for {flips} flipped points")
        with torch.no_grad():
            ref = cpu(cpu_batch, **flags, proposals_override=cpu_tree(out_g.proposals))
        rc = host_copy(reduce_eval_outputs(cpu_tree(out_g), cpu_batch, ecfg, True))
        for k in [k for k in rg if k.startswith("counters/")]:
            rc[k] = ref.counters[k.split("/", 1)[1]].sum().to(torch.float32).numpy()
        same = (out_g.proposal_sem.cpu() == ref.proposal_sem).numpy()
        rc["scores"], rc["ious"] = ref.score_preds.numpy(), ref.ious.numpy()
        mask = {"scores": same, "ious": same}
        print("[fit compare] compared through the CPU forward on the card's proposals")
    else:
        rc = host_copy(reduce_eval_outputs(out_c, cpu_batch, ecfg, True))
        mask = {}
    for k in rg:
        if k in ("scores", "ious"):
            got, want = torch.from_numpy(rg[k]), torch.from_numpy(rc[k])
            m = mask.get(k)
            _check_close(f"fit compare: {k}", got, want,
                         None if m is None else torch.from_numpy(m), rtol=FIT_SCORE_RTOL)
        elif k in ("all_accu", "pixel_accu", "conf") and flips:
            continue
        else:
            _check_equal(f"fit compare: {k}", torch.as_tensor(rg[k]), torch.as_tensor(rc[k]))
    pad = ~cpu_batch.point_mask.any(dim=1).numpy()
    if rg["keep"][pad].any():
        raise AssertionError(f"fit compare: a padded cloud kept {int(rg['keep'][pad].sum())} "
                             "proposals")
    counters = {k: float(v) for k, v in rg.items() if k.startswith("counters/")}
    print(f"[fit compare] B={len(pad)} ({int(pad.sum())} padded): card and CPU agree on conf, keep "
          f"({rg['keep'].sum(axis=1).tolist()} kept per cloud), rep_cls, counters {counters} "
          f"exactly; scores and IoUs within {FIT_SCORE_RTOL}")


def phase_fit(smi):
    """The fifth slice: fit, a frozen-trunk epoch, the CLI's resume and
    test, and a reduced eval step against the CPU.  Returns the launch
    counts and times for the kernel line."""
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
        if not all(launches.values()):
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

        # a frozen-trunk epoch warm-started from `last`
        last = tmp / "fit" / "checkpoints" / "last"
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
        out = run_cli("fit resume", ["fit", *base, "--trainer.ckpt_path", str(epoch0)], tmp / "resume")
        want = (f"at epoch 1 (step {saved['step']}, gstep {saved['gstep']}, jitter generator state "
                f"crc32 {crc:08x})")
        if want not in out:
            raise AssertionError(f"fit resume: no '{want}' in its output:\n{out[-2000:]}")
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

        compare_fit_eval(cfg, state.model, PointCloudBatch.from_numpy(val_raw, "cuda"),
                         PointCloudBatch.from_numpy(val_raw, "cpu"))
    return numbers


def kernel_line(rows, entry_rows, launches, train_rows, train_launches, api=None, fit=None):
    """The {"kernels": [...]} entries: per kernel, its launches in the main
    path's run (None when it did not run), its times summed over one B = 8
    train step (forward: with the 53 inference convs beside them, and the
    launches and times of the inference API's requests, `api`), bounds and
    errors, and its per-shape rows; with `fit`, each kernel's launches in
    phase 9's fit and frozen-trunk runs."""
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
        kernels.append(entry_)
    return kernels


def lap(what, since):
    """Prints the wall time since `since` and returns the time now."""
    now = time.perf_counter()
    print(f"[time] {what}: {now - since:.1f} s")
    return now


def main():
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--card-runs", type=int, default=CARD_RUNS,
                        help="card steps held against the CPU step in phase 6 "
                             f"(default {CARD_RUNS})")
    parser.add_argument("--kernels-only", action="store_true",
                        help="run phases 1 and 2 and the kernel half of phase 5 only, then "
                             "print the kernel line (launches null) and the nvidia-smi line; "
                             "for comparing kernel versions in one call")
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
    use_fp32_math()
    t = lap("phase 1 (build)", t)

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
        print(json.dumps({"kernels": kernel_line(rows, [], None, train_rows,
                                                 dict.fromkeys(LAUNCHES_PER_STEP))}))
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

    # phase 9: the trainer (the fifth slice's main path)
    fit = phase_fit(smi)
    lap("phase 9 (trainer)", t)
    lap("total", start)

    # phase 8: the kernel line, then the device line
    print(json.dumps({"kernels": kernel_line(rows, entry_rows, launches, train_rows,
                                             train_launches, api, fit)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
