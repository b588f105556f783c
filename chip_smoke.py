#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (`gapartnet_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from `gapartnet_tpu_torch/csrc/` (one nvcc per
source, in parallel), then:

  1. prints the card (nvidia-smi name and power limit), the torch, CUDA and
     nvcc versions and the kernel build time;
  2. holds the submanifold-conv kernel against its plain PyTorch version on
     every distinct (level, Cin, Cout) of the backbone, on the real
     hierarchy of assets/bench_cloud.npz, and times both with CUDA events
     (median of 20 launches);
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
     median of 20); then drives `train_step` (all three stages, Adam 1e-3):
     3 warm-ups and 20 timed steps, checking the launch counts per step,
     zero counters, finite losses, a moving loss and moving BN statistics;
     profiles one step;
  6. runs one train step at B = 2 on the card (four times) and on the CPU
     with the same weights, jitter and inputs: integer outputs exactly,
     losses, every parameter's gradient and the updated running statistics
     within stated tolerances, the gradients' allowing for what rounding
     alone does to them on the CPU;
  7. prints one {"kernels": [...]} JSON line, the nvidia-smi line and, last,
     the device line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero.  Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
TIMED_LAUNCHES = 20
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
    """Kernel vs plain version on every backbone shape; returns the rows
    (with CUDA-event times of both when `timed`)."""
    import torch

    from gapartnet_tpu_torch.ops.subm_conv import subm_conv, subm_conv_reference

    rows = []
    gen = torch.Generator(device=device).manual_seed(1234)
    for li, cin, cout, per_fwd in backbone_conv_shapes(cfg.channels):
        nbr = hierarchy.levels[li].subm_nbr
        v = nbr.shape[-1]
        feats = torch.randn((1, v, cin), generator=gen, device=device)
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
            print(f"[{tag}] level {li} {cin:>3}->{cout:<3} V={v:<6} pairs={pairs:<7} "
                  f"max|d| {err:.3e} (max|ref| {scale:.3e})")
            continue
        ms = cuda_ms(lambda: subm_conv(feats, nbr, w), TIMED_LAUNCHES)
        plain_ms = cuda_ms(lambda: subm_conv_reference(feats, nbr, w), TIMED_LAUNCHES)
        flops = 2 * cin * cout * pairs
        nbytes = 4 * (v * cin + 27 * v + 27 * cin * cout + v * cout)
        bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S) * 1e3
        rows.append(dict(
            level=li, cin=cin, cout=cout, V=v, pairs=pairs, per_forward=per_fwd,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            flops=flops, bytes=nbytes,
        ))
        print(f"[{tag}] level {li} {cin:>3}->{cout:<3} V={v:<6} pairs={pairs:<7} "
              f"x{per_fwd}/fwd  kernel {ms:.4f} ms  bound {bound_ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  max|d| {err:.3e} (max|ref| {scale:.3e})")
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


def _check_close(name, got, want, mask=None):
    got, want = got.cpu(), want.cpu()
    if mask is not None:
        got, want = got[mask], want[mask]
    if got.numel() == 0:
        print(f"[compare] {name}: nothing to compare")
        return
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1e-30)
    print(f"[compare] {name}: max|d| {err:.3e}, max|cpu| {scale:.3e}, n={got.numel()}")
    if not err <= FORWARD_RTOL * scale:
        raise AssertionError(f"{name}: card vs CPU max|d| {err} > {FORWARD_RTOL} * {scale}")


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


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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


def phase_train_kernels(shapes):
    """Forward, dgrad and wgrad kernels against their plain versions at
    every training shape; the wgrad twice, bitwise; CUDA-event medians of
    all six.  Returns the rows."""
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
                   bound_by=bound_by)
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
            row[kind] = dict(max_abs_err=err, max_ref=scale,
                             ms=cuda_ms(kernel, TIMED_LAUNCHES),
                             plain_ms=cuda_ms(plain, TIMED_LAUNCHES))
        rows.append(row)
        print(f"[train kernel] {sh['net']:<8} level {sh['level']} {cin:>3}->{cout:<3} B={b} V={v:<6} "
              f"pairs={pairs:<8} bound {bound_ms:.4f} ms ({bound_by})  " + "  ".join(
                  f"{k} x{sh['per_step'][k]} {row[k]['ms']:.4f}/{row[k]['plain_ms']:.4f} ms "
                  f"d {row[k]['max_abs_err']:.1e}/{row[k]['max_ref']:.1e}"
                  for k in ("fwd", "dgrad", "wgrad")))
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
    opt = adam(model.parameters(), 1e-3)
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
    """One train forward + backward on n clouds: `runs` times on the card, once on the CPU with the same weights, jitter and inputs, and once
    on the CPU per probe of PROBES.  Returns the worst gradient deviation
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


def main():
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--card-runs", type=int, default=CARD_RUNS,
                        help="card steps held against the CPU step in phase 6 "
                             f"(default {CARD_RUNS})")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
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
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, nvcc: {nvcc_version(sc.find_nvcc())}")
    t0 = time.perf_counter()
    libs = sc.build()
    print(f"[build] {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    for line in sc.build_log().splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            print(f"[build] {line.strip()}")
    use_fp32_math()

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

    # phase 3: the flagship forward on the card
    model, out, launches, times = phase_forward(cfg, batch, cluster_sem, cluster_off, smi)
    phase_profile(lambda: run_forward(model, batch, cluster_sem, cluster_off),
                  statistics.median(times))
    entry_rows = phase_entry()

    # phase 4: the same forward on the CPU
    phase_compare(cfg, batch, cluster_sem, cluster_off, model, out)

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
    step, train_launches, step_times = phase_train(tcfg, tbatch, tsem, toff, smi)
    phase_profile(step, statistics.median(step_times), tag="train profile",
                  what=f"one train step (B={TRAIN_BATCH})")

    # phase 6: one train step at B = 2, card vs CPU
    phase_train_compare(tcfg, tbatch, tsem, toff, runs=args.card_runs)

    # phase 7: the kernel line, then the device line
    flops = sum(r["flops"] * r["per_forward"] for r in rows)
    nbytes = sum(r["bytes"] * r["per_forward"] for r in rows)
    inference_bound, inference_by = _bound(flops, nbytes)
    inference = {
        "launches": launches,
        "ms": sum(r["ms"] * r["per_forward"] for r in rows),
        "plain_ms": sum(r["plain_ms"] * r["per_forward"] for r in rows),
        "bound_ms": inference_bound,
        "bound_by": inference_by,
        "max_abs_err": max(r["max_abs_err"] for r in rows + entry_rows),
        "work": "the 53 backbone convs of one bench-cloud forward (B = 1)",
        "shapes": [
            {k: r[k] for k in ("level", "cin", "cout", "V", "pairs", "per_forward",
                               "ms", "plain_ms", "bound_ms")}
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
        bound, by = _bound(sum(r["flops"] * r["per_step"][kind] for r in train_rows),
                           sum(r["bytes"] * r["per_step"][kind] for r in train_rows))
        entry_ = {
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train_launches[kind],
            "max_abs_err": max(r[kind]["max_abs_err"] for r in train_rows),
            "ms": sum(r[kind]["ms"] * r["per_step"][kind] for r in train_rows),
            "plain_ms": sum(r[kind]["plain_ms"] * r["per_step"][kind] for r in train_rows),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "per_step": LAUNCHES_PER_STEP[kind],
            "work": f"the {LAUNCHES_PER_STEP[kind]} {kind} launches of one B = {TRAIN_BATCH} "
                    f"train step ({TIMED_STEPS} steps counted)",
            "shapes": [
                {"net": r["net"], "level": r["level"], "cin": r["cin"], "cout": r["cout"],
                 "B": r["B"], "V": r["V"], "pairs": r["pairs"], "per_step": r["per_step"][kind],
                 "ms": r[kind]["ms"], "plain_ms": r[kind]["plain_ms"], "bound_ms": r["bound_ms"]}
                for r in train_rows if r["per_step"][kind]
            ],
        }
        if kind == "fwd":
            entry_["inference"] = inference
        kernels.append(entry_)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
