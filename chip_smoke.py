#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (`gapartnet_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from `gapartnet_tpu_torch/csrc/`, then:

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
  5. prints one {"kernels": [...]} JSON line and, last, the device line
     {"ok": true, "device": {...}}.

Any failure raises and exits non-zero.  Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.
"""

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
# kernel vs plain: fp32 both, only the summation order differs
KERNEL_RTOL = 1e-4
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


def backbone_conv_shapes(channels):
    """[(level, Cin, Cout, launches per forward)] of the SparseUNet's convs."""
    last = len(channels) - 1
    shapes = [(0, 6, channels[0], 1)]
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
    return model(batch, do_cluster=True, do_score=True, do_npcs=True,
                 cluster_sem_override=cluster_sem, cluster_offset_override=cluster_off)


def phase_forward(cfg, batch, cluster_sem, cluster_off, smi):
    """The flagship forward on the card.

    Returns (model, last output, kernel launches counted over the timed
    requests, ms per request)."""
    import torch

    from gapartnet_tpu_torch.entry import make_model
    from gapartnet_tpu_torch.ops.subm_conv import subm_conv

    model = make_model(cfg, "cuda", seed=0)
    for _ in range(WARMUP_REQUESTS):
        run_forward(model, batch, cluster_sem, cluster_off)
    torch.cuda.synchronize()
    subm_conv.launches = 0
    times = []
    for _ in range(TIMED_REQUESTS):
        t0 = time.perf_counter()
        out = run_forward(model, batch, cluster_sem, cluster_off)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = subm_conv.launches
    if launches != CONVS_PER_FORWARD * TIMED_REQUESTS:
        raise AssertionError(
            f"subm_conv launched {launches} times in {TIMED_REQUESTS} forwards, "
            f"expected {CONVS_PER_FORWARD} per forward"
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
    from gapartnet_tpu_torch.ops.subm_conv import subm_conv

    fn, (batch,) = entry()
    cfg = GAPartNetConfig()
    keys, _, nvox, _ = prepare_input_grid(batch.points, batch.point_mask, cfg)
    hierarchy = build_hierarchy(keys, nvox, cfg.input_capacities(), extent=cfg.input_grid_extent)
    print(f"[entry] capacities {cfg.input_capacities()}, extent {cfg.input_grid_extent}, "
          f"voxels per level {[int(lv.num_voxels[0]) for lv in hierarchy.levels]}")
    rows = phase_kernels(cfg, hierarchy, "cuda", tag="entry kernel", timed=False)
    subm_conv.launches = 0
    t0 = time.perf_counter()
    outs = fn(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if subm_conv.launches != CONVS_PER_FORWARD:
        raise AssertionError(f"entry(): subm_conv launched {subm_conv.launches} times")
    if not all(bool(torch.isfinite(t.float()).all()) for t in outs):
        raise AssertionError("entry(): non-finite outputs")
    print(f"[entry] entry() forward on a synthetic cloud: {ms:.1f} ms (first call), "
          f"{subm_conv.launches} subm_conv launches, "
          f"outputs {[tuple(t.shape) for t in outs]}")
    return rows


def phase_profile(model, batch, cluster_sem, cluster_off, request_ms):
    """Device time by kernel over one forward (torch.profiler, CUDA activity
    only).  The idle share is taken against `request_ms`, the median wall of
    the unprofiled requests."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_forward(model, batch, cluster_sem, cluster_off)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        print("[profile] device time not measured (profiler saw no kernels)")
        return
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    launches = sum(e.count for e in events)
    print(f"[profile] one forward: kernel time {busy_ms:.3f} ms in {launches} kernel "
          f"launches; idle share {1 - busy_ms / request_ms:.3f} of the median "
          f"unprofiled request ({request_ms:.3f} ms); profiled wall {wall_ms:.3f} ms")
    for e in events[:15]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} {e.key[:90]}")


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    try:
        from gapartnet_tpu_torch.config import GAPartNetConfig
        from gapartnet_tpu_torch.entry import bench_cloud_setup, use_fp32_math
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
    lib = sc.build()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
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
    phase_profile(model, batch, cluster_sem, cluster_off, statistics.median(times))
    entry_rows = phase_entry()

    # phase 4: the same forward on the CPU
    phase_compare(cfg, batch, cluster_sem, cluster_off, model, out)

    # phase 5: the kernel line, then the device line
    flops = sum(r["flops"] * r["per_forward"] for r in rows)
    nbytes = sum(r["bytes"] * r["per_forward"] for r in rows)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    kernel = {
        "name": "subm_conv",
        "route": "cuda",
        "source": "gapartnet_tpu_torch/csrc/subm_conv.cu",
        "replaces": "gapartnet_tpu/ops/pallas_conv.py:32",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows + entry_rows),
        "ms": sum(r["ms"] * r["per_forward"] for r in rows),
        "plain_ms": sum(r["plain_ms"] * r["per_forward"] for r in rows),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "per_forward": CONVS_PER_FORWARD,
        "work": "the 53 backbone convs of one bench-cloud forward",
        "shapes": [
            {k: r[k] for k in ("level", "cin", "cout", "V", "pairs", "per_forward",
                               "ms", "plain_ms", "bound_ms")}
            for r in rows
        ],
    }
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
