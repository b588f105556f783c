"""Entry points: the flagship inference forward, and the bench-cloud setup.

`entry` mirrors `__graft_entry__.entry` of the JAX package: the flagship
model (`GAPartNetConfig()` defaults: channels 16..112, 20000 points) with
seeded random weights, eval mode, clustering, ScoreNet and NPCSNet on.
`bench_cloud_setup` ports `bench.py`'s `real_cloud_setup`: the committed
real cloud with capacities fitted to it and the trained-operating-point
clustering overrides.
"""

import dataclasses
from pathlib import Path

import numpy as np
import torch

from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.data.capacity import (
    _counts_and_span,
    _hash_components,
    _hash_connected_degree,
    _hash_occupancy,
)
from gapartnet_tpu_torch.data.synthetic import synthetic_batch
from gapartnet_tpu_torch.models.gapartnet import GAPartNet
from gapartnet_tpu_torch.structures import PointCloudBatch
from gapartnet_tpu_torch.weights import init_weights

BENCH_CLOUD = Path(__file__).resolve().parent.parent / "assets" / "bench_cloud.npz"


def use_fp32_math() -> None:
    """Full float32 for matmuls and cuDNN convs (TF32 off), as the JAX
    reference computes: cuDNN convs default to TF32, which keeps about three
    decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_model(cfg: GAPartNetConfig, device, seed: int = 0) -> GAPartNet:
    """The eval-mode model with weights drawn from a seeded torch.Generator."""
    model = GAPartNet(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval().to(device)


def entry(device="cuda"):
    """(fn, args): the flagship inference forward.

    Sets TF32 off for matmuls and cuDNN convs (see `use_fp32_math`).
    `fn(batch)` returns (sem_preds, score_preds, npcs_preds)."""
    use_fp32_math()
    cfg = GAPartNetConfig()
    model = make_model(cfg, device)
    d = synthetic_batch(
        np.random.RandomState(0), batch_size=1, num_points=cfg.max_points,
        max_instances=cfg.max_instances,
    )
    batch = PointCloudBatch.from_numpy(d, device)

    def fn(batch):
        out = model(batch, do_cluster=True, do_score=True, do_npcs=True)
        return out.sem_preds, out.score_preds, out.npcs_preds

    return fn, (batch,)


def bench_cloud_setup(cfg: GAPartNetConfig, path=BENCH_CLOUD, device="cuda", batch_size: int = 1):
    """(cfg with capacities fitted to the cloud, batch, cluster_sem,
    cluster_off) for the committed 20000-point real cloud.

    Same rules as bench.py: per-level voxel capacities x1.08 rounded to 128;
    grid extent x1.08 rounded to 16; hash node cap nodes x1.3 clamped to the
    foreground count, rounded to 256; candidate cap max + 8; degree from the
    connected degree of both clustering sets + 6; dense pool 2x the live
    proposals.  The overrides are the ground-truth labels and the offsets
    to instance centres (the load a trained head produces)."""
    d = np.load(path)
    pts = np.concatenate([d["xyz"], d["rgb"]], axis=1).astype(np.float32)
    counts, span = _counts_and_span(
        pts[:, :3].astype(np.float64), cfg.voxel_size, len(cfg.level_capacity_divisors)
    )
    caps = tuple(min(max(-(-int(c * 1.08) // 128) * 128, 64), cfg.max_points) for c in counts)
    extent = tuple(max(-(-int(s * 1.08) // 16) * 16, 32) for s in span)
    sem = d["sem_labels"]
    fg = sem > 0
    n_nodes, cmax = _hash_occupancy(
        d["xyz"][fg].astype(np.float64), sem[fg].astype(np.int64), cfg.ball_query_radius
    )
    node_cap = min(max(-(-int(min(n_nodes * 1.3, fg.sum())) // 256) * 256, 256), cfg.max_points)
    cand_cap = -(-min(cmax + 8, 62) // 4) * 4
    xyz64 = d["xyz"].astype(np.float64)
    deg = _hash_connected_degree(xyz64[fg], sem[fg], cfg.ball_query_radius)
    ins = d["instance_labels"]
    centers = xyz64.copy()
    for i in np.unique(ins[ins >= 0]):
        centers[ins == i] = xyz64[ins == i].mean(0)
    deg = max(deg, _hash_connected_degree(centers[fg], sem[fg], cfg.ball_query_radius))
    degree = min(max(-(-(deg + 6) // 4) * 4, 8), cand_cap)
    live = (
        _hash_components(xyz64[fg], sem[fg].astype(np.int64), cfg.ball_query_radius)
        + _hash_components(centers[fg], sem[fg].astype(np.int64), cfg.ball_query_radius)
    )
    gcap = max(-(-(2 * live) // 8) * 8, 16)
    cfg = dataclasses.replace(
        cfg, level_capacities=caps, input_grid_extent=extent,
        hash_node_capacity=node_cap, hash_cand_cap=cand_cap,
        hash_max_degree=degree, dense_grid_capacity=gcap,
    )
    batch = PointCloudBatch(
        points=torch.as_tensor(np.tile(pts[None], (batch_size, 1, 1)), device=device),
        point_mask=torch.ones((batch_size, cfg.max_points), dtype=torch.bool, device=device),
        pc_ids=["bench"] * batch_size,
    )
    cluster_sem = torch.as_tensor(np.tile(sem.astype(np.int32)[None], (batch_size, 1)), device=device)
    off = np.where((ins >= 0)[:, None], centers - xyz64, 0.0).astype(np.float32)
    cluster_off = torch.as_tensor(np.tile(off[None], (batch_size, 1, 1)), device=device)
    return cfg, batch, cluster_sem, cluster_off
