"""Entry points: the flagship inference forward and training step, and
their setups on the committed real cloud.

`entry` mirrors `__graft_entry__.entry` of the JAX package: the flagship
model (`GAPartNetConfig()` defaults: channels 16..112, 20000 points) with
seeded random weights, eval mode, clustering, ScoreNet and NPCSNet on.
`train_entry` is the training main path: one train step of the flagship
model at B = 8 with all three stages on and Adam(1e-3).
`bench_cloud_setup` ports `bench.py`'s `real_cloud_setup`: the committed
real cloud with capacities fitted to it and the trained-operating-point
clustering overrides; `train_setup` builds a labelled batch of B rotated
copies of it, with capacities fitted to all of them.
"""

import dataclasses
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.data.capacity import (
    _counts_and_span,
    _hash_components,
    _hash_connected_degree,
    _hash_occupancy,
)
from gapartnet_tpu_torch.data.instances import generate_instance_info
from gapartnet_tpu_torch.data.synthetic import synthetic_batch
from gapartnet_tpu_torch.models.gapartnet import GAPartNet
from gapartnet_tpu_torch.structures import PointCloudBatch
from gapartnet_tpu_torch.train.loop import adam, train_step
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
        with torch.no_grad():
            out = model(batch, do_cluster=True, do_score=True, do_npcs=True)
        return out.sem_preds, out.score_preds, out.npcs_preds

    return fn, (batch,)


def _fitted_capacities(cfg: GAPartNetConfig, xyz: np.ndarray, sem: np.ndarray,
                       ins: np.ndarray) -> Tuple[dict, np.ndarray]:
    """bench.py's capacity rules for one labelled cloud, as config fields:
    per-level voxel capacities x1.08 rounded to 128; grid extent x1.08
    rounded to 16; hash node cap nodes x1.3 clamped to the foreground count,
    rounded to 256; candidate cap max + 8; degree from the connected degree
    of both clustering sets + 6; dense pool 2x the live proposals.  Also
    returns the instance centres (float64) of the clustering overrides."""
    xyz64 = xyz.astype(np.float64)
    counts, span = _counts_and_span(xyz64, cfg.voxel_size, len(cfg.level_capacity_divisors))
    caps = tuple(min(max(-(-int(c * 1.08) // 128) * 128, 64), cfg.max_points) for c in counts)
    extent = tuple(max(-(-int(s * 1.08) // 16) * 16, 32) for s in span)
    fg = sem > 0
    n_nodes, cmax = _hash_occupancy(xyz64[fg], sem[fg].astype(np.int64), cfg.ball_query_radius)
    node_cap = min(max(-(-int(min(n_nodes * 1.3, fg.sum())) // 256) * 256, 256), cfg.max_points)
    cand_cap = -(-min(cmax + 8, 62) // 4) * 4
    deg = _hash_connected_degree(xyz64[fg], sem[fg], cfg.ball_query_radius)
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
    fields = dict(
        level_capacities=caps, input_grid_extent=extent, hash_node_capacity=node_cap,
        hash_cand_cap=cand_cap, hash_max_degree=degree, dense_grid_capacity=gcap,
    )
    return fields, centers


def _overrides(xyz: np.ndarray, centers: np.ndarray, ins: np.ndarray) -> np.ndarray:
    """Offsets to the instance centres (0 off instances), float32."""
    return np.where((ins >= 0)[:, None], centers - xyz.astype(np.float64), 0.0).astype(np.float32)


def bench_cloud_setup(cfg: GAPartNetConfig, path=BENCH_CLOUD, device="cuda", batch_size: int = 1):
    """(cfg with capacities fitted to the cloud, batch, cluster_sem,
    cluster_off) for the committed 20000-point real cloud, tiled
    `batch_size` times.  Capacities follow `_fitted_capacities`; the
    overrides are the ground-truth labels and the offsets to instance
    centres (the load a trained head produces)."""
    d = np.load(path)
    pts = np.concatenate([d["xyz"], d["rgb"]], axis=1).astype(np.float32)
    sem, ins = d["sem_labels"], d["instance_labels"]
    fields, centers = _fitted_capacities(cfg, d["xyz"], sem, ins)
    cfg = dataclasses.replace(cfg, **fields)
    batch = PointCloudBatch(
        points=torch.as_tensor(np.tile(pts[None], (batch_size, 1, 1)), device=device),
        point_mask=torch.ones((batch_size, cfg.max_points), dtype=torch.bool, device=device),
        pc_ids=["bench"] * batch_size,
    )
    cluster_sem = torch.as_tensor(np.tile(sem.astype(np.int32)[None], (batch_size, 1)), device=device)
    off = _overrides(d["xyz"], centers, ins)
    cluster_off = torch.as_tensor(np.tile(off[None], (batch_size, 1, 1)), device=device)
    return cfg, batch, cluster_sem, cluster_off


def rotation_z(theta: float) -> np.ndarray:
    """The augmentation's rotation about z (data/loader.py:85-93), applied
    to row vectors as xyz @ R."""
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])


def train_setup(cfg: GAPartNetConfig, batch_size: int = 8, seed: int = 0, device="cuda",
                path=BENCH_CLOUD):
    """(cfg, labelled batch, cluster_sem, cluster_off) for training: B
    distinct copies of the committed real cloud, each rotated about z by a
    seeded angle as the training augmentation rotates, with gt_npcs,
    instance regions and per-instance sizes.  Every capacity of
    `_fitted_capacities` is the maximum over the B clouds."""
    d = np.load(path)
    sem = d["sem_labels"].astype(np.int32)
    ins = d["instance_labels"].astype(np.int32)
    rng = np.random.RandomState(seed)
    clouds, fitted = [], []
    for _ in range(batch_size):
        xyz = (d["xyz"].astype(np.float64) @ rotation_z(rng.rand() * 2 * np.pi)).astype(np.float32)
        fields, centers = _fitted_capacities(cfg, xyz, sem, ins)
        fitted.append(fields)
        clouds.append((xyz, _overrides(xyz, centers, ins)))
    fields = {
        k: (tuple(max(f[k][i] for f in fitted) for i in range(len(fitted[0][k])))
            if isinstance(fitted[0][k], tuple) else max(f[k] for f in fitted))
        for k in fitted[0]
    }
    cfg = dataclasses.replace(cfg, **fields)
    points = np.stack([np.concatenate([xyz, d["rgb"]], axis=1) for xyz, _ in clouds]).astype(np.float32)
    nppi = np.zeros((batch_size, cfg.max_instances), np.int32)
    isl = np.full((batch_size, cfg.max_instances), -1, np.int32)
    regions = []
    for i in range(batch_size):
        reg, counts, inst_sem, k = generate_instance_info(points[i], sem, ins)
        regions.append(reg)
        nppi[i, :k] = counts[:k]
        isl[i, :k] = inst_sem[:k]
    arrays = dict(
        points=points,
        point_mask=np.ones((batch_size, cfg.max_points), bool),
        sem_labels=np.tile(sem[None], (batch_size, 1)),
        instance_labels=np.tile(ins[None], (batch_size, 1)),
        gt_npcs=np.tile(d["gt_npcs"].astype(np.float32)[None], (batch_size, 1, 1)),
        instance_regions=np.stack(regions),
        num_points_per_instance=nppi,
        instance_sem_labels=isl,
        num_instances=np.full(batch_size, int(ins.max()) + 1, np.int32),
        pc_ids=[f"bench_rot{i}" for i in range(batch_size)],
    )
    batch = PointCloudBatch.from_numpy(arrays, device)
    cluster_sem = torch.as_tensor(np.tile(sem[None], (batch_size, 1)), device=device)
    cluster_off = torch.as_tensor(np.stack([off for _, off in clouds]), device=device)
    return cfg, batch, cluster_sem, cluster_off


def train_entry(device="cuda", batch_size: int = 8, seed: int = 0):
    """(step_fn, args): one training step of the flagship model.

    The flagship config with capacities fitted to a seeded B = 8 batch of
    rotated real clouds (`train_setup`), seeded random weights in train
    mode, Adam(1e-3), a seeded torch.Generator for the cube jitter, all
    three stages on and the clustering overrides.  `step_fn(batch)` runs
    one step and returns its metrics (see train.loop.loss_metrics).  Sets
    TF32 off for matmuls and cuDNN convs (see `use_fp32_math`)."""
    use_fp32_math()
    cfg, batch, cluster_sem, cluster_off = train_setup(
        GAPartNetConfig(), batch_size=batch_size, seed=seed, device=device
    )
    model = make_model(cfg, device, seed=seed).train()
    optimizer = adam(model.named_parameters(), 1e-3)
    generator = torch.Generator().manual_seed(seed)

    def step_fn(batch):
        return train_step(model, optimizer, batch, generator, True, True, True,
                          cluster_sem_override=cluster_sem,
                          cluster_offset_override=cluster_off)

    return step_fn, (batch,)
