"""Synthetic GAPartNet-like point clouds (the port's copy of data/synthetic.py).

Generates clouds with the exact schema the real data pipeline produces
(ball-normalized single-view-ish clouds, sem/instance labels, NPCS maps,
per-point instance regions — reference dataset/gapartnet.py:145-229 and
dataset/process_tools/convert_rendered_into_input.py:90-175), used for unit /
golden tests and benchmarking in environments without the dataset.
"""

from typing import Optional

import numpy as np

from gapartnet_tpu_torch.config import NUM_PART_CLASSES


def synthetic_cloud(
    rng: np.random.RandomState,
    num_points: int = 20000,
    num_parts: int = 6,
    num_classes: int = NUM_PART_CLASSES,
):
    """One cloud: a large 'body' (others, label 0) plus box-shaped parts.

    Returns dict of numpy arrays:
      points (N, 6), sem_labels (N,), instance_labels (N,),
      gt_npcs (N, 3), instance_regions (N, 9),
      num_points_per_instance (num_parts,), instance_sem_labels (num_parts,)
    """
    n_body = num_points // 2
    n_part = (num_points - n_body) // num_parts
    n_body = num_points - n_part * num_parts

    pts = []
    sem = []
    inst = []
    npcs = []

    # body: noisy sphere surface (label 0, no instance)
    dirs = rng.randn(n_body, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True) + 1e-9
    body = dirs * (0.8 + rng.rand(n_body, 1) * 0.05)
    pts.append(body)
    sem.append(np.zeros(n_body, np.int32))
    inst.append(np.full(n_body, -100, np.int32))
    npcs.append(np.zeros((n_body, 3), np.float32))

    for i in range(num_parts):
        cls = 1 + (i % (num_classes - 1))
        center = rng.randn(3) * 0.35
        size = 0.06 + rng.rand(3) * 0.1
        local = rng.rand(n_part, 3) - 0.5  # NPCS-style local coords in [-0.5, 0.5)
        part = center + local * size
        pts.append(part)
        sem.append(np.full(n_part, cls, np.int32))
        inst.append(np.full(n_part, i, np.int32))
        npcs.append(local.astype(np.float32))

    points_xyz = np.concatenate(pts).astype(np.float32)
    # ball normalize like the converter (convert_rendered_into_input.py:79-87)
    points_xyz -= points_xyz.mean(0)
    points_xyz /= np.linalg.norm(points_xyz, axis=1).max() + 1e-9
    rgb = rng.rand(num_points, 3).astype(np.float32)
    points = np.concatenate([points_xyz, rgb], axis=1)

    sem_labels = np.concatenate(sem)
    instance_labels = np.concatenate(inst)
    gt_npcs = np.concatenate(npcs).astype(np.float32)

    # per-point instance regions + per-instance stats (gapartnet.py:145-176)
    instance_regions = np.zeros((num_points, 9), np.float32)
    nppi = np.zeros(num_parts, np.int32)
    isl = np.full(num_parts, -1, np.int32)
    for i in range(num_parts):
        idx = np.where(instance_labels == i)[0]
        xyz_i = points_xyz[idx]
        instance_regions[idx, 0:3] = xyz_i.mean(0)
        instance_regions[idx, 3:6] = xyz_i.min(0)
        instance_regions[idx, 6:9] = xyz_i.max(0)
        nppi[i] = len(idx)
        isl[i] = sem_labels[idx[0]]

    return dict(
        points=points,
        sem_labels=sem_labels.astype(np.int32),
        instance_labels=instance_labels.astype(np.int32),
        gt_npcs=gt_npcs,
        instance_regions=instance_regions,
        num_points_per_instance=nppi,
        instance_sem_labels=isl,
        num_instances=num_parts,
    )


def synthetic_batch(
    rng: np.random.RandomState,
    batch_size: int = 2,
    num_points: int = 20000,
    num_parts: int = 6,
    max_instances: int = 64,
    pc_ids: Optional[list] = None,
):
    """Stack synthetic clouds into the arrays of structures.PointCloudBatch."""
    clouds = [
        synthetic_cloud(rng, num_points=num_points, num_parts=num_parts)
        for _ in range(batch_size)
    ]
    nppi = np.zeros((batch_size, max_instances), np.int32)
    isl = np.full((batch_size, max_instances), -1, np.int32)
    for i, c in enumerate(clouds):
        k = c["num_instances"]
        nppi[i, :k] = c["num_points_per_instance"]
        isl[i, :k] = c["instance_sem_labels"]
    return dict(
        points=np.stack([c["points"] for c in clouds]),
        point_mask=np.ones((batch_size, num_points), bool),
        sem_labels=np.stack([c["sem_labels"] for c in clouds]),
        instance_labels=np.stack([c["instance_labels"] for c in clouds]),
        gt_npcs=np.stack([c["gt_npcs"] for c in clouds]),
        instance_regions=np.stack([c["instance_regions"] for c in clouds]),
        num_points_per_instance=nppi,
        instance_sem_labels=isl,
        num_instances=np.full(batch_size, num_parts, np.int32),
        pc_ids=pc_ids or [f"Synthetic_{i:05d}_00_000" for i in range(batch_size)],
    )
