"""The benchmark's inputs: rotated copies of the committed real cloud.

`data/bench_cloud.npz` (beside this file) is the reference's real asset
45780 (20000 points: xyz, rgb, part labels, instance labels, NPCS): the
benchmark's own copy, so that no file outside the benchmark sets its
traffic.  Each cloud of a pool is a copy rotated about z, as the training
augmentation rotates (a frozen copy of the program's `rotation_z`), with
its labels, instance statistics and the clustering overrides of a trained
operating point: the ground-truth labels and the offsets of each point to
its instance centre.
"""

from pathlib import Path
from typing import Dict, List

import numpy as np

CLOUD = Path(__file__).resolve().parent / "data" / "bench_cloud.npz"


def rotation_z(theta: float) -> np.ndarray:
    """Rotation about z applied to row vectors as xyz @ R."""
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])


def instance_info(xyz: np.ndarray, sem: np.ndarray, ins: np.ndarray, max_instances: int):
    """(regions (N, 9): each instance point's instance mean, min and max;
    points per instance (I,); the label of each instance's first point
    (I,); number of instances), I = max_instances, padded with 0 / -1."""
    k = int(ins.max()) + 1 if (ins >= 0).any() else 0
    regions = np.zeros((len(xyz), 9), np.float32)
    nppi = np.zeros(max_instances, np.int32)
    isl = np.full(max_instances, -1, np.int32)
    ok = ins >= 0
    if k:
        ids, w = ins[ok], xyz[ok].astype(np.float32)
        counts = np.bincount(ids, minlength=k)
        sums = np.zeros((k, 3))
        np.add.at(sums, ids, w)
        mins = np.full((k, 3), np.inf)
        maxs = np.full((k, 3), -np.inf)
        np.minimum.at(mins, ids, w)
        np.maximum.at(maxs, ids, w)
        regions[ok, 0:3] = (sums / np.maximum(counts, 1)[:, None])[ids]
        regions[ok, 3:6] = mins[ids]
        regions[ok, 6:9] = maxs[ids]
        nppi[:k] = counts
        first = np.full(k, len(xyz), np.int64)
        np.minimum.at(first, ids, np.nonzero(ok)[0])
        isl[:k] = sem[first]
    return regions, nppi, isl, k


def centre_offsets(xyz: np.ndarray, ins: np.ndarray) -> np.ndarray:
    """Offsets (float32) of each instance point to its instance's mean
    (float64), 0 off instances."""
    x64 = xyz.astype(np.float64)
    centres = x64.copy()
    for i in np.unique(ins[ins >= 0]):
        centres[ins == i] = x64[ins == i].mean(0)
    return np.where((ins >= 0)[:, None], centres - x64, 0.0).astype(np.float32)


def make_pool(seed: int, size: int, max_instances: int, num_points: int = 0) -> List[Dict[str, np.ndarray]]:
    """`size` rotated copies of the cloud, at the angles (k + 1/2) 2 pi /
    size, in an order drawn from `seed`: every seed gets the same clouds,
    so the same voxel grids and capacities, and the seed moves only which
    cloud comes when.  `num_points` > 0 keeps a seeded subset of that many
    points (the small clouds of the CPU tests)."""
    d = np.load(CLOUD)
    rng = np.random.default_rng(seed % (2 ** 63))
    keep = np.arange(len(d["xyz"]))
    if num_points:
        keep = np.sort(rng.choice(len(keep), num_points, replace=False))
    sem = d["sem_labels"][keep].astype(np.int32)
    ins = d["instance_labels"][keep].astype(np.int32)
    pool = []
    for j in rng.permutation(size):
        theta = (j + 0.5) * 2 * np.pi / size
        xyz = (d["xyz"][keep].astype(np.float64) @ rotation_z(theta)).astype(np.float32)
        regions, nppi, isl, k = instance_info(xyz, sem, ins, max_instances)
        pool.append(dict(
            points=np.concatenate([xyz, d["rgb"][keep]], axis=1).astype(np.float32),
            sem_labels=sem, instance_labels=ins, gt_npcs=d["gt_npcs"][keep].astype(np.float32),
            instance_regions=regions, num_points_per_instance=nppi, instance_sem_labels=isl,
            num_instances=np.int32(k), cluster_offsets=centre_offsets(xyz, ins),
            masks=np.stack([ins == i for i in range(k)]),
        ))
    return pool


BATCH_KEYS = ("points", "sem_labels", "instance_labels", "gt_npcs", "instance_regions",
              "num_points_per_instance", "instance_sem_labels", "num_instances")


def stack(clouds: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """One batch of clouds: every field stacked, all points valid."""
    out = {k: np.stack([c[k] for c in clouds]) for k in BATCH_KEYS + ("cluster_offsets",)}
    out["point_mask"] = np.ones(out["sem_labels"].shape, bool)
    return out
