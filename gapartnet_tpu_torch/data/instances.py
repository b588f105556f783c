"""Per-instance statistics of a labelled cloud (the port's copy of
`generate_instance_info` in data/loader.py)."""

import numpy as np


def generate_instance_info(
    points: np.ndarray, sem_labels: np.ndarray, instance_labels: np.ndarray
):
    """Per-point instance mean / min / max regions (N, 9) and per-instance
    sizes and semantic labels (the label of each instance's first point).

    Returns (instance_regions, num_points_per_instance,
    instance_sem_labels, num_instances)."""
    xyz = points[:, :3]
    num_instances = int(instance_labels.max()) + 1 if (instance_labels >= 0).any() else 0
    instance_regions = np.zeros((len(points), 9), np.float32)
    nppi = np.zeros(max(num_instances, 1), np.int32)
    isl = np.full(max(num_instances, 1), -1, np.int32)
    valid = instance_labels >= 0
    if num_instances > 0:
        ids = instance_labels[valid]
        w = xyz[valid]
        counts = np.bincount(ids, minlength=num_instances)
        sums = np.zeros((num_instances, 3))
        np.add.at(sums, ids, w)
        means = sums / np.maximum(counts, 1)[:, None]
        mins = np.full((num_instances, 3), np.inf)
        maxs = np.full((num_instances, 3), -np.inf)
        np.minimum.at(mins, ids, w)
        np.maximum.at(maxs, ids, w)
        instance_regions[valid, 0:3] = means[ids]
        instance_regions[valid, 3:6] = mins[ids]
        instance_regions[valid, 6:9] = maxs[ids]
        nppi = counts.astype(np.int32)
        idxs = np.nonzero(valid)[0]
        first_idx = np.full(num_instances, len(points), np.int64)
        np.minimum.at(first_idx, ids, idxs)
        isl = sem_labels[first_idx].astype(np.int32)
    return instance_regions, nppi, isl, num_instances
