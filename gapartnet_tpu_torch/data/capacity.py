"""Data-driven capacity sizing (the port's copy of data/capacity.py).

The backbone grids and the hash-CCL tables have fixed capacities with
counted overflow; these measure clouds so the capacities fit them: single
clouds for the bench setup (entry.bench_cloud_setup), and samples of whole
datasets through their loading and augmentation for the trainer's
`auto_capacity` (scan_dataset_shapes, scan_hash_capacities).
"""

from typing import Iterable, Sequence, Tuple

import numpy as np


def _counts_and_span(xyz: np.ndarray, voxel_size, num_levels: int):
    """(per-level unique voxel counts, level-0 per-axis span in cells)."""
    if len(xyz) == 0:
        return [0] * num_levels, np.zeros(3, np.int64)
    vox = np.floor(
        (xyz - xyz.min(0)) / np.asarray(voxel_size, np.float64)
    ).astype(np.int64)
    out = []
    for lvl in range(num_levels):
        c = vox >> lvl
        key = (c[:, 0] << 42) + (c[:, 1] << 21) + c[:, 2]
        out.append(len(np.unique(key)))
    return out, vox.max(0) + 1


def _node_keys(xyz: np.ndarray, labels: np.ndarray, radius: float):
    s = radius / np.sqrt(3.0)
    cell = np.floor((xyz - xyz.min(0) + s) / s).astype(np.int64)
    return ((cell[:, 0] << 34) + (cell[:, 1] << 17) + cell[:, 2]) * 16 + labels


def _positive_offsets():
    for dx in range(-2, 3):
        for dy in range(-2, 3):
            for dz in range(-2, 3):
                if (dx, dy, dz) > (0, 0, 0):
                    yield dx, dy, dz


def _hash_occupancy(xyz: np.ndarray, labels: np.ndarray, radius: float):
    """(node count, max same-label candidates over the 62 positive probe
    offsets) of one clustered point set (ops/hash_ccl.py tables)."""
    if len(xyz) == 0:
        return 0, 0
    uniq = np.unique(_node_keys(xyz, labels, radius))
    lab = uniq % 16
    ck = uniq // 16
    cz, cy, cx = ck & 0x1FFFF, (ck >> 17) & 0x1FFFF, ck >> 34
    cand = np.zeros(len(uniq), np.int64)
    for dx, dy, dz in _positive_offsets():
        tk = (((cx + dx) << 34) + ((cy + dy) << 17) + (cz + dz)) * 16 + lab
        cand += np.isin(tk, uniq, assume_unique=True)
    return len(uniq), int(cand.max(initial=0))


def _node_graph(xyz: np.ndarray, labels: np.ndarray, radius: float, reps: int):
    """Nodes with their first `reps` representatives, and an iterator over
    the forward-connected edges (src, dst) per probe offset."""
    key = _node_keys(xyz, labels, radius)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    uniq, start = np.unique(sk, return_index=True)
    n_nodes = len(uniq)
    counts = np.diff(np.append(start, len(sk)))
    rep = np.zeros((n_nodes, reps, 3), np.float64)
    rep_ok = np.zeros((n_nodes, reps), bool)
    for j in range(reps):
        has = counts > j
        rep[has, j] = xyz[order[start[has] + j]]
        rep_ok[has, j] = True
    lab = uniq % 16
    ck = uniq // 16
    cz, cy, cx = ck & 0x1FFFF, (ck >> 17) & 0x1FFFF, ck >> 34
    r2 = radius * radius

    def edges():
        for dx, dy, dz in _positive_offsets():
            tk = (((cx + dx) << 34) + ((cy + dy) << 17) + (cz + dz)) * 16 + lab
            pos = np.clip(np.searchsorted(uniq, tk), 0, n_nodes - 1)
            src = np.nonzero(uniq[pos] == tk)[0]
            if len(src) == 0:
                continue
            dst = pos[src]
            d2 = ((rep[src][:, :, None, :] - rep[dst][:, None, :, :]) ** 2).sum(-1)
            ok = rep_ok[src][:, :, None] & rep_ok[dst][:, None, :]
            conn = (ok & (d2 <= r2)).any(axis=(1, 2))
            yield src, dst, conn

    return n_nodes, counts, edges


def _hash_connected_degree(
    xyz: np.ndarray, labels: np.ndarray, radius: float, reps: int = 8
) -> int:
    """Max forward-CONNECTED node degree of one clustered point set: the
    edges that survive hash_ccl's distance check (sizes hash_max_degree)."""
    if len(xyz) == 0:
        return 0
    n_nodes, _, edges = _node_graph(xyz, labels, radius, reps)
    deg = np.zeros(n_nodes, np.int64)
    for src, _, conn in edges():
        deg[src] += conn
    return int(deg.max(initial=0))


def _hash_components(
    xyz: np.ndarray,
    labels: np.ndarray,
    radius: float,
    reps: int = 8,
    min_points: int = 5,
) -> int:
    """Number of LIVE proposals one clustered point set yields: components
    of the node graph with >= `min_points` member points (sizes the dense
    proposal-grid pool, dense_grid_capacity)."""
    if len(xyz) == 0:
        return 0
    n_nodes, counts, edges = _node_graph(xyz, labels, radius, reps)
    parent = np.arange(n_nodes)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for src, dst, conn in edges():
        for a, b in zip(src[conn], dst[conn]):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
    roots = np.array([find(i) for i in range(n_nodes)])
    comp_points = np.zeros(n_nodes, np.int64)
    np.add.at(comp_points, roots, counts)
    return int((comp_points[np.unique(roots)] >= min_points).sum())


def _sample_indices(ds, max_samples: int) -> np.ndarray:
    return np.unique(np.linspace(0, len(ds) - 1, min(len(ds), max_samples)).astype(int))


def scan_level_capacities(
    datasets: Iterable,
    voxel_size: Sequence[float],
    num_levels: int,
    max_points: int,
    *,
    augment_trials: int = 3,
    headroom: float = 1.08,
    round_to: int = 128,
    max_samples: int = 48,
) -> Tuple[int, ...]:
    """Per-level voxel capacities of `scan_dataset_shapes`."""
    return scan_dataset_shapes(
        datasets, voxel_size, num_levels, max_points, augment_trials=augment_trials,
        headroom=headroom, round_to=round_to, max_samples=max_samples,
    )[0]


def scan_dataset_shapes(
    datasets: Iterable,
    voxel_size: Sequence[float],
    num_levels: int,
    max_points: int,
    *,
    augment_trials: int = 3,
    headroom: float = 1.08,
    aug_headroom: float = 1.16,
    round_to: int = 128,
    extent_round_to: int = 16,
    max_samples: int = 48,
) -> Tuple[Tuple[int, ...], Tuple[int, int, int]]:
    """One pass over up to `max_samples` evenly spaced samples per dataset
    (GAPartNetDataset-likes) -> (per-level capacities, level-0 grid extent).

    Capacities: the largest unique-voxel count per level x headroom (x
    `aug_headroom` once an augmenting dataset is scanned, over
    `augment_trials` epochs of draws), rounded up to `round_to`, clamped to
    [64, max_points].  Extent: the largest per-axis span x headroom,
    rounded up to `extent_round_to`, at least 32."""
    mx = np.zeros(num_levels, np.int64)
    mx_hr = float(headroom)
    span = np.zeros(3, np.int64)
    for ds in datasets:
        if ds is None or len(ds) == 0:
            continue
        idxs = _sample_indices(ds, max_samples)
        trials = augment_trials if getattr(ds, "augmentation", False) else 1
        if trials > 1:
            mx_hr = max(mx_hr, float(aug_headroom))
        epoch0 = getattr(ds, "epoch", 0)
        try:
            for t in range(trials):
                ds.epoch = epoch0 + t
                for i in idxs:
                    item = ds[int(i)]
                    xyz = item["points"][item["point_mask"]][:, :3]
                    counts, sp = _counts_and_span(xyz, voxel_size, num_levels)
                    mx = np.maximum(mx, counts)
                    span = np.maximum(span, sp)
        finally:
            ds.epoch = epoch0
    caps = np.ceil(mx * mx_hr / round_to).astype(np.int64) * round_to
    caps = np.minimum(np.maximum(caps, 64), max_points)
    ext = np.ceil(span * headroom / extent_round_to).astype(np.int64)
    ext = np.maximum(ext * extent_round_to, 32)
    return tuple(int(c) for c in caps), (int(ext[0]), int(ext[1]), int(ext[2]))


def scan_hash_capacities(
    datasets: Iterable,
    radius: float,
    *,
    node_headroom: float = 1.3,
    cand_margin: int = 8,
    degree_margin: int = 6,
    round_to: int = 256,
    max_samples: int = 48,
    max_points: int = 20000,
) -> Tuple[int, int, int]:
    """(hash_node_capacity per set, candidate cap, max degree) of the
    hash-CCL tables, from the ground-truth labels of up to `max_samples`
    samples per dataset:

      * node cap: the most (cell, label) nodes x `node_headroom`, clamped
        to the most foreground points, rounded up to `round_to`, in
        [256, max_points];
      * candidate cap: the most same-label candidates over the 62 probe
        offsets + `cand_margin`, rounded up to 4, at most 60;
      * degree: the largest connected degree of both clustering sets (the
        points, and each point moved to its instance centre) +
        `degree_margin`, rounded up to 4, in [8, candidate cap]."""
    max_fg = max_nodes = max_cand = max_deg = 0
    for ds in datasets:
        if ds is None or len(ds) == 0:
            continue
        for i in _sample_indices(ds, max_samples):
            item = ds[int(i)]
            mask = item["point_mask"]
            sem = item["sem_labels"][mask]
            xyz = item["points"][mask][:, :3].astype(np.float64)
            fg = sem > 0
            max_fg = max(max_fg, int(fg.sum()))
            n_nodes, cmax = _hash_occupancy(xyz[fg], sem[fg], radius)
            max_nodes = max(max_nodes, n_nodes)
            max_cand = max(max_cand, cmax)
            max_deg = max(max_deg, _hash_connected_degree(xyz[fg], sem[fg], radius))
            if "instance_regions" in item:
                shifted = item["instance_regions"][mask][:, :3].astype(np.float64)
                has_inst = item["instance_labels"][mask] >= 0
                shifted = np.where(has_inst[:, None], shifted, xyz)
                max_deg = max(max_deg, _hash_connected_degree(shifted[fg], sem[fg], radius))
    node_cap = int(np.ceil(min(max_nodes * node_headroom, max_fg) / round_to))
    node_cap = min(max(node_cap * round_to, 256), max_points)
    cand_cap = min(max_cand + cand_margin, 62)
    cand_cap = min(((cand_cap + 3) // 4) * 4, 60)
    degree = ((max_deg + degree_margin + 3) // 4) * 4
    degree = min(max(degree, 8), cand_cap)
    return node_cap, cand_cap, degree
