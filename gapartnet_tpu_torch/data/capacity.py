"""Data-driven capacity sizing: the port's copy of the NumPy helpers of
data/capacity.py that the bench setup uses (entry.bench_cloud_setup).

The backbone grids and the hash-CCL tables have fixed capacities with
counted overflow; these measure a cloud so the capacities fit it.
"""

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
