"""Hash-grid connected components for radius clustering.

Counterpart of ops/hash_ccl.py `hash_connected_components` with one path:
sorted-key probing (`probe_impl="sort"`, here a torch.searchsorted; node
keys are unique, so it yields the same node ids as the TPU "table" probe)
and push symmetrization (`symmetrize="push"`).

  * cell size s = radius / sqrt(3): same-cell same-label points are
    mutually within `radius`, so each (cell, label) pair is one graph node;
  * each node keeps its first REPS = 8 member points in stable point order;
  * edges: the 62 lexicographically positive offsets of the 5^3
    neighbourhood are probed; same-label nodes connect iff a representative
    pair lies within `radius`; candidate and degree caps are counted;
  * CCL: min-label propagation, pull along the forward table plus a
    scatter-min push, with pointer jumping, first over the narrow 8-wide
    prefix of the table, then over the full table, each capped at
    MAX_ITERS = 32 iterations.  Running out of iterations is counted nowhere,
    so the schedule is copied exactly.

Spans (utils/profiling.py): `ccl:nodes`, `ccl:edges` (the probe, and in it
`ccl:distance` per chunk of candidates and `ccl:degree`), `ccl:propagate` (per
phase, and in it `ccl:iteration` per iteration) and `ccl:labels`.  Each
iteration's convergence test waits for the device (`sync:ccl_converged`), and
so does each copy of a constant to the device (`sync:ccl_constant`).
"""

import numpy as np
import torch

from gapartnet_tpu_torch.ops.voxelize import div_const
from gapartnet_tpu_torch.utils.profiling import span

CELL_BITS = 7
LABEL_BITS = 4
KEY_SENTINEL = int(np.iinfo(np.int32).max)
SET_STRIDE = 131
CELL_X_EXTENT = SET_STRIDE + (1 << CELL_BITS)  # 259
NARROW = 8      # width of the first propagation phase
REPS = 8        # representative points per node
MAX_ITERS = 32  # iteration cap of each propagation phase
JUMPS = 4       # pointer jumps per propagation iteration

# the 62 lexicographically positive offsets of the 5^3 neighbourhood
HALF_OFFSETS = [
    (dx, dy, dz)
    for dx in range(-2, 3)
    for dy in range(-2, 3)
    for dz in range(-2, 3)
    if (dx, dy, dz) > (0, 0, 0)
]


def _pack_node(cell: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    c = 1 << CELL_BITS
    return (((cell[..., 0] * c + cell[..., 1]) * c + cell[..., 2]) << LABEL_BITS) | label


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


def _propagate(labels: torch.Tensor, table: torch.Tensor):
    """Min-label propagation over `table` (D, M) until a fixpoint or
    MAX_ITERS iterations (`lax.while_loop` of hash_ccl.py:414-440)."""
    with span("ccl:propagate"):
        m = labels.shape[0]
        has = table >= 0
        src = torch.clamp(table, min=0).long()
        dst = torch.where(has, table, torch.full_like(table, m)).long().reshape(-1)
        big = torch.full_like(table, m)
        for _ in range(MAX_ITERS):
            with span("ccl:iteration"):
                prev = labels
                nl = torch.where(has, labels[src], big)
                labels = torch.minimum(labels, nl.amin(dim=0))
                # push the updated source labels along forward edges (dump slot m)
                pushed = torch.cat([labels, labels.new_full((1,), m)])
                pushed.scatter_reduce_(
                    0, dst, labels[None, :].expand_as(table).reshape(-1), reduce="amin",
                    include_self=True,
                )
                labels = pushed[:m]
                for _ in range(JUMPS):
                    labels = labels[labels.long()]
                with span("sync:ccl_converged"):
                    converged = torch.equal(labels, prev)
                if converged:
                    break
        return labels


def hash_connected_components(
    pt_xyz: torch.Tensor,
    sem_labels: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    max_degree: int = 24,
    node_capacity: int = 0,
    set_mask: torch.Tensor = None,
    cand_cap: int = 0,
):
    """One sample.  Returns (labels (N,) int32, node_overflow () int32,
    cand_truncated () int32); labels are the minimum point index of each
    component, invalid points label themselves."""
    dev = pt_xyz.device
    n = pt_xyz.shape[0]
    m = node_capacity or n
    i32 = torch.int32
    with span("ccl:nodes"):
        with span("sync:ccl_constant"):
            r2 = torch.tensor(np.float32(radius * radius), device=dev)
        s = radius / (3.0 ** 0.5)
        ar_n = torch.arange(n, dtype=i32, device=dev)

        with span("sync:ccl_constant"):
            big = torch.tensor(1e9, dtype=pt_xyz.dtype, device=dev)
        mn = torch.where(valid[:, None], pt_xyz, big).amin(dim=0) - s
        cell = torch.floor(div_const(pt_xyz - mn, s)).to(i32)
        in_grid = ((cell >= 0) & (cell < (1 << CELL_BITS))).all(dim=-1)
        ok = valid & in_grid & (sem_labels >= 0) & (sem_labels < (1 << LABEL_BITS))
        if set_mask is not None:
            cell = cell.clone()
            cell[:, 0] += torch.where(set_mask, SET_STRIDE, 0).to(i32)

        keys = torch.where(ok, _pack_node(cell, sem_labels.to(i32)), torch.full_like(ar_n, KEY_SENTINEL))
        sk, order = torch.sort(keys, stable=True)
        sorted_ok = sk != KEY_SENTINEL
        first = torch.ones_like(sorted_ok)
        first[1:] = sk[1:] != sk[:-1]
        first &= sorted_ok
        node_of_sorted = _cumsum_i32(first) - 1
        if set_mask is None:
            in_cap_sorted = node_of_sorted < m
        else:
            # per-set capacity: each set gets m // 2 node slots
            is_set2 = ((sk >> LABEL_BITS) // ((1 << CELL_BITS) ** 2)) >= SET_STRIDE
            set2_nodes = _cumsum_i32(first & is_set2)
            rank_in_set = torch.where(is_set2, set2_nodes - 1, node_of_sorted - set2_nodes)
            in_cap_sorted = rank_in_set < (m // 2)
        kept = first & in_cap_sorted
        new_id = _cumsum_i32(kept) - 1
        num_nodes = torch.clamp(kept.sum(), max=m).to(i32)
        in_cap = in_cap_sorted & (new_id < m)
        point_node = torch.empty_like(ar_n)
        point_node[order] = torch.where(sorted_ok & in_cap, new_id, torch.full_like(new_id, -1))
        slot = torch.where(kept & in_cap, new_id, torch.full_like(new_id, m)).long()
        node_keys = torch.full((m + 1,), KEY_SENTINEL, dtype=i32, device=dev)
        node_keys[slot] = sk
        node_keys = node_keys[:m]
        node_start = torch.zeros((m + 1,), dtype=i32, device=dev)
        node_start[slot] = ar_n
        rank_sorted = ar_n - node_start[:m][new_id.clamp(0, m - 1).long()]
        # representative table: first REPS member points of each node
        rep_row = torch.where(
            sorted_ok & in_cap & (rank_sorted < REPS), new_id, torch.full_like(new_id, m)
        ).long()
        rep_table = torch.full((m + 1, REPS), -1, dtype=i32, device=dev)
        rep_table[rep_row, rank_sorted.clamp(0, REPS - 1).long()] = order.to(i32)
        rep_table = rep_table[:m]
        rep_ok = rep_table >= 0
        rep_xyz = pt_xyz[rep_table.clamp(min=0).long()]               # (M, reps, 3)

    with span("ccl:edges"):
        c = 1 << CELL_BITS
        node_cell_key = node_keys >> LABEL_BITS
        node_cell = torch.stack(
            [node_cell_key // (c * c), (node_cell_key // c) % c, node_cell_key % c], dim=-1
        )
        node_label = node_keys & ((1 << LABEL_BITS) - 1)
        node_valid = torch.arange(m, device=dev) < num_nodes

        with span("sync:ccl_constant"):
            offsets = torch.tensor(HALF_OFFSETS, dtype=i32, device=dev)   # (62, 3)
        noff = offsets.shape[0]
        tgt_cell = node_cell[None, :, :] + offsets[:, None, :]        # (62, M, 3)
        with span("sync:ccl_constant"):
            bound = torch.tensor([CELL_X_EXTENT, c, c], dtype=i32, device=dev)
        tin = ((tgt_cell >= 0) & (tgt_cell < bound)).all(dim=-1) & node_valid[None, :]
        tgt_key = torch.where(
            tin, _pack_node(tgt_cell, node_label[None, :]), torch.full_like(tgt_cell[..., 0], KEY_SENTINEL - 1)
        )
        vid_all = torch.searchsorted(node_keys, tgt_key.reshape(-1)).clamp_(0, m - 1).reshape(noff, m)
        found_all = (node_keys[vid_all] == tgt_key) & tin

        # candidate compaction before the distance check (hash_ccl.py:304-334)
        cand_k = cand_cap or max(4, min(32, max_degree))
        cand_k = ((cand_k + 3) // 4) * 4
        if cand_k >= noff:
            pad = cand_k - noff
            found_all = torch.cat([found_all, found_all.new_zeros((pad, m))])
            vid_all = torch.cat([vid_all, vid_all.new_full((pad, m), m - 1)])
        cand_truncated = (found_all.sum(dim=0) > cand_k).sum().to(i32)
        cand = torch.sort(torch.where(found_all, vid_all, torch.full_like(vid_all, m)), dim=0).values[:cand_k]
        cfound = cand < m
        cvid = torch.where(cfound, cand, torch.zeros_like(cand))

        # distance check in chunks of four candidate rows (the JAX lax.scan)
        nbr_rows = []
        for g0 in range(0, cand_k, 4):
            with span("ccl:distance"):
                vid = cvid[g0:g0 + 4]                                       # (G, M)
                v_xyz = rep_xyz[vid]                                        # (G, M, reps, 3)
                v_ok = rep_ok[vid]
                d = rep_xyz[None, :, :, None, :] - v_xyz[:, :, None, :, :]
                d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
                pair_ok = rep_ok[None, :, :, None] & v_ok[:, :, None, :]
                connected = cfound[g0:g0 + 4] & (pair_ok & (d2 <= r2)).any(dim=3).any(dim=2)
                nbr_rows.append(torch.where(connected, vid, torch.full_like(vid, -1)))

        # degree compaction: keep the `max_degree` lowest-id neighbours
        with span("ccl:degree"):
            nbr_ids = torch.cat(nbr_rows)                                   # (cand_k, M)
            nbr_sorted = torch.sort(torch.where(nbr_ids >= 0, nbr_ids, torch.full_like(nbr_ids, m)), dim=0).values
            if max_degree < cand_k:
                cand_truncated = cand_truncated + (nbr_sorted[max_degree] < m).sum().to(i32)
            head = nbr_sorted[:max_degree]
            nbr_ids = torch.where(head < m, head, torch.full_like(head, -1)).to(i32)

    labels0 = torch.arange(m, dtype=i32, device=dev)
    if max_degree > NARROW:
        labels0 = _propagate(labels0, nbr_ids[:NARROW])
    node_root = _propagate(labels0, nbr_ids)

    with span("ccl:labels"):
        # normalize: min point index per component
        has_node = ok & (point_node >= 0)
        root = torch.where(has_node, node_root[point_node.clamp(min=0).long()], torch.full_like(ar_n, -1))
        min_point = torch.full((m + 1,), n, dtype=i32, device=dev)
        min_point.scatter_reduce_(
            0, torch.where(has_node, root, torch.full_like(root, m)).long(), ar_n,
            reduce="amin", include_self=True,
        )
        out = torch.where(has_node, min_point[root.clamp(min=0).long()], ar_n)
        node_overflow = (first.sum() - num_nodes).to(i32)
    return out, node_overflow, cand_truncated
