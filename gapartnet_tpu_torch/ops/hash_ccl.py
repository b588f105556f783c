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

`hash_connected_components_batch` clusters B clouds in one call, as the
JAX model's `jax.vmap` over the one-sample function does: node keys are
sorted and probed per row (per cloud), each cloud keeps its own node
capacity and counters, and the propagation runs over the batch's nodes as
one block-diagonal graph (node b * M + i), tested for convergence once an
iteration for the whole batch.  A cloud that converged earlier sits at a
fixpoint of the iteration, so the extra iterations leave its labels as they
are: every cloud's labels and counters equal the one-sample call's
(`hash_connected_components`, the B = 1 case).

Spans (utils/profiling.py), each once a call: `ccl:nodes`, `ccl:edges` (the
probe, and in it `ccl:distance` per chunk of candidates and `ccl:degree`),
`ccl:propagate` (per phase, and in it `ccl:iteration` per iteration) and
`ccl:labels`.  Each iteration's convergence test waits for the device
(`sync:ccl_converged`), and so does each copy of a constant to the device
(`sync:ccl_constant`).  Counters: `hash_ccl_clouds` (clouds a call) and
`hash_ccl_iterations` (convergence tests a call).
"""

import numpy as np
import torch

from gapartnet_tpu_torch.ops.voxelize import div_const
from gapartnet_tpu_torch.utils.profiling import count, span

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
    return torch.cumsum(x.to(torch.int32), -1, dtype=torch.int32)


def _propagate(labels: torch.Tensor, table: torch.Tensor):
    """Min-label propagation over `table` (D, M) until a fixpoint or
    MAX_ITERS iterations (`lax.while_loop` of hash_ccl.py:414-440).
    Returns (labels, convergence tests run)."""
    with span("ccl:propagate"):
        m = labels.shape[0]
        has = table >= 0
        src = torch.clamp(table, min=0).long()
        dst = torch.where(has, table, torch.full_like(table, m)).long().reshape(-1)
        big = torch.full_like(table, m)
        for tests in range(1, MAX_ITERS + 1):
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
        return labels, tests


def hash_connected_components_batch(
    pt_xyz: torch.Tensor,
    sem_labels: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    max_degree: int = 24,
    node_capacity: int = 0,
    set_mask: torch.Tensor = None,
    cand_cap: int = 0,
):
    """B clouds: pt_xyz (B, N, 3), sem_labels, valid and set_mask (B, N).
    Returns (labels (B, N) int32, node_overflow (B,) int32, cand_truncated
    (B,) int32); labels are the minimum point index of each component within
    its cloud, invalid points label themselves.  `node_capacity` (default N)
    is per cloud."""
    dev = pt_xyz.device
    b, n = pt_xyz.shape[:2]
    m = node_capacity or n
    i32 = torch.int32
    count("hash_ccl_clouds", b)
    with span("ccl:nodes"):
        with span("sync:ccl_constant"):
            r2 = torch.tensor(np.float32(radius * radius), device=dev)
        s = radius / (3.0 ** 0.5)
        ar_n = torch.arange(n, dtype=i32, device=dev)
        # cloud b's points and nodes sit at rows b * n and b * m of the flat tensors
        base_n = torch.arange(b, device=dev)[:, None] * n
        base_m = torch.arange(b, device=dev)[:, None] * m

        with span("sync:ccl_constant"):
            big = torch.tensor(1e9, dtype=pt_xyz.dtype, device=dev)
        mn = torch.where(valid[..., None], pt_xyz, big).amin(dim=1, keepdim=True) - s
        cell = torch.floor(div_const(pt_xyz - mn, s)).to(i32)
        in_grid = ((cell >= 0) & (cell < (1 << CELL_BITS))).all(dim=-1)
        ok = valid & in_grid & (sem_labels >= 0) & (sem_labels < (1 << LABEL_BITS))
        if set_mask is not None:
            cell = cell.clone()
            cell[..., 0] += torch.where(set_mask, SET_STRIDE, 0).to(i32)

        keys = torch.where(ok, _pack_node(cell, sem_labels.to(i32)), torch.full_like(cell[..., 0], KEY_SENTINEL))
        sk, order = torch.sort(keys, dim=1, stable=True)
        sorted_ok = sk != KEY_SENTINEL
        first = torch.ones_like(sorted_ok)
        first[:, 1:] = sk[:, 1:] != sk[:, :-1]
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
        num_nodes = torch.clamp(kept.sum(dim=1), max=m).to(i32)
        in_cap = in_cap_sorted & (new_id < m)
        point_node = torch.empty_like(keys).scatter_(
            1, order, torch.where(sorted_ok & in_cap, new_id, torch.full_like(new_id, -1)))
        slot = torch.where(kept & in_cap, new_id, torch.full_like(new_id, m)).long()
        node_keys = torch.full((b, m + 1), KEY_SENTINEL, dtype=i32, device=dev)
        node_keys.scatter_(1, slot, sk)
        node_keys = node_keys[:, :m].contiguous()
        node_start = torch.zeros((b, m + 1), dtype=i32, device=dev)
        node_start.scatter_(1, slot, ar_n.expand(b, n))
        rank_sorted = ar_n - torch.gather(node_start[:, :m], 1, new_id.clamp(0, m - 1).long())
        # representative table: first REPS member points of each node
        rep_row = torch.where(
            sorted_ok & in_cap & (rank_sorted < REPS), new_id, torch.full_like(new_id, m)
        ).long()
        rep_table = torch.full((b, (m + 1) * REPS), -1, dtype=i32, device=dev)
        rep_table.scatter_(1, rep_row * REPS + rank_sorted.clamp(0, REPS - 1).long(), order.to(i32))
        rep_table = rep_table.reshape(b, m + 1, REPS)[:, :m]
        rep_ok = rep_table >= 0
        rep_xyz = pt_xyz.reshape(b * n, 3)[rep_table.clamp(min=0).long() + base_n[..., None]]  # (B, M, reps, 3)
        rep_ok_flat, rep_xyz_flat = rep_ok.reshape(b * m, REPS), rep_xyz.reshape(b * m, REPS, 3)

    with span("ccl:edges"):
        c = 1 << CELL_BITS
        node_cell_key = node_keys >> LABEL_BITS
        node_cell = torch.stack(
            [node_cell_key // (c * c), (node_cell_key // c) % c, node_cell_key % c], dim=-1
        )
        node_label = node_keys & ((1 << LABEL_BITS) - 1)
        node_valid = torch.arange(m, device=dev) < num_nodes[:, None]

        with span("sync:ccl_constant"):
            offsets = torch.tensor(HALF_OFFSETS, dtype=i32, device=dev)   # (62, 3)
        noff = offsets.shape[0]
        tgt_cell = node_cell[:, None, :, :] + offsets[None, :, None, :]  # (B, 62, M, 3)
        with span("sync:ccl_constant"):
            bound = torch.tensor([CELL_X_EXTENT, c, c], dtype=i32, device=dev)
        tin = ((tgt_cell >= 0) & (tgt_cell < bound)).all(dim=-1) & node_valid[:, None, :]
        tgt_key = torch.where(
            tin, _pack_node(tgt_cell, node_label[:, None, :]), torch.full_like(tgt_cell[..., 0], KEY_SENTINEL - 1)
        ).reshape(b, noff * m)
        vid_all = torch.searchsorted(node_keys, tgt_key).clamp_(0, m - 1)
        found_all = ((torch.gather(node_keys, 1, vid_all) == tgt_key).reshape(b, noff, m)
                     & tin)
        vid_all = vid_all.reshape(b, noff, m)

        # candidate compaction before the distance check (hash_ccl.py:304-334)
        cand_k = cand_cap or max(4, min(32, max_degree))
        cand_k = ((cand_k + 3) // 4) * 4
        if cand_k >= noff:
            pad = cand_k - noff
            found_all = torch.cat([found_all, found_all.new_zeros((b, pad, m))], dim=1)
            vid_all = torch.cat([vid_all, vid_all.new_full((b, pad, m), m - 1)], dim=1)
        cand_truncated = (found_all.sum(dim=1) > cand_k).sum(dim=1).to(i32)
        cand = torch.sort(torch.where(found_all, vid_all, torch.full_like(vid_all, m)), dim=1).values[:, :cand_k]
        cfound = cand < m
        cvid = torch.where(cfound, cand, torch.zeros_like(cand))
        cvid_flat = cvid + base_m[..., None]

        # distance check in chunks of four candidate rows (the JAX lax.scan)
        nbr_rows = []
        for g0 in range(0, cand_k, 4):
            with span("ccl:distance"):
                vid = cvid_flat[:, g0:g0 + 4]                                # (B, G, M)
                v_xyz = rep_xyz_flat[vid]                                   # (B, G, M, reps, 3)
                v_ok = rep_ok_flat[vid]
                d = rep_xyz[:, None, :, :, None, :] - v_xyz[:, :, :, None, :, :]
                d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
                pair_ok = rep_ok[:, None, :, :, None] & v_ok[:, :, :, None, :]
                connected = cfound[:, g0:g0 + 4] & (pair_ok & (d2 <= r2)).any(dim=4).any(dim=3)
                nbr_rows.append(torch.where(connected, cvid[:, g0:g0 + 4], torch.full_like(vid, -1)))

        # degree compaction: keep the `max_degree` lowest-id neighbours
        with span("ccl:degree"):
            nbr_ids = torch.cat(nbr_rows, dim=1)                            # (B, cand_k, M)
            nbr_sorted = torch.sort(torch.where(nbr_ids >= 0, nbr_ids, torch.full_like(nbr_ids, m)), dim=1).values
            if max_degree < cand_k:
                cand_truncated = cand_truncated + (nbr_sorted[:, max_degree] < m).sum(dim=1).to(i32)
            head = nbr_sorted[:, :max_degree]
            # the batch's table over flat node ids, (D, B * M)
            table = torch.where(head < m, head + base_m[..., None], torch.full_like(head, -1))
            table = table.transpose(0, 1).reshape(head.shape[1], b * m).to(i32)

    labels0 = torch.arange(b * m, dtype=i32, device=dev)
    tests = 0
    if max_degree > NARROW:
        labels0, tests = _propagate(labels0, table[:NARROW])
    node_root, more = _propagate(labels0, table)
    count("hash_ccl_iterations", tests + more)

    with span("ccl:labels"):
        # normalize: min point index per component
        has_node = ok & (point_node >= 0)
        root = torch.where(has_node, node_root[point_node.clamp(min=0).long() + base_m],
                           torch.full_like(point_node, -1))
        min_point = torch.full((b * m + 1,), n, dtype=i32, device=dev)
        min_point.scatter_reduce_(
            0, torch.where(has_node, root, torch.full_like(root, b * m)).long().reshape(-1),
            ar_n.expand(b, n).reshape(-1), reduce="amin", include_self=True,
        )
        out = torch.where(has_node, min_point[root.clamp(min=0).long()], ar_n)
        node_overflow = (first.sum(dim=1) - num_nodes).to(i32)
    return out, node_overflow, cand_truncated


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
    """One sample, the B = 1 case of `hash_connected_components_batch`.
    Returns (labels (N,) int32, node_overflow () int32, cand_truncated ()
    int32)."""
    out, node_overflow, cand_truncated = hash_connected_components_batch(
        pt_xyz[None], sem_labels[None], valid[None], radius, max_degree, node_capacity,
        None if set_mask is None else set_mask[None], cand_cap,
    )
    return out[0], node_overflow[0], cand_truncated[0]
