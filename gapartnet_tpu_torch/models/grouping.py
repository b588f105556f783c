"""Dual-set proposal clustering and proposal re-voxelization.

Counterpart of models/grouping.py: `cluster_single` with both
implementations (the hash-grid CCL, and the reference's "exact" first-K
ball query with list CCL), `cluster_hash_batch` (hash clustering of a whole
batch in one call, the JAX model's `jax.vmap` of `cluster_single`),
`proposal_cube_coords`, `segmented_voxelize_single` (the sparse proposal
grid of the train path) and `segmented_dense_voxelize_single` (the dense
grid of the eval path).  Every sample owns exactly 2N proposal "entries"
(each valid point appears once per clustering set) and at most P
proposals; everything downstream indexes through (entry_point,
entry_proposal, masks).  Spans (utils/profiling.py): `cluster:batch` a
batched hash call and `cluster:cloud` a `cluster_single`, each with its
`cluster:compact` (and with exact clustering the ops' `cluster:ball_query`
and `cluster:ccl`), and `grid:proposals` per cloud.
"""

from typing import NamedTuple

import torch

from gapartnet_tpu_torch.ops.ball_query import ball_query_single
from gapartnet_tpu_torch.ops.ccl import connected_components_single
from gapartnet_tpu_torch.ops.hash_ccl import hash_connected_components_batch
from gapartnet_tpu_torch.ops.segment import segment_max, segment_min, segment_sum
from gapartnet_tpu_torch.ops.voxelize import dedup_keys, div_const, pack_coords
from gapartnet_tpu_torch.utils.profiling import span

PROPOSAL_CELL = 32  # virtual cell edge per proposal (> score_fullscale 28)


class SampleProposals(NamedTuple):
    """Clustering output; fields may carry a leading batch dimension."""

    entry_point: torch.Tensor       # (2N,) point index in [0, N)
    entry_proposal: torch.Tensor    # (2N,) compact proposal id, -1 invalid
    entry_mask: torch.Tensor        # (2N,) bool
    proposal_size: torch.Tensor     # (P,) int32
    proposal_mask: torch.Tensor     # (P,) bool
    num_proposals: torch.Tensor     # () int32
    num_dropped: torch.Tensor       # () int32 proposals beyond max_proposals
    ccl_overflow: torch.Tensor      # () int32 hash-CCL node-table overflow
    ccl_cand_truncated: torch.Tensor  # () int32 hash-CCL candidate/degree drops
    ccl_unconverged: torch.Tensor   # () int32 exact-CCL sets cut off by the iteration cap


class ProposalGrid(NamedTuple):
    keys: torch.Tensor            # (2N,) sorted proposal-grid voxel keys
    num_voxels: torch.Tensor      # () int32
    entry_voxel_id: torch.Tensor  # (2N,) voxel id per entry, -1 invalid


def stack_proposals(props) -> SampleProposals:
    """Stack per-sample SampleProposals along a new leading batch dim."""
    return SampleProposals(*[torch.stack(list(f)) for f in zip(*props)])


def _compact(lab1, lab2, valid, min_num_points_per_proposal: int, max_proposals: int,
             ccl_overflow, ccl_cand_truncated, ccl_unconverged) -> SampleProposals:
    """B clouds' component labels (B, N) of both sets -> batched proposals:
    compact proposal ids in ascending (set, label) order, dropping
    components below the min-points filter and beyond `max_proposals`."""
    with span("cluster:compact"):
        dev = valid.device
        b, n = valid.shape
        i32 = torch.int32
        m = 2 * n
        dump = torch.full_like(lab1, m)
        keys = torch.cat([torch.where(valid, lab1, dump), torch.where(valid, n + lab2, dump)], dim=1)
        sp = torch.arange(n, dtype=i32, device=dev).repeat(b, 2)
        entry_valid = keys < m

        sizes_raw = torch.zeros((b, m + 1), dtype=i32, device=dev)
        sizes_raw.scatter_add_(1, keys.long(), torch.ones_like(keys))
        keep_raw = sizes_raw[:, :m] >= min_num_points_per_proposal
        compact_of_raw = torch.cumsum(keep_raw.to(i32), 1, dtype=i32) - 1
        kc = keys.clamp(0, m - 1).long()
        keep_entry = entry_valid & torch.gather(keep_raw, 1, kc)
        pid = torch.where(keep_entry, torch.gather(compact_of_raw, 1, kc), torch.full_like(keys, -1))
        pid = torch.where(pid < max_proposals, pid, torch.full_like(pid, -1))
        entry_mask = pid >= 0

        num_kept = keep_raw.sum(dim=1).to(i32)
        num_proposals = torch.clamp(num_kept, max=max_proposals)
        proposal_size = torch.zeros((b, max_proposals + 1), dtype=i32, device=dev)
        proposal_size.scatter_add_(
            1, torch.where(entry_mask, pid, torch.full_like(pid, max_proposals)).long(),
            torch.ones_like(pid))
        proposal_mask = torch.arange(max_proposals, device=dev) < num_proposals[:, None]
    return SampleProposals(
        entry_point=sp,
        entry_proposal=pid,
        entry_mask=entry_mask,
        proposal_size=proposal_size[:, :max_proposals],
        proposal_mask=proposal_mask,
        num_proposals=num_proposals,
        num_dropped=num_kept - num_proposals,
        ccl_overflow=ccl_overflow,
        ccl_cand_truncated=ccl_cand_truncated,
        ccl_unconverged=ccl_unconverged,
    )


def cluster_hash_batch(
    pt_xyz: torch.Tensor,
    offsets: torch.Tensor,
    sem_preds: torch.Tensor,
    valid: torch.Tensor,
    ball_query_radius: float,
    min_num_points_per_proposal: int,
    max_proposals: int,
    hash_node_capacity: int = 0,
    hash_cand_cap: int = 0,
    hash_max_degree: int = 24,
) -> SampleProposals:
    """B clouds (pt_xyz, offsets (B, N, 3); sem_preds, valid (B, N)) in one
    hash-CCL call over both sets of every cloud, then one compaction:
    batched proposals equal to `stack_proposals` of per-cloud
    `cluster_single(impl="hash")`."""
    with span("cluster:batch"):
        dev = pt_xyz.device
        b, n = pt_xyz.shape[:2]
        i32 = torch.int32
        set_mask = (torch.arange(2 * n, device=dev) >= n).expand(b, 2 * n)
        lab, ccl_overflow, ccl_cand_truncated = hash_connected_components_batch(
            torch.cat([pt_xyz, pt_xyz + offsets], dim=1),
            torch.cat([sem_preds, sem_preds], dim=1).to(i32),
            torch.cat([valid, valid], dim=1),
            ball_query_radius,
            node_capacity=2 * hash_node_capacity if hash_node_capacity else 0,
            set_mask=set_mask,
            cand_cap=hash_cand_cap,
            max_degree=hash_max_degree,
        )
        # components never span sets, so set-2 labels map back by -n
        return _compact(lab[:, :n], lab[:, n:] - n, valid, min_num_points_per_proposal,
                        max_proposals, ccl_overflow, ccl_cand_truncated,
                        torch.zeros((b,), dtype=i32, device=dev))


def cluster_single(
    pt_xyz: torch.Tensor,
    offsets: torch.Tensor,
    sem_preds: torch.Tensor,
    valid: torch.Tensor,
    ball_query_radius: float,
    min_num_points_per_proposal: int,
    max_proposals: int,
    hash_node_capacity: int = 0,
    hash_cand_cap: int = 0,
    hash_max_degree: int = 24,
    impl: str = "hash",
    max_num_points_per_query: int = 50,
    max_num_points_per_query_shift: int = 300,
) -> SampleProposals:
    """One sample: cluster both sets (xyz and xyz + offsets), then compact
    proposal ids and drop proposals below the min-points filter.  Proposal
    numbering follows ascending (set, component label).

    impl="hash": the B = 1 case of `cluster_hash_batch`.  impl="exact": per
    set a first-K ball query (K = max_num_points_per_query on xyz,
    max_num_points_per_query_shift on xyz + offsets) and list CCL, the
    reference's neighbour semantics; its two hash-CCL counters are zero, and
    `ccl_unconverged` counts the sets whose CCL the iteration cap cut off
    before its fixpoint (zero with impl="hash")."""
    with span("cluster:cloud"):
        if impl == "hash":
            prop = cluster_hash_batch(
                pt_xyz[None], offsets[None], sem_preds[None], valid[None], ball_query_radius,
                min_num_points_per_proposal, max_proposals, hash_node_capacity, hash_cand_cap,
                hash_max_degree,
            )
        elif impl == "exact":
            nbr1, _ = ball_query_single(pt_xyz, sem_preds, valid, ball_query_radius,
                                        max_num_points_per_query)
            lab1, cut1 = connected_components_single(nbr1, valid)
            nbr2, _ = ball_query_single(pt_xyz + offsets, sem_preds, valid, ball_query_radius,
                                        max_num_points_per_query_shift)
            lab2, cut2 = connected_components_single(nbr2, valid)
            zero = torch.zeros((1,), dtype=torch.int32, device=pt_xyz.device)
            prop = _compact(lab1[None], lab2[None], valid[None], min_num_points_per_proposal,
                            max_proposals, zero, zero, (cut1 + cut2)[None])
        else:
            raise ValueError(f"unknown clustering impl {impl}")
        return SampleProposals(*(f[0] for f in prop))


def proposal_cube_coords(
    pt_xyz: torch.Tensor,          # (N, 3)
    prop: SampleProposals,         # one sample
    rand_a: torch.Tensor,          # (3,) placement jitter, min-clamp draw
    rand_b: torch.Tensor,          # (3,) placement jitter, max-clamp draw
    max_proposals: int,
    score_fullscale: float = 28.0,
    score_scale: float = 50.0,
):
    """Per-entry integer cube coordinates in [0, fullscale)^3.

    Returns (coords (2N, 3) int32, pidc (2N,) clipped proposal id, mask).

    The per-proposal mean is accumulated in float64 and rounded to float32:
    a float32 scatter-add sums in an order that differs between the card
    (atomics) and the CPU, and a last-bit change in the mean can move an
    entry across a cell boundary.  The float64 sum makes the mean, and so
    every cell, the same on both devices.
    """
    p = max_proposals
    ep = prop.entry_point.long()
    exyz = pt_xyz[ep]
    pidc = prop.entry_proposal.clamp(0, p - 1)
    mask = prop.entry_mask

    total = segment_sum(exyz.double(), pidc, p, mask=mask)
    count = segment_sum(torch.ones_like(pidc), pidc, p, mask=mask)
    mean = (total / count.clamp(min=1).double()[:, None]).to(pt_xyz.dtype)
    pl = pidc.long()
    centered = exyz - mean[pl]
    cmin = segment_min(centered, pidc, p, mask=mask)
    cmax = segment_max(centered, pidc, p, mask=mask)
    ok_p = (prop.proposal_size > 0)[:, None]
    zero = torch.zeros((), dtype=pt_xyz.dtype, device=pt_xyz.device)
    cmin = torch.where(ok_p, cmin, zero)
    cmax = torch.where(ok_p, cmax, zero)

    extent = (cmax - cmin).amax(dim=-1)
    scales = 1.0 / torch.clamp(div_const(extent, score_fullscale), min=1e-12) - 0.01
    scales = torch.clamp(scales, max=score_scale)

    min_xyz = cmin * scales[:, None]
    max_xyz = cmax * scales[:, None]
    scaled = centered * scales[pl][:, None]

    range_xyz = max_xyz - min_xyz
    offs = (
        -min_xyz
        + torch.clamp(score_fullscale - range_xyz - 0.001, min=0.0) * rand_a[None, :]
        + torch.clamp(score_fullscale - range_xyz + 0.001, max=0.0) * rand_b[None, :]
    )
    scaled = scaled + offs[pl]
    coords = torch.clamp(torch.floor(scaled).to(torch.int32), 0, int(score_fullscale) - 1)
    return coords, pidc, mask


def segmented_voxelize_single(
    pt_xyz: torch.Tensor,
    prop: SampleProposals,
    rand_a: torch.Tensor,
    rand_b: torch.Tensor,
    max_proposals: int,
    score_fullscale: float = 28.0,
    score_scale: float = 50.0,
) -> ProposalGrid:
    """Normalize each proposal into the fullscale cube and voxelize (unit
    voxels) into the PROPOSAL_CELL key space: proposal p owns the 32^3 cell
    at (p % 32, (p // 32) % 32, p // 1024) of a super-grid."""
    with span("grid:proposals"):
        coords, pidc, mask = proposal_cube_coords(
            pt_xyz, prop, rand_a, rand_b, max_proposals, score_fullscale, score_scale
        )
        c = PROPOSAL_CELL
        cell = torch.stack([pidc % c, (pidc // c) % c, pidc // (c * c)], dim=-1)
        keys = pack_coords(cell * c + coords)
        unique_keys, entry_voxel_id, num_voxels = dedup_keys(keys, mask)
        return ProposalGrid(keys=unique_keys, num_voxels=num_voxels, entry_voxel_id=entry_voxel_id)


def segmented_dense_voxelize_single(
    pt_xyz: torch.Tensor,
    prop: SampleProposals,
    rand_a: torch.Tensor,
    rand_b: torch.Tensor,
    max_proposals: int,
    score_fullscale: float = 28.0,
    score_scale: float = 50.0,
) -> torch.Tensor:
    """Per-entry linear site index into the dense (P, S, S, S) proposal grid:
    ((pid*S + x)*S + y)*S + z, or -1 for invalid entries."""
    s = int(score_fullscale)
    with span("grid:proposals"):
        coords, pidc, mask = proposal_cube_coords(
            pt_xyz, prop, rand_a, rand_b, max_proposals, score_fullscale, score_scale
        )
        lin = ((pidc * s + coords[:, 0]) * s + coords[:, 1]) * s + coords[:, 2]
        return torch.where(mask, lin, torch.full_like(lin, -1))
