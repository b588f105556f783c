"""The plain reference of the published grouping: first-K ball query, CCL,
and each cloud's proposals.

GAPartNet (Geng et al., CVPR 2023, arXiv:2211.05272) groups each cloud twice
(`gapartnet/.../grouping_utils.py:108-140`, `cluster_proposals`): on xyz
with the first K = 50 neighbours and on xyz + offsets with the first
K = 300, each a ball query of radius r = 0.04 among points of the same
semantic label, then connected components of the neighbour graph.  Here in
plain float32 PyTorch, with no tile, no band and no iteration cap; nothing
of the measured program is imported.

Departures from the published description, each noted where it matters:

  * the squared distance is the chain a compiled float32 kernel rounds,
    d = q - p rounded to float32 per coordinate, then
    fma(dz, dz, fma(dy, dy, dx * dx)): dx * dx rounded once, each fused
    multiply-add rounded once (`fma32`).  The published CUDA kernel sums
    dx*dx + dy*dy + dz*dz as its compiler contracts it; the program
    documents this chain (its `ops/ball_query.py`), and for clouds of at
    most 1024 points it takes fma(dz, dz, fma(dx, dx, dy * dy)) instead,
    which this reference does not: compare clouds of more than 1024 points;
  * "first K" is the K smallest point indices among the hits (the
    published kernel's scan-and-stop order), the query itself included;
  * only valid points query or match (the published code groups the
    foreground points it selects first);
  * components are labelled by min-label propagation over the
    symmetrized neighbour lists, run to its fixpoint: each component takes
    its least point index;
  * proposals keep components of at least `min_points` points, in
    ascending (set, label) order (`model.proposals_from_labels`), with no
    cap on their number.
"""

from typing import Dict, List, Sequence, Tuple

import torch

from portbench.reference.model import proposals_from_labels

# (query, point) pairs per block of queries
BLOCK_PAIRS = 1 << 24


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 tensors, rounded once to float32 (to nearest,
    ties to even).

    a * b is exact in float64; s = a * b + c in float64 with its exact
    error e (Knuth's two-sum), so the value is s + e.  Rounding s to
    float32 rounds s + e the same way unless s lies exactly halfway
    between two float32 values and e is not zero: then the one on e's side
    is nearer."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bv = s - p
    e = (p - (s - bv)) + (c64 - bv)
    r = s.float()
    other = torch.nextafter(r, torch.where(r.double() < s, torch.inf, -torch.inf).float())
    halfway = (r.double() + other.double()) * 0.5 == s
    toward_other = (e != 0) & ((e > 0) == (other > r))
    return torch.where(halfway & (r.double() != s) & toward_other, other, r)


def sq_dist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(Q, 3), (P, 3) float32 -> (Q, P): fma(dz, dz, fma(dy, dy, dx * dx))."""
    dx, dy, dz = (q[:, None, i] - p[None, :, i] for i in range(3))
    return fma32(dz, dz, fma32(dy, dy, dx * dx))


def ball_query(xyz: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, radius: float,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 3), (N,), (N,) bool -> (neighbours (N, K) int64, -1 padded and
    ascending; hits (N,) int64 = min(hits, K)).  Row i lists the K least
    indices j with valid i and j, the same label, and sq_dist <= r2, r2 the
    float32 of radius^2."""
    n = xyz.shape[0]
    dev = xyz.device
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=dev)
    sel = torch.nonzero(valid).squeeze(1)
    pts = xyz.float()[sel]
    lab = labels.long()[sel]
    m = sel.shape[0]
    nbr = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    hits = torch.zeros((n,), dtype=torch.int64, device=dev)
    block = max(1, BLOCK_PAIRS // max(m, 1))
    for q0 in range(0, m, block):
        q1 = min(m, q0 + block)
        ok = (sq_dist(pts[q0:q1], pts) <= r2) & (lab[q0:q1, None] == lab[None, :])
        # the least K positions among the hits; valid points are in index order
        pos = torch.where(ok, torch.arange(m, device=dev)[None], m)
        first = torch.sort(pos, dim=1).values[:, :k]
        idx = torch.where(first < m, sel[first.clamp(max=m - 1)], -1)
        nbr[sel[q0:q1], :idx.shape[1]] = idx
        hits[sel[q0:q1]] = ok.sum(1).clamp(max=k)
    return nbr, hits


def ball_query_counts(nbr: torch.Tensor, hits: torch.Tensor, k: int) -> Dict[str, int]:
    """What one ball query lists, as the program counts it: rows whose hits
    reached K, neighbours listed, and the sum of their indices (the least K
    of a row's hits give the least sum, so any other K of them reads more)."""
    return {"ball_query_full_rows": int((hits == k).sum()), "ball_query_hits": int(hits.sum()),
            "ball_query_index_sum": int(nbr.clamp(min=0).sum())}


def components(nbr: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, K) neighbour lists (-1 padded), (N,) bool -> (N,) int64: the
    least point index of each node's component in the graph of the lists
    taken as undirected edges; invalid nodes label themselves."""
    n = nbr.shape[0]
    dev = nbr.device
    ids = torch.arange(n, device=dev)
    has = nbr >= 0
    src = ids[:, None].expand_as(nbr)[has]
    dst = nbr[has].long()
    labels = ids.clone()
    while True:
        low = torch.minimum(labels[src], labels[dst])
        new = labels.clone()
        new.scatter_reduce_(0, src, low, reduce="amin")
        new.scatter_reduce_(0, dst, low, reduce="amin")
        if torch.equal(new, labels):
            break
        labels = new
    return torch.where(valid, labels, ids)


def cloud_proposals(xyz: torch.Tensor, offsets: torch.Tensor, sem: torch.Tensor,
                    valid: torch.Tensor, radius: float, k: int, k_shift: int,
                    min_points: int) -> Tuple[torch.Tensor, int, Dict[str, int]]:
    """One cloud grouped on xyz (first `k`) and on xyz + offsets (first
    `k_shift`): (entry proposal id (2N,), -1 off; number of proposals; the
    two ball queries' `ball_query_counts`, summed)."""
    labels, counts = [], {}
    for pts, cap in ((xyz, k), (xyz + offsets, k_shift)):
        nbr, hits = ball_query(pts, sem, valid, radius, cap)
        labels.append(components(nbr, valid))
        for name, v in ball_query_counts(nbr, hits, cap).items():
            counts[name] = counts.get(name, 0) + v
    return (*proposals_from_labels(labels[0], labels[1], valid, min_points), counts)


def batch_proposals(points: torch.Tensor, offsets: torch.Tensor, sem: torch.Tensor,
                    valid: torch.Tensor, model: dict
                    ) -> Tuple[Tuple[torch.Tensor, torch.Tensor, List[int]], Dict[str, int]]:
    """The proposals of a batch as `model.GAPartNet.forward` takes them,
    (entry point (B, 2N), entry proposal id (B, 2N), proposals per cloud),
    with the radius, caps and filter of a configuration's `model` block;
    and the batch's `ball_query_counts`, summed over its clouds and sets."""
    b, n = valid.shape
    per: Sequence = [cloud_proposals(points[i, :, :3], offsets[i], sem[i], valid[i],
                                     model["ball_query_radius"],
                                     model["max_num_points_per_query"],
                                     model["max_num_points_per_query_shift"],
                                     model["min_num_points_per_proposal"]) for i in range(b)]
    entry_point = torch.arange(n, device=points.device).repeat(2)[None].expand(b, 2 * n)
    counts = {name: sum(c[name] for _, _, c in per) for name in per[0][2]}
    return (entry_point, torch.stack([p for p, _, _ in per]), [c for _, c, _ in per]), counts
