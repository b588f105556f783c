"""Label-constrained fixed-radius neighbour search, first K by index
(counterpart of ops/ball_query.py `ball_query_single`).

For each query point: the K smallest point indices that lie within
`radius`, share the query's label, and are valid (the query too), in
ascending order and -1 padded.  "First K by index" is the reference
kernel's scan-and-stop semantics (grouping_utils.py:108-140).

The JAX function runs under `jit`, where XLA's CPU compiler contracts the
squared distance dx^2 + dy^2 + dz^2 into a chain of fused multiply-adds,
with r2 = float32(radius * radius) taken in Python double.  Which product
it rounds on its own depends on the compiled program: with more than one
block of JAX_QUERY_BLOCK queries (the flagship's 20000 points) the chain
is fma(dz, dz, fma(dy, dy, dx * dx)); with one block (N <= 1024) the
block loop is compiled away and the chain is fma(dz, dz, fma(dx, dx,
dy * dy)).  `fma_sq_dist` computes either chain exactly, in float64 with
round-to-odd, so a pair within an ulp of r2 falls on the same side on the
CPU, on the card and in the reference (tests/test_torch_port_exact_
cluster.py holds both on lattices at spacing exactly `radius`).

Only valid points query or match, so the search runs over them alone, in
tiles of at most TILE_ELEMENTS (query, point) pairs.
A tile first compares the float32 sum of squares with r2: the squares
are non-negative, so that sum and the FMA chain differ by a few ulps of
d2 at most, and only the pairs within BAND of r2 (about one in a million)
are decided by the exact chain, gathered by one `nonzero` (a host sync
per tile).  Within a tile a row's rank among its hits is a cumulative
sum, and the hits of rank <= K are scattered into their slots.  Plain
PyTorch: no kernel of its own.

Spans and counters (utils/profiling.py): `cluster:ball_query` around each
call (its `n` counts the calls); the host syncs `sync:ball_query_constant`
(r2 copied to the device), `sync:ball_query_valid` (the gather of the
valid points) and `sync:ball_query_band` (each tile's band `nonzero`); the
counters `ball_query_tiles`, `ball_query_band_pairs` (the pairs the exact
chain decides) and, reduced on the device and only while a recording is
on, `ball_query_full_rows` (rows whose hits reached K), `ball_query_hits`
(the neighbours listed) and `ball_query_index_sum` (the sum of their
indices, which tells the first K from any other K of a row's hits).
"""

import numpy as np
import torch

from gapartnet_tpu_torch.utils.profiling import count, span

# (query, point) pairs per tile: about 70 MB per float64 temporary
TILE_ELEMENTS = 1 << 23
# the JAX function's query block (ops/ball_query.py `query_block`)
JAX_QUERY_BLOCK = 1024
# relative half-width of the band around r2 that the exact chain decides:
# 2^6 times the largest gap between the two sums (three roundings each)
BAND = 2.0 ** -18


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) of float32 tensors, rounded once to float32.

    The product of two float32 values is exact in float64; the sum is
    taken in float64, its rounding error recovered by TwoSum, and the sum
    moved to its odd neighbour when it was inexact (round to odd).  One
    rounding of that to float32 is the correctly rounded fma."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _fma_chain(dx, dy, dz, y_first: bool) -> torch.Tensor:
    if y_first:
        dx, dy = dy, dx
    return fma_f32(dz, dz, fma_f32(dy, dy, dx * dx))


def fma_sq_dist(q: torch.Tensor, p: torch.Tensor, y_first: bool = False) -> torch.Tensor:
    """(Q, 3), (P, 3) float32 -> (Q, P) squared distances, d = q - p, as a
    jitted JAX program rounds them: fma(dz, dz, fma(dy, dy, dx * dx)), or
    with `y_first` fma(dz, dz, fma(dx, dx, dy * dy))."""
    return _fma_chain(*(q[:, None, i] - p[None, :, i] for i in range(3)), y_first)


def within_radius(q: torch.Tensor, p: torch.Tensor, r2: torch.Tensor, y_first: bool) -> torch.Tensor:
    """(Q, P) bool: fma_sq_dist(q, p, y_first) <= r2, with the exact chain
    evaluated only for the pairs whose float32 sum of squares lies within
    BAND of r2."""
    dx, dy, dz = (q[:, None, i] - p[None, :, i] for i in range(3))
    d2 = (dx * dx + dy * dy) + dz * dz
    ok = d2 <= r2
    with span("sync:ball_query_band"):
        near = torch.nonzero((d2 - r2).abs() <= r2 * BAND, as_tuple=True)
    count("ball_query_band_pairs", int(near[0].numel()))
    ok[near] = _fma_chain(dx[near], dy[near], dz[near], y_first) <= r2
    return ok


def ball_query_single(
    pt_xyz: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    max_neighbors: int,
):
    """One sample: (N, 3) positions (queries are the points), (N,) labels,
    (N,) bool validity.  Returns (neighbor_idx (N, K) int32, -1 padded and
    ascending per row; counts (N,) int32 = min(hits, K)).

    Only valid points query or match, so the search runs over the valid
    points alone, gathered in ascending order (one host sync): the first K
    of them by position are the first K by point index.  Invalid rows stay
    -1 with count 0."""
    with span("cluster:ball_query"):
        n = pt_xyz.shape[0]
        k = max_neighbors
        dev = pt_xyz.device
        with span("sync:ball_query_constant"):
            r2 = torch.tensor(np.float32(radius * radius), device=dev)
        with span("sync:ball_query_valid"):
            sel = torch.nonzero(valid).squeeze(1)
        m = sel.shape[0]
        xyz = pt_xyz.to(torch.float32)[sel]
        lab = labels.to(torch.int32)[sel]
        neighbor_idx = torch.full((n, k), -1, dtype=torch.int32, device=dev)
        counts = torch.zeros((n,), dtype=torch.int32, device=dev)
        qb = max(1, TILE_ELEMENTS // max(m, 1))
        for q0 in range(0, m, qb):
            q1 = min(m, q0 + qb)
            count("ball_query_tiles", 1)
            ok = within_radius(xyz[q0:q1], xyz, r2, y_first=n <= JAX_QUERY_BLOCK)
            ok &= lab[q0:q1, None] == lab[None, :]
            rank = torch.cumsum(ok, dim=1, dtype=torch.int32)
            slot = torch.where(ok & (rank <= k), rank - 1, k).long()
            buf = torch.full((q1 - q0, k + 1), -1, dtype=torch.int64, device=dev)
            buf.scatter_(1, slot, sel.expand(q1 - q0, m))
            neighbor_idx[sel[q0:q1]] = buf[:, :k].to(torch.int32)
            counts[sel[q0:q1]] = torch.clamp(rank[:, -1], max=k)
        count("ball_query_full_rows", lambda: (counts == k).sum())
        count("ball_query_hits", lambda: counts.sum())
        count("ball_query_index_sum", lambda: neighbor_idx.clamp(min=0).sum())
        return neighbor_idx, counts
