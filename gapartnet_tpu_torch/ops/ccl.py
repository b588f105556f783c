"""Connected components of a fixed-shape neighbour graph (counterpart of
ops/ccl.py `connected_components_single`).

The graph is the (N, K) first-K neighbour list of ops/ball_query.py.  Min-
label propagation with pointer jumping: each iteration pulls the minimum
label over a node's neighbours, pushes each node's label onto its
neighbours (a scatter-min, which symmetrizes the capped directed graph;
absent neighbours go to a dump slot, JAX's `mode="drop"`), then jumps
pointers twice.  As the JAX `while_loop`, the loop tests for convergence
before each iteration (labels unchanged by the last one) and stops after
`max_iters`.  The test is one host synchronisation per iteration.  Labels
converge to the minimum point index of each component; invalid nodes
label themselves.  `STATS` counts calls and iterations.
"""

import torch

STATS = {"calls": 0, "iterations": 0}


def connected_components_single(
    neighbor_idx: torch.Tensor,
    valid: torch.Tensor,
    max_iters: int = 64,
) -> torch.Tensor:
    """(N, K) int32 neighbour lists (-1 padded), (N,) bool -> (N,) int32
    labels: the minimum point index of each node's component."""
    n = neighbor_idx.shape[0]
    dev = neighbor_idx.device
    self_idx = torch.arange(n, dtype=torch.int32, device=dev)
    nbr_ok = neighbor_idx >= 0
    nbr = torch.where(nbr_ok, neighbor_idx, self_idx[:, None]).long()
    targets = torch.where(nbr_ok, nbr, n).reshape(-1)
    big = torch.full_like(neighbor_idx, n)
    STATS["calls"] += 1
    labels = self_idx
    for it in range(max_iters):
        if it > 0 and torch.equal(labels, prev):
            break
        STATS["iterations"] += 1
        prev = labels
        # pull
        labels = torch.minimum(labels, torch.where(nbr_ok, labels[nbr], big).amin(dim=1))
        # push: scatter-min of each node's label onto its neighbours
        pushed = torch.cat([labels, labels.new_full((1,), n)])
        pushed.scatter_reduce_(0, targets, labels[:, None].expand_as(nbr).reshape(-1),
                               reduce="amin", include_self=True)
        labels = pushed[:n]
        # pointer jumping: labels are point indices
        labels = labels[labels.long()]
        labels = labels[labels.long()]
    return torch.where(valid, labels, self_idx)
