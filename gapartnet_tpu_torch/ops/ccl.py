"""Connected components of a fixed-shape neighbour graph (counterpart of
ops/ccl.py `connected_components_single`).

The graph is the (N, K) first-K neighbour list of ops/ball_query.py.  Min-
label propagation with pointer jumping: each iteration pulls the minimum
label over a node's neighbours, pushes each node's label onto its
neighbours (a scatter-min, which symmetrizes the capped directed graph;
absent neighbours go to a dump slot, JAX's `mode="drop"`), then jumps
pointers twice.  As the JAX `while_loop`, the loop tests for convergence
before each iteration (labels unchanged by the last one) and stops after
`max_iters`.  The test is one host synchronisation per iteration
(`sync:ccl_exact_converged`; the span of a call is `cluster:ccl`).  Labels
converge to the minimum point index of each component; invalid nodes
label themselves.  When the cap ends the loop, one more test tells
whether one more iteration would still change a label: then the loop ended
before the fixpoint, and the labels are another grouping's (the second
value returned says so; the counters `ccl_exact_iterations` and
`ccl_exact_unconverged` count both).  Either way a call makes as many
tests as iterations.  `STATS` counts calls and iterations.
"""

from typing import Tuple

import torch

from gapartnet_tpu_torch.utils.profiling import count, span

STATS = {"calls": 0, "iterations": 0}


def connected_components_single(
    neighbor_idx: torch.Tensor,
    valid: torch.Tensor,
    max_iters: int = 64,
) -> Tuple[torch.Tensor, int]:
    """(N, K) int32 neighbour lists (-1 padded), (N,) bool -> ((N,) int32
    labels: the minimum point index of each node's component; 1 where
    `max_iters` ended the loop before the labels reached their fixpoint,
    else 0)."""
    with span("cluster:ccl"):
        n = neighbor_idx.shape[0]
        dev = neighbor_idx.device
        self_idx = torch.arange(n, dtype=torch.int32, device=dev)
        nbr_ok = neighbor_idx >= 0
        nbr = torch.where(nbr_ok, neighbor_idx, self_idx[:, None]).long()
        targets = torch.where(nbr_ok, nbr, n).reshape(-1)
        big = torch.full_like(neighbor_idx, n)

        def propagate(labels):
            # pull
            labels = torch.minimum(labels, torch.where(nbr_ok, labels[nbr], big).amin(dim=1))
            # push: scatter-min of each node's label onto its neighbours
            pushed = torch.cat([labels, labels.new_full((1,), n)])
            pushed.scatter_reduce_(0, targets, labels[:, None].expand_as(nbr).reshape(-1),
                                   reduce="amin", include_self=True)
            labels = pushed[:n]
            # pointer jumping: labels are point indices
            labels = labels[labels.long()]
            return labels[labels.long()]

        STATS["calls"] += 1
        labels = self_idx
        iterations = unconverged = 0
        for it in range(max_iters):
            if it > 0:
                with span("sync:ccl_exact_converged"):
                    done = torch.equal(labels, prev)
                if done:
                    break
            STATS["iterations"] += 1
            iterations += 1
            prev = labels
            labels = propagate(labels)
        else:
            # the cap ended the loop: the labels are final if one more
            # iteration would leave them as they are
            with span("sync:ccl_exact_converged"):
                unconverged = int(not torch.equal(propagate(labels), labels))
        count("ccl_exact_iterations", iterations)
        count("ccl_exact_unconverged", unconverged)
        return torch.where(valid, labels, self_idx), unconverged

