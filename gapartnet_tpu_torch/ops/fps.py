"""Furthest point sampling (counterpart of ops/fps.py).

Greedy max-min-distance sampling seeded at `start_idx`: each step updates
the running minimum squared distance to the chosen set and takes the first
point that maximises it.  Invalid points are pinned at -inf and never
chosen.  The loop runs on the tensors' device with no host synchronisation.
"""

from typing import Optional

import torch


def furthest_point_sampling_single(
    pt_xyz: torch.Tensor,
    num_samples: int,
    valid: Optional[torch.Tensor] = None,
    start_idx: int = 0,
) -> torch.Tensor:
    """(N, 3) points -> (num_samples,) int32 indices.

    Squared distances are float32 and formed as (dx^2 + dy^2) + dz^2, one
    rounding per operation, so the card and the CPU choose the same points.
    The JAX package keeps the distance field unmasked and masks a copy each
    step; pinning invalid points at -inf from the start gives the same
    argmax, since min(-inf, d) = -inf.  If fewer than num_samples valid
    points exist, indices repeat (as in the JAX package)."""
    n = pt_xyz.shape[0]
    dev = pt_xyz.device
    xyz = pt_xyz.to(torch.float32).T.contiguous()                    # (3, N)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    dists = torch.where(valid, float("inf"), float("-inf")).to(torch.float32)
    out = torch.zeros((num_samples,), dtype=torch.int64, device=dev)
    out[0] = start_idx
    last = out[0:1]
    for i in range(1, num_samples):
        diff = xyz - xyz.index_select(1, last)
        diff.mul_(diff)
        d = diff[0] + diff[1]
        d.add_(diff[2])
        torch.minimum(dists, d, out=dists)
        last = out[i:i + 1]
        torch.argmax(dists, dim=0, keepdim=True, out=last)
    return out.to(torch.int32)
