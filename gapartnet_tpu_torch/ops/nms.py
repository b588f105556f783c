"""Greedy non-maximum suppression over a dense point-set IoU matrix.

Counterpart of ops/nms.py.  Proposals are visited in descending score order
(a stable sort, invalid slots last); a proposal is kept unless an already
kept one overlaps it with IoU > threshold.  The greedy pass is a loop over
the P slots on the tensors' device, with no host synchronisation inside.
"""

import torch


def nms_single(ious: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, threshold: float):
    """Keep mask (P,) bool; invalid proposals are never kept.

    In score order, slot i is kept iff it is valid and no kept slot before
    it overlaps it.  `alive` holds that answer for every slot not yet
    visited: visiting a kept slot i clears the slots after i that it
    overlaps, so `alive[i]` is final when the loop reaches i (the JAX
    package's keep/suppressed pair, in two kernels per slot)."""
    p = scores.shape[0]
    order = torch.sort(torch.where(valid, -scores, float("inf")), stable=True).indices
    over = torch.triu(ious[order][:, order] > threshold, diagonal=1)
    alive = valid[order]
    for i in range(p):
        alive.masked_fill_(over[i] & alive[i], False)
    keep = torch.empty_like(alive)
    keep[order] = alive
    return keep


def pairwise_pointset_iou(
    entry_point_idx: torch.Tensor,
    entry_proposal: torch.Tensor,
    entry_mask: torch.Tensor,
    num_points_per_proposal: torch.Tensor,
    num_points: int,
) -> torch.Tensor:
    """Dense (P, P) IoU between the proposal point sets of one sample.

    M[p, point] in {0, 1} (masked entries go to a dump row P), then
    intersection = M @ M^T; with TF32 off (`entry.use_fp32_math`) the
    counts are exact."""
    p = num_points_per_proposal.shape[0]
    ok = entry_mask & (entry_proposal >= 0)
    rows = torch.where(ok, entry_proposal, torch.full_like(entry_proposal, p)).long()
    cols = torch.where(ok, entry_point_idx, torch.zeros_like(entry_point_idx)).long()
    membership = torch.zeros((p + 1, num_points), dtype=torch.float32, device=entry_point_idx.device)
    membership[rows, cols] = 1.0
    membership = membership[:p]
    inter = membership @ membership.T
    sizes = num_points_per_proposal.to(torch.float32)
    union = sizes[:, None] + sizes[None, :] - inter
    return inter / (union + 1e-8)
