"""Proposal-vs-ground-truth-instance IoU (counterpart of ops/iou.py).

Intersection counts come from one segment sum over fused (proposal,
instance) ids; everything is integer counting, so the card and the CPU
agree exactly.
"""

import torch

from gapartnet_tpu_torch.ops.segment import segment_sum


def instance_seg_iou(
    entry_proposal: torch.Tensor,           # (E,) proposal id per entry, -1 ignore
    entry_instance: torch.Tensor,           # (E,) GT instance of the entry's point, -100 none
    entry_mask: torch.Tensor,               # (E,) bool
    num_points_per_proposal: torch.Tensor,  # (P,) int
    num_points_per_instance: torch.Tensor,  # (I,) int, 0 pads
    num_proposals: int,
    num_instances: int,
) -> torch.Tensor:
    """One sample -> (P, I) float32 IoU."""
    ok = (
        entry_mask
        & (entry_proposal >= 0)
        & (entry_instance >= 0)
        & (entry_instance < num_instances)
    )
    fused = entry_proposal * num_instances + entry_instance
    inter = segment_sum(
        torch.ones_like(fused, dtype=torch.int32), fused,
        num_proposals * num_instances, mask=ok,
    ).reshape(num_proposals, num_instances)
    sizes_p = num_points_per_proposal.to(torch.float32)[:, None]
    sizes_i = num_points_per_instance.to(torch.float32)[None, :]
    union = sizes_p + sizes_i - inter
    return inter / torch.clamp(union, min=1.0)
