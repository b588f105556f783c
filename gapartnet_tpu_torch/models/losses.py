"""Loss functions and segmentation metrics (counterpart of models/losses.py).

Masks over fixed shapes, as in the JAX package.  Where a gradient flows,
extremes go through `torch.maximum` / `torch.minimum` with tensor operands
and `torch.amin`, which split the gradient evenly at ties as JAX's
`jnp.maximum`, `jnp.minimum` and `jnp.min` do; `clamp` (which passes the
whole gradient at the boundary) and `min(dim=)` (which picks one index) are
kept off those paths.  `_abs` has JAX's derivative at 0 (+1; torch's
`abs` gives 0 there).

`across_ranks` (the model passes it in training) takes every count over
all ranks of a data-parallel run (parallel/dist.py) while the sums stay
local: rank r's loss is its own sum over the global count, so the ranks'
losses add up to the loss of the whole global batch, as the JAX package's
means are global under a sharded jit.  Without a process group it changes
nothing.
"""

import torch
import torch.nn.functional as F

from gapartnet_tpu_torch.constants import SYMMETRY_ORBITS
from gapartnet_tpu_torch.parallel.dist import all_reduce_
from gapartnet_tpu_torch.ops.segment import segment_count, segment_sum
from gapartnet_tpu_torch.utils.profiling import span


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    with span("sync:loss_constant"):    # the copy to the device waits for it
        return torch.tensor(value, dtype=x.dtype, device=x.device)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with d|x|/dx = +1 at 0, as jnp.abs differentiates."""
    return torch.where(x >= 0, x, -x)


def _count(mask: torch.Tensor, across_ranks: bool) -> torch.Tensor:
    """The number of True entries of `mask`, over every rank when
    `across_ranks`."""
    cnt = mask.sum()
    return all_reduce_(cnt) if across_ranks else cnt


def _mean_over(values: torch.Tensor, mask: torch.Tensor,
               across_ranks: bool = False) -> torch.Tensor:
    """Sum of `values` where `mask`, over max(count, 1) (the count over
    every rank when `across_ranks`)."""
    cnt = torch.clamp(_count(mask, across_ranks), min=1).to(values.dtype)
    return torch.where(mask, values, torch.zeros((), dtype=values.dtype, device=values.device)).sum() / cnt


def focal_loss(logits, targets, mask, gamma: float = 2.0, ignore_index: int = -100, alpha=None,
               across_ranks: bool = False):
    """Multi-class focal loss, mean over valid targets (reference
    losses.py:35-64).  `alpha` scales each sample's CE by alpha[target]
    while the denominator stays the plain valid count."""
    valid = mask & (targets != ignore_index)
    t = torch.clamp(targets, 0, logits.shape[-1] - 1).long()
    log_p = F.log_softmax(logits, dim=-1)
    log_p_t = torch.gather(log_p, -1, t[:, None])[:, 0]
    ce = -log_p_t
    if alpha is not None:
        ce = ce * torch.as_tensor(alpha, dtype=logits.dtype, device=logits.device)[t]
    loss = ce * (1.0 - torch.exp(log_p_t)) ** gamma
    return _mean_over(loss, valid, across_ranks)


def cross_entropy_loss(logits, targets, mask, ignore_index: int = -100, alpha=None,
                       across_ranks: bool = False):
    """The non-focal branch (models/gapartnet.py:351-368): CE, optionally
    weighted per class by `alpha`, mean over the valid count."""
    valid = mask & (targets != ignore_index)
    t = torch.clamp(targets, 0, logits.shape[-1] - 1).long()
    ce = -torch.gather(F.log_softmax(logits, dim=-1), -1, t[:, None])[:, 0]
    if alpha is not None:
        ce = ce * torch.as_tensor(alpha, dtype=torch.float32, device=logits.device)[t]
    return _mean_over(ce, valid, across_ranks)


def dice_loss(logits, targets, mask, eps: float = 1e-8, one_hot_eps: float = 1e-6,
              across_ranks: bool = False):
    """Per-point dice (reference losses.py:110-158 on (N, C, 1, 1) inputs):
    dice_p = 2 sum_c p_c (onehot_c + 1e-6) / sum_c (p_c + onehot_c + 1e-6);
    loss = mean over valid points of (1 - dice_p)."""
    c = logits.shape[-1]
    p = torch.softmax(logits, dim=-1)
    t = torch.clamp(targets, 0, c - 1).long()
    onehot = F.one_hot(t, c).to(logits.dtype) + one_hot_eps
    inter = (p * onehot).sum(-1)
    card = (p + onehot).sum(-1)
    dice = 2.0 * inter / (card + eps)
    return _mean_over(1.0 - dice, mask, across_ranks)


def offset_loss(offsets, gt_offsets, valid, across_ranks: bool = False):
    """L1-distance and cosine-direction losses (reference model.py:204-226).
    The norms are guarded, sqrt(max(., 1e-16)), so the gradient at a zero
    offset is 0 and not NaN."""
    loss_dist = _mean_over(_abs(offsets - gt_offsets).sum(-1), valid, across_ranks)
    tiny = _const(offsets, 1e-16)
    gt_norm = torch.sqrt(torch.maximum((gt_offsets ** 2).sum(-1), tiny))
    gt_dir = gt_offsets / (gt_norm[:, None] + 1e-8)
    norm = torch.sqrt(torch.maximum((offsets ** 2).sum(-1), tiny))
    pred_dir = offsets / (norm[:, None] + 1e-8)
    loss_dir = _mean_over(-(gt_dir * pred_dir).sum(-1), valid, across_ranks)
    return loss_dist, loss_dir


def sigmoid_bce(logits, targets, mask, across_ranks: bool = False):
    """binary_cross_entropy_with_logits, mean over valid (model.py:385)."""
    loss = (torch.maximum(logits, _const(logits, 0.0)) - logits * targets
            + torch.log1p(torch.exp(-_abs(logits))))
    return _mean_over(loss, mask, across_ranks)


def get_gt_scores(ious, fg_thresh: float = 0.75, bg_thresh: float = 0.25):
    """Soft score targets from the max IoU (grouping_utils.py:144-156)."""
    k = 1.0 / (fg_thresh - bg_thresh)
    b = bg_thresh / (bg_thresh - fg_thresh)
    mid = ious * k + b
    one, zero = _const(ious, 1.0), _const(ious, 0.0)
    return torch.where(ious > fg_thresh, one, torch.where(ious < bg_thresh, zero, mid))


def npcs_loss(npcs_preds, gt_npcs, sym_types, proposal_ids, entry_mask, num_proposals: int,
              across_ranks: bool = False):
    """Symmetry-aware NPCS loss (grouping_utils.py:14-43, model.py:423-462).

    Per entry: squared distance d2 to the best orbit image of the GT NPCS,
    smooth-L1-like: d2 <= 0.01 ? 5 d2 : sqrt(d2) - 0.05.  Entries are
    segment-meaned per (proposal, symmetry group) with groups {0,1,2} / {3}
    / {4}; the minimum over the orbit columns is taken per segment, meaned
    over each group's segments, and the three group terms are summed.  A
    segment's entries lie in one cloud, so on one rank; with `across_ranks`
    each group's mean is over the segments of every rank.
    Orbits are padded with their column 0, so padded columns tie with it and
    share its gradient, as under `jnp.min`.
    """
    with span("sync:npcs_orbits"):
        orbits = torch.as_tensor(SYMMETRY_ORBITS, device=npcs_preds.device)   # (5, M, 3, 3)
    morb = orbits.shape[1]
    q = npcs_preds - 0.5
    # |q - gt R|^2 = |q|^2 + |gt|^2 - 2 (gt (x) q) . vec(R), R orthogonal
    outer = (gt_npcs[:, :, None] * q[:, None, :]).reshape(-1, 9)
    t_all = torch.matmul(outer, orbits.reshape(5 * morb, 9).T)             # (E, 5M)
    norms = (q * q).sum(-1) + (gt_npcs * gt_npcs).sum(-1)
    d2_all = norms[:, None] - 2.0 * t_all
    sel = torch.clamp(sym_types, 0, 4).long()
    d2 = torch.gather(
        d2_all.reshape(-1, 5, morb), 1, sel[:, None, None].expand(-1, 1, morb)
    )[:, 0]                                                                # (E, M)
    d2 = torch.maximum(d2, _const(d2, 0.0))  # guard float cancellation near zero
    per_point = torch.where(
        d2 <= 0.01, 5.0 * d2, torch.sqrt(torch.maximum(d2, _const(d2, 1e-12))) - 0.05
    )

    ok = entry_mask & (proposal_ids >= 0)
    group = torch.where(
        sym_types < 3, torch.zeros_like(sym_types),
        torch.where(sym_types == 3, torch.ones_like(sym_types), torch.full_like(sym_types, 2)),
    )
    seg = proposal_ids * 3 + group
    num_segs = num_proposals * 3
    total = segment_sum(per_point, seg, num_segs, mask=ok)                 # (P*3, M)
    count = segment_count(seg, num_segs, mask=ok)
    per_seg = total / torch.clamp(count, min=1)[:, None].to(per_point.dtype)
    per_seg_min = torch.amin(per_seg, dim=-1)                              # (P*3,)

    has_points = count > 0
    seg_group = torch.arange(num_segs, device=seg.device) % 3
    loss = torch.zeros((), dtype=per_point.dtype, device=per_point.device)
    for g in range(3):
        loss = loss + _mean_over(per_seg_min, has_points & (seg_group == g), across_ranks)
    return loss


def pixel_accuracy(preds, labels, mask, across_ranks: bool = False):
    cnt = torch.clamp(_count(mask, across_ranks), min=1)
    return ((preds == labels) & mask).sum().to(torch.float32) / cnt.to(torch.float32)


def mean_iou(preds, labels, mask, num_classes: int):
    """mIoU over classes from the confusion of valid (label >= 0) elements;
    classes absent from both prediction and label count IoU 1.0."""
    valid = mask & (labels >= 0)
    lab = torch.clamp(labels, 0, num_classes - 1)
    pred = torch.clamp(preds, 0, num_classes - 1)
    fused = (lab * num_classes + pred).reshape(-1)
    conf = segment_sum(
        torch.ones(fused.shape, dtype=torch.float32, device=fused.device), fused,
        num_classes * num_classes, mask=valid.reshape(-1),
    ).reshape(num_classes, num_classes)
    tp = torch.diagonal(conf)
    total = conf.sum(0) + conf.sum(1) - tp
    iou = torch.where(total > 0, tp / torch.clamp(total, min=1e-8), torch.ones_like(tp))
    return iou.mean()
