"""Instance-segmentation AP evaluation (counterpart of eval/ap.py).

Device side: the score / size filter and greedy NMS over point-set IoU
(`select_eval_proposals`).  Host side: the VOC-style AP matching loop of the
reference (grouping_utils.py:302-454), sequential by construction and kept
in NumPy as the JAX package keeps it: proposals of a whole split are sorted
by confidence, greedily matched to unmatched ground-truth instances of the
same class with IoU > threshold, and per-class precision/recall envelopes
are integrated.
"""

from typing import Dict, List, Sequence

import numpy as np
import torch

from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.ops.nms import nms_single, pairwise_pointset_iou


def select_eval_proposals(out, cfg: GAPartNetConfig, num_points: int) -> torch.Tensor:
    """Score / size filter + NMS; keep mask (B, P) bool on the outputs'
    device.  Thresholds of the reference (model.py:46-49, yaml:32): score >
    0.09, more than 3 points, NMS IoU 0.3."""
    prop = out.proposals
    valid = (
        prop.proposal_mask
        & (out.score_preds > cfg.val_score_threshold)
        & (prop.proposal_size > cfg.val_min_num_points_per_proposal)
    )
    keep = []
    for b in range(valid.shape[0]):
        ious = pairwise_pointset_iou(prop.entry_point[b], prop.entry_proposal[b], prop.entry_mask[b],
                                     prop.proposal_size[b], num_points)
        keep.append(nms_single(ious, out.score_preds[b], valid[b], cfg.val_nms_iou_threshold))
    return torch.stack(keep)


class APEvaluator:
    """Accumulates per-batch eval records on the host; computes AP at the end.

    Mirrors compute_ap / _compute_ap (grouping_utils.py:345-454): one `add`
    per eval batch plays the role of one reference `Instances` element, with
    matched flags per (batch, sample, instance).
    """

    def __init__(self, num_classes: int = 10):
        self.num_classes = num_classes
        self.records: List[Dict[str, np.ndarray]] = []

    def add(
        self,
        scores: np.ndarray,              # (P,) kept proposals of one batch
        classes: np.ndarray,             # (P,) predicted semantic class
        sample_idx: np.ndarray,          # (P,) sample index within the batch
        ious: np.ndarray,                # (P, I) IoU vs that sample's instances
        instance_sem_labels: np.ndarray, # (B, I) GT class per instance (-1 pad)
    ):
        self.records.append(
            dict(
                scores=np.asarray(scores, np.float64),
                classes=np.asarray(classes, np.int64),
                sample_idx=np.asarray(sample_idx, np.int64),
                ious=np.asarray(ious, np.float64),
                isl=np.asarray(instance_sem_labels, np.int64),
            )
        )

    @staticmethod
    def _voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
        """Precision-envelope area (grouping_utils.py:302-341, non-07 branch)."""
        mrec = np.concatenate([[0.0], rec, [1.0]])
        mpre = np.concatenate([[0.0], prec, [0.0]])
        for i in range(len(mpre) - 1, 0, -1):
            mpre[i - 1] = max(mpre[i - 1], mpre[i])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))

    def compute(self, iou_threshold: float) -> List[float]:
        """Per-class APs for classes 1..num_classes-1."""
        if not self.records:
            return [0.0] * (self.num_classes - 1)

        conf = np.concatenate([r["scores"] for r in self.records])
        classes = np.concatenate([r["classes"] for r in self.records])
        rec_idx = np.concatenate(
            [np.full(len(r["scores"]), i) for i, r in enumerate(self.records)]
        )
        sample_idx = np.concatenate([r["sample_idx"] for r in self.records])
        local_idx = np.concatenate(
            [np.arange(len(r["scores"])) for r in self.records]
        )
        order = np.argsort(-conf, kind="stable")

        matched = [np.zeros_like(r["isl"], dtype=bool) for r in self.records]
        tp = np.zeros(len(conf))
        fp = np.zeros(len(conf))
        for rank, i in enumerate(order):
            r = self.records[rec_idx[i]]
            s = sample_idx[i]
            cls = classes[i]
            ious_i = r["ious"][local_idx[i]].copy()
            ious_i[r["isl"][s] != cls] = 0.0
            if ious_i.size == 0:
                max_iou, max_j = 0.0, 0
            else:
                max_j = int(np.argmax(ious_i))
                max_iou = float(ious_i[max_j])
            if max_iou > iou_threshold:
                if not matched[rec_idx[i]][s, max_j]:
                    tp[rank] = 1.0
                    matched[rec_idx[i]][s, max_j] = True
                else:
                    fp[rank] = 1.0
            else:
                fp[rank] = 1.0

        sorted_classes = classes[order]
        gt_classes = np.concatenate([r["isl"].reshape(-1) for r in self.records])
        aps = []
        for cls in range(1, self.num_classes):
            num_gt = int((gt_classes == cls).sum())
            m = sorted_classes == cls
            tpc, fpc = tp[m], fp[m]
            if len(tpc) == 0:
                aps.append(0.0)
                continue
            tpc = np.cumsum(tpc)
            fpc = np.cumsum(fpc)
            recall = tpc / max(num_gt, 1) if num_gt > 0 else tpc * 0.0
            prec = tpc / (tpc + fpc + 1e-8)
            aps.append(self._voc_ap(recall, prec))
        return aps

    def compute_map(self, thresholds: Sequence[float] = None):
        """AP@50, mAP(0.50:0.05:0.95), and the per-class AP@50 list
        (model.py:734-745 semantics: mAP = mean over thresholds AND classes).
        """
        if thresholds is None:
            thresholds = [0.5 + 0.05 * i for i in range(10)]
        all_aps = [self.compute(t) for t in thresholds]
        ap50 = all_aps[thresholds.index(0.5)] if 0.5 in thresholds else all_aps[0]
        return dict(
            AP50=float(np.mean(ap50)),
            mAP=float(np.mean(np.asarray(all_aps))),
            AP50_per_class=ap50,
        )


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def batch_to_records(out, keep, batch_isl):
    """Flatten an eval batch into the arguments of one APEvaluator.add.

    Uses the *predicted* class of each proposal (model.py:825: the sem pred
    at the proposal's first point)."""
    keep = _host(keep)
    scores = _host(out.score_preds)
    ious = _host(out.ious) if out.ious is not None else None
    rep_cls = _host(_proposal_pred_classes(out.proposals, out.sem_preds))
    flat_scores, flat_cls, flat_sample, flat_ious = [], [], [], []
    for bi in range(keep.shape[0]):
        sel = np.nonzero(keep[bi])[0]
        flat_scores.append(scores[bi, sel])
        flat_cls.append(rep_cls[bi, sel])
        flat_sample.append(np.full(len(sel), bi))
        if ious is not None:
            flat_ious.append(ious[bi, sel])
    return (
        np.concatenate(flat_scores),
        np.concatenate(flat_cls),
        np.concatenate(flat_sample),
        np.concatenate(flat_ious) if ious is not None else None,
        _host(batch_isl),
    )


def _proposal_pred_classes(prop, sem_preds: torch.Tensor) -> torch.Tensor:
    """(B, P) int64: each proposal's predicted class, the sem pred of its
    lowest-index point (point N-1 for an empty proposal), on sem_preds'
    device."""
    b, p = prop.proposal_mask.shape
    n = sem_preds.shape[1]
    em = prop.entry_mask
    rows = torch.where(em, prop.entry_proposal.long(), torch.full_like(prop.entry_proposal, p).long())
    pts = torch.where(em, prop.entry_point.long(), torch.full_like(prop.entry_point, n).long())
    rep = torch.full((b, p + 1), n, dtype=torch.int64, device=sem_preds.device)
    rep.scatter_reduce_(1, rows, pts, reduce="amin", include_self=True)
    rep = rep[:, :p].clamp(0, n - 1)
    return torch.gather(sem_preds.long(), 1, rep)
