"""The numbers that decide `correct`, each the program's gap to the reference.

Training (the first three steps of the object the window drives):

  * `loss`: the relative gap of the first step's total loss less its NPCS
    term (the later steps' losses drift apart by the same amplified
    rounding; a sem near-tie that tips one entry's argmax moves the NPCS
    term by a step);
  * `grad`, `change`: the worst leaf's gap between the norms of the
    program's and the reference's first gradient (as Adam got it) or
    parameter change after three steps, over the reference's norm of that
    leaf or of the median leaf, whichever is larger.  A leaf left unmoved
    reads 1 under `change`; sound runs read far less, though the worst
    leaf's change swings from seed to seed (Adam's first steps move every
    element near zero gradient by a full learning rate, whichever way
    rounding tips it).  Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of both: their gradient
    is nought but for round-off (a bias in front of a batch norm sums terms
    that cancel), so both sides hold noise, and Adam moves them by it;
  * `heads`, `proposal_heads`: the first step's sem logits and offsets, and
    its ScoreNet logits and NPCS, as the largest gap over the largest
    reference magnitude;
  * `proposals`: entries whose proposal differs in the first step (exact);
  * `counters`: the sum of every capacity counter over every step (exact).

Requests (a seeded sample of those the window finished): `sem` (logits),
`scores`, `npcs` (the map over the masks' points), `boxes` (corner gap over
the box's diagonal; a box on one side only counts 1) and `counters`
(exact).  Each mask's class is the sem prediction at its first point, so
`sem` judges it.
"""

from typing import Dict, List, Optional

import numpy as np
import torch

LEAF_FLOOR = 1e-3


def rel_gap(prog, ref, mask=None) -> float:
    """max |prog - ref| / max |ref| (over `mask`)."""
    p = torch.as_tensor(prog).double()
    r = torch.as_tensor(ref).double()
    if mask is not None:
        m = torch.as_tensor(mask)
        p, r = p[m], r[m]
    if r.numel() == 0:
        return 0.0
    return float((p - r).abs().max() / torch.clamp(r.abs().max(), min=1e-30))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              grads_ref: Dict[str, float]) -> Dict[str, float]:
    """Per leaf, |norm_prog - norm_ref| / max(norm_ref, median leaf), over
    the leaves whose reference gradient is at least LEAF_FLOOR of the
    median leaf's, the median taken over the leaves the loss reaches (a
    PointNet transformer behind its zero-initialised last layer gets no
    gradient in the first step)."""
    gmed = float(np.median([g for g in grads_ref.values() if g > 0] or [0.0]))
    keep = [k for k in ref if grads_ref[k] >= LEAF_FLOOR * gmed]
    med = float(np.median([ref[k] for k in keep]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def leaf_norm_gap(prog: Dict[str, float], ref: Dict[str, float],
                  grads_ref: Dict[str, float]) -> float:
    """The worst leaf's gap (`leaf_gaps`)."""
    return max(leaf_gaps(prog, ref, grads_ref).values())


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    grads_ref: Dict[str, float]) -> float:
    """The median leaf's gap (`leaf_gaps`)."""
    return float(np.median(list(leaf_gaps(prog, ref, grads_ref).values())))


def worst_leaves(prog, ref, grads_ref, k: int = 3) -> List[List]:
    """[name, gap, reference norm] of the k worst leaves."""
    gaps = leaf_gaps(prog, ref, grads_ref)
    return [[n, g, ref[n]] for n, g in sorted(gaps.items(), key=lambda x: -x[1])[:k]]


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([tensors[k].double().norm() for k in names]).cpu().tolist()
    return dict(zip(names, norms))


def box_gap(prog: List[Optional[np.ndarray]], ref: List[Optional[np.ndarray]]) -> float:
    worst = 0.0
    for p, r in zip(prog, ref):
        if p is None and r is None:
            continue
        if p is None or r is None:
            return 1.0
        diag = max(float(np.linalg.norm(r.max(0) - r.min(0))), 1e-12)
        worst = max(worst, float(np.linalg.norm(p - r, axis=1).max()) / diag)
    return worst


def judged(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every limited number."""
    return {k: {"value": float(values[k]), "limit": float(limits[k])} for k in limits}
