"""The plain reference of a mask-conditioned pose request.

Given one cloud and its instance masks: the eval forward on the masks as
proposals, each mask's score and class (the sem prediction of its
lowest-index point), the NPCS map over the cloud (a point in two masks
keeps the later one's), and one 9-DoF box per mask with more than
`min_bbox_points` points: RANSAC over minimal samples of 5, drawn with
replacement among the mask's points from a CPU torch.Generator, then an
Umeyama refit on the winner's inliers and the inliers' extents in NPCS.
"""

from typing import List, Optional

import numpy as np
import torch

from portbench.reference.model import GAPartNet

NPCS_BACKGROUND = 230.0 / 255.0
BOX_SIGNS = ((-1, -1, -1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1),
             (1, 1, -1), (1, -1, 1), (-1, 1, 1), (1, 1, 1))


def mask_proposals(masks: np.ndarray, n: int, device):
    """(entry_point (1, 2N), entry_pid (1, 2N), [M]): each mask's points in
    ascending order, mask after mask."""
    ep = np.zeros(2 * n, np.int64)
    pid = np.full(2 * n, -1, np.int64)
    pos = 0
    for i, m in enumerate(masks):
        idx = np.nonzero(m[:n])[0][:2 * n - pos]
        ep[pos:pos + len(idx)] = idx
        pid[pos:pos + len(idx)] = i
        pos += len(idx)
    return (torch.as_tensor(ep, device=device)[None], torch.as_tensor(pid, device=device)[None],
            [len(masks)])


def umeyama(src, tgt, mask):
    """Similarity src -> tgt over rows where mask: (scale, R, t), with
    tgt ~= scale * src @ R + t; a reflection flips the last axis."""
    w = mask.to(src.dtype)[..., None]
    cnt = torch.clamp(w.sum(dim=(-2, -1)), min=1.0)[..., None]
    sc, tc = (src * w).sum(-2) / cnt, (tgt * w).sum(-2) / cnt
    cs, ct = (src - sc[..., None, :]) * w, (tgt - tc[..., None, :]) * w
    U, D, Vh = torch.linalg.svd(ct.transpose(-1, -2) @ cs / cnt[..., None], full_matrices=True)
    neg = (torch.linalg.det(U) * torch.linalg.det(Vh)) < 0.0
    flip = torch.ones_like(D)
    flip[..., -1] = -1.0
    flip = torch.where(neg[..., None], flip, torch.ones_like(D))
    D, U = D * flip, U * flip[..., None, :]
    var = ((cs * cs) * w).sum(dim=(-2, -1)) / cnt[..., 0]
    scale = D.sum(-1) / torch.clamp(var, min=1e-12)
    rot = (U @ Vh).transpose(-1, -2)
    trans = tc - (sc * scale[..., None])[..., None, :].matmul(rot)[..., 0, :]
    return scale, rot, trans


def ransac_samples(mask: torch.Tensor, iters: int, seed: int) -> torch.Tensor:
    probs = mask.to("cpu", torch.float64)
    probs = torch.where(probs.sum(dim=1, keepdim=True) > 0, probs, torch.ones_like(probs))
    idx = torch.multinomial(probs, iters * 5, replacement=True,
                            generator=torch.Generator().manual_seed(seed))
    return idx.reshape(mask.shape[0], iters, 5).to(mask.device)


def ransac_box(src, tgt, mask, samples, stop: float = 0.5):
    """(boxes (J, 8, 3), ok (J,)) for jobs src/tgt (J, M, 3), mask (J, M)."""
    fm = mask.float()
    cnt = torch.clamp(fm.sum(-1), min=1.0)
    s_norm = (torch.linalg.vector_norm(src, dim=-1) * fm).sum(-1) / cnt
    t_norm = (torch.linalg.vector_norm(tgt, dim=-1) * fm).sum(-1) / cnt
    thr = torch.maximum(s_norm / torch.clamp(t_norm, min=1e-12), t_norm / torch.clamp(s_norm, min=1e-12))
    best = []
    for j in range(src.shape[0]):
        s = src[j][samples[j]]                                    # (I, 5, 3)
        t = tgt[j][samples[j]]
        sc, r, tr = umeyama(s, t, torch.ones(s.shape[:-1], dtype=torch.bool, device=s.device))
        pred = src[j][None] @ (r * sc[:, None, None]) + tr[:, None, :]
        res = torch.where(mask[j][None], torch.linalg.vector_norm(tgt[j][None] - pred, dim=-1), 0.0)
        resid = torch.linalg.vector_norm(res, dim=-1)
        resid = torch.where(torch.isfinite(resid), resid, float("inf"))
        below = resid < stop
        w = int(torch.argmax(below.int())) if bool(below.any()) else int(torch.argmin(resid))
        best.append(res[w])
    best = torch.stack(best)
    inl = (best < thr[:, None]) & mask
    ok = inl.sum(-1) / cnt >= 0.01
    scale, rot, trans = umeyama(src, tgt, inl)
    seg = ((tgt - trans[:, None, :]) @ torch.linalg.pinv(rot)) / torch.clamp(scale, min=1e-12)[:, None, None]
    ext = torch.where(inl[..., None], seg.abs(), 0.0).amax(dim=-2)
    signs = torch.tensor(BOX_SIGNS, dtype=torch.float32, device=src.device)
    return ((signs * ext[:, None, :]) * scale[:, None, None]) @ rot + trans[:, None, :], ok


@torch.no_grad()
def predict_with_masks(model: GAPartNet, points: np.ndarray, masks: np.ndarray,
                       ransac_iters: int = 100, min_bbox_points: int = 10, seed: int = 0):
    """(sem_logits (N, C), scores (M,), classes (M,), npcs_map (N, 3),
    boxes: per mask an (8, 3) array or None)."""
    dev = next(model.parameters()).device
    model.eval()
    n = points.shape[0]
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)[None]
    ep, pid, nprop = mask_proposals(masks, n, dev)
    out = model(pts, torch.ones((1, n), dtype=torch.bool, device=dev), proposals=(ep, pid, nprop))
    m = nprop[0]
    scores = out["score_preds"][0, :m].cpu().numpy()
    classes = out["sem_preds"][0][out["proposal_rep"][0, :m]].cpu().numpy()
    ep0, pid0 = ep[0].cpu().numpy(), pid[0].cpu().numpy()
    npcs = out["npcs_preds"][0].cpu().numpy()
    npcs_map = np.full((n, 3), NPCS_BACKGROUND, np.float32)
    live = np.nonzero(pid0 >= 0)[0]
    npcs_map[ep0[live]] = npcs[live]            # entries in order: the later mask wins
    xyz = points[:, :3].astype(np.float32)
    counts = np.bincount(pid0[live], minlength=m)
    fit = [i for i in range(m) if counts[i] > min_bbox_points]
    boxes: List[Optional[np.ndarray]] = [None] * m
    if fit:
        cap = int(counts[fit].max())
        src = np.zeros((len(fit), cap, 3), np.float32)
        tgt = np.zeros((len(fit), cap, 3), np.float32)
        msk = np.zeros((len(fit), cap), bool)
        for j, i in enumerate(fit):
            e = live[pid0[live] == i]
            src[j, :len(e)] = npcs[e] - 0.5
            tgt[j, :len(e)] = xyz[ep0[e]]
            msk[j, :len(e)] = True
        mt = torch.as_tensor(msk, device=dev)
        bx, ok = ransac_box(torch.as_tensor(src, device=dev), torch.as_tensor(tgt, device=dev), mt,
                            ransac_samples(mt, ransac_iters, seed))
        bx, ok = bx.cpu().numpy(), ok.cpu().numpy()
        for j, i in enumerate(fit):
            boxes[i] = bx[j] if ok[j] else None
    return out["sem_logits"][0].cpu().numpy(), scores, classes, npcs_map, boxes
