"""Batched Umeyama similarity fitting and RANSAC 9-DoF pose estimation.

Counterpart of ops/umeyama.py.  Every function takes any number of leading
batch dimensions (the JAX package vmaps over proposals; here the batch is a
leading dimension of the tensors).

The JAX package draws its minimal samples inside the fit with
`jax.random.choice`, a stream torch cannot reproduce.  The port separates
the draw from the fit: `ransac_samples` draws on a CPU `torch.Generator`
(so the card and the CPU get the same samples) and `ransac_pose_from_npcs`
takes the drawn indices.
"""

from typing import NamedTuple

import torch

# the 8 corners of the unit box, in the JAX package's order
BOX_SIGNS = (
    (-1, -1, -1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1),
    (1, 1, -1), (1, -1, 1), (-1, 1, 1), (1, 1, 1),
)
# elements of one chunk's (rows, iterations, points) residual tensors
CHUNK_ELEMENTS = 1 << 24


def umeyama_masked(source: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
    """Similarity transform source -> target over the rows where `mask`.

    source, target: (..., M, 3); mask: (..., M) bool.  Returns (scale (...),
    rotation (..., 3, 3), translation (..., 3)), applied to row vectors as
    target ~= scale * source @ rotation + translation.  A reflection is
    fixed by flipping the last singular value and the last column of U."""
    w = mask.to(source.dtype)[..., None]
    cnt = torch.clamp(w.sum(dim=(-2, -1)), min=1.0)[..., None]          # (..., 1)
    sc = (source * w).sum(dim=-2) / cnt
    tc = (target * w).sum(dim=-2) / cnt
    cs = (source - sc[..., None, :]) * w
    ct = (target - tc[..., None, :]) * w
    cov = ct.transpose(-1, -2) @ cs / cnt[..., None]
    U, D, Vh = torch.linalg.svd(cov, full_matrices=True)
    neg = (torch.linalg.det(U) * torch.linalg.det(Vh)) < 0.0
    flip = torch.ones_like(D)
    flip[..., -1] = -1.0
    flip = torch.where(neg[..., None], flip, torch.ones_like(D))
    D = D * flip
    U = U * flip[..., None, :]
    var = ((cs * cs) * w).sum(dim=(-2, -1)) / cnt[..., 0]
    scale = D.sum(dim=-1) / torch.clamp(var, min=1e-12)
    rotation = (U @ Vh).transpose(-1, -2)
    translation = tc - (sc * scale[..., None])[..., None, :].matmul(rotation)[..., 0, :]
    return scale, rotation, translation


class PoseFit(NamedTuple):
    bbox: torch.Tensor         # (..., 8, 3) oriented box corners in camera frame
    scale: torch.Tensor        # (...)
    rotation: torch.Tensor     # (..., 3, 3)
    translation: torch.Tensor  # (..., 3)
    inlier_mask: torch.Tensor  # (..., M) bool
    ok: torch.Tensor           # (...) bool: inlier ratio >= 1% (the reference's gate)


def ransac_samples(mask: torch.Tensor, max_iters: int, generator: torch.Generator) -> torch.Tensor:
    """Minimal samples: (..., max_iters, 5) int64 row indices, drawn with
    replacement uniformly among the rows where `mask` (..., M), on the CPU
    from `generator`, then moved to mask's device.  A batch row with no
    valid entry draws uniformly over all M (its fit is not ok)."""
    m = mask.shape[-1]
    probs = mask.detach().to("cpu", torch.float64).reshape(-1, m)
    probs = torch.where(probs.sum(dim=1, keepdim=True) > 0, probs, torch.ones_like(probs))
    if probs.shape[0] == 0:
        return torch.zeros(mask.shape[:-1] + (max_iters, 5), dtype=torch.int64, device=mask.device)
    idx = torch.multinomial(probs, max_iters * 5, replacement=True, generator=generator)
    return idx.reshape(mask.shape[:-1] + (max_iters, 5)).to(mask.device)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., M, 3) at idx (..., I, 5) -> (..., I, 5, 3)."""
    flat = idx.reshape(idx.shape[:-2] + (-1,))
    g = torch.gather(x, -2, flat[..., None].expand(flat.shape + (3,)))
    return g.reshape(idx.shape + (3,))


def ransac_residuals(npcs, xyz, mask, samples):
    """Fit one hypothesis per sample row and score it on every valid point.

    Returns (res_vec (..., I, M): each point's distance to its prediction,
    0 where masked; residual (..., I): the norm of res_vec, +inf where not
    finite)."""
    s = _gather_rows(npcs, samples)
    t = _gather_rows(xyz, samples)
    ones = torch.ones(s.shape[:-1], dtype=torch.bool, device=s.device)
    scales, rots, trans = umeyama_masked(s, t, ones)                  # (..., I), (..., I, 3, 3)
    pred = npcs[..., None, :, :] @ (rots * scales[..., None, None]) + trans[..., None, :]
    diff = xyz[..., None, :, :] - pred                                # (..., I, M, 3)
    res_vec = torch.linalg.vector_norm(diff, dim=-1)
    res_vec = torch.where(mask[..., None, :], res_vec, 0.0)
    residual = torch.linalg.vector_norm(res_vec, dim=-1)
    return res_vec, torch.where(torch.isfinite(residual), residual, float("inf"))


def ransac_best(npcs, xyz, mask, samples, stop_thrsh: float = 0.5):
    """(the winner's res_vec (..., M), the winner (...)): the first
    hypothesis with a residual below stop_thrsh, else the first arg-min
    (argmax takes no bool, hence the cast).  Computed over chunks of the
    flattened batch so that one chunk's (rows, I, M) tensors stay within
    CHUNK_ELEMENTS (the batch rows are independent)."""
    lead = mask.shape[:-1]
    m, iters = mask.shape[-1], samples.shape[-2]
    npcs, xyz, mask = npcs.reshape(-1, m, 3), xyz.reshape(-1, m, 3), mask.reshape(-1, m)
    samples = samples.reshape(-1, iters, 5)
    step = max(1, CHUNK_ELEMENTS // max(iters * m, 1))
    bests, winners = [], []
    for c in range(0, mask.shape[0], step):
        sl = slice(c, c + step)
        res_vec, residual = ransac_residuals(npcs[sl], xyz[sl], mask[sl], samples[sl])
        below = residual < stop_thrsh
        winner = torch.where(below.any(dim=1), torch.argmax(below.to(torch.int32), dim=1),
                             torch.argmin(residual, dim=1))
        bests.append(torch.gather(res_vec, 1, winner[:, None, None].expand(-1, 1, m))[:, 0])
        winners.append(winner)
    return torch.cat(bests).reshape(lead + (m,)), torch.cat(winners).reshape(lead)


def ransac_pose_from_npcs(
    npcs: torch.Tensor,
    xyz: torch.Tensor,
    mask: torch.Tensor,
    samples: torch.Tensor,
    stop_thrsh: float = 0.5,
) -> PoseFit:
    """The reference's estimate_pose_from_npcs for a batch of proposals.

    npcs: (..., M, 3) NPCS coordinates, already centred (npcs_pred - 0.5);
    xyz: (..., M, 3) camera-frame points; mask: (..., M) validity;
    samples: (..., I, 5) from `ransac_samples` (I = the RANSAC iterations).
    Every hypothesis is fitted and scored at once; the winner is chosen
    without data-dependent control flow, the inliers of the winner are
    refitted, and the box takes the inliers' extents in NPCS."""
    fm = mask.to(torch.float32)
    cnt = torch.clamp(fm.sum(dim=-1), min=1.0)

    # pass threshold (pose_fitting.py:95-101)
    s_norm = (torch.linalg.vector_norm(npcs, dim=-1) * fm).sum(dim=-1) / cnt
    t_norm = (torch.linalg.vector_norm(xyz, dim=-1) * fm).sum(dim=-1) / cnt
    ratio_st = s_norm / torch.clamp(t_norm, min=1e-12)
    ratio_ts = t_norm / torch.clamp(s_norm, min=1e-12)
    pass_thrsh = torch.maximum(ratio_st, ratio_ts)

    best, _ = ransac_best(npcs, xyz, mask, samples, stop_thrsh)
    inliers = (best < pass_thrsh[..., None]) & mask
    ok = inliers.sum(dim=-1) / cnt >= 0.01

    # refit on the inliers, then the box from their extents in NPCS
    scale, rotation, translation = umeyama_masked(npcs, xyz, inliers)
    rot_inv = torch.linalg.pinv(rotation)
    trans_seg = ((xyz - translation[..., None, :]) @ rot_inv) / torch.clamp(scale, min=1e-12)[..., None, None]
    ext = torch.where(inliers[..., None], trans_seg.abs(), 0.0).amax(dim=-2)    # (..., 3)
    signs = torch.tensor(BOX_SIGNS, dtype=torch.float32, device=xyz.device)
    bbox = ((signs * ext[..., None, :]) * scale[..., None, None]) @ rotation + translation[..., None, :]
    return PoseFit(bbox=bbox, scale=scale, rotation=rotation, translation=translation,
                   inlier_mask=inliers, ok=ok)
