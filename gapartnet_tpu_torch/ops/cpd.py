"""Rigid Coherent Point Drift registration (counterpart of ops/cpd.py).

The CPD branch of the two-frame joint-angle estimator: a fixed number of EM
iterations (Myronenko & Song, TPAMI 2010, rigid case).  The E-step is one
(M, N) pairwise-distance kernel with a row-softmax-style normalisation, the
M-step a 3x3 SVD.  Row-vector convention as ops/umeyama.py: the moving
cloud `y` is aligned to `x` by T(y) = s * y @ R + t.
"""

import math

import torch


def _estep(x, y_t, sigma2, w, n, m):
    """Responsibilities P (M, N): p(m | x_n) under isotropic Gaussians;
    `w` is the uniform-outlier weight."""
    d2 = (x * x).sum(dim=1)[None, :] - 2.0 * (y_t @ x.T) + (y_t * y_t).sum(dim=1)[:, None]
    # float32 rounding can leave d2 slightly negative at convergence, where
    # sigma2 sits at its floor and exp(+eps / sigma2) overflows: clamp, then
    # shift each column by its minimum (exact: the shift multiplies into the
    # outlier constant)
    d2 = torch.clamp(d2, min=0.0)
    dmin = d2.amin(dim=0, keepdim=True)
    kern = torch.exp(-(d2 - dmin) / (2.0 * sigma2))
    c = (2.0 * math.pi * sigma2) ** 1.5 * (w / max(1.0 - w, 1e-9)) * (m / n)
    c = c * torch.exp(torch.clamp(dmin / (2.0 * sigma2), max=80.0))
    denom = kern.sum(dim=0, keepdim=True) + torch.clamp(c, min=1e-30)
    return kern / denom


def rigid_cpd(x: torch.Tensor, y: torch.Tensor, n_iters: int = 80, w: float = 0.0,
              with_scale: bool = True):
    """Align `y` (M, 3) onto `x` (N, 3); returns (s, R, t, sigma2).

    Fixed-iteration EM: CPD converges geometrically, and 80 iterations are
    far past convergence at the ~500-point samples of the joint-angle path.
    Runs on the inputs' device."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    n, m = x.shape[0], y.shape[0]
    d2_init = (x * x).sum(dim=1)[None, :] - 2.0 * (y @ x.T) + (y * y).sum(dim=1)[:, None]
    sigma2 = d2_init.sum() / (3.0 * n * m)
    s = torch.ones((), device=x.device)
    r = torch.eye(3, device=x.device)
    t = torch.zeros(3, device=x.device)
    for _ in range(n_iters):
        y_t = s * (y @ r) + t
        p = _estep(x, y_t, sigma2, w, n, m)
        np_ = torch.clamp(p.sum(), min=1e-9)
        p1 = p.sum(dim=1)                  # (M,)
        pt1 = p.sum(dim=0)                 # (N,)
        mu_x = (pt1 @ x) / np_
        mu_y = (p1 @ y) / np_
        xh = x - mu_x
        yh = y - mu_y
        a = xh.T @ (p.T @ yh)              # (3, 3) cross-covariance
        u, sv, vt = torch.linalg.svd(a)
        det = torch.linalg.det(u @ vt)
        c = torch.cat([torch.ones(2, device=x.device), det[None]])
        # row-vector convention: y_new = y @ R with R = (U diag(c) Vt)^T
        r_new = (u * c[None, :]) @ vt
        tr_ac = (sv * c).sum()
        yy = (p1 * (yh * yh).sum(dim=1)).sum()
        s = tr_ac / torch.clamp(yy, min=1e-12) if with_scale else torch.ones((), device=x.device)
        xx = (pt1 * (xh * xh).sum(dim=1)).sum()
        sigma2 = torch.clamp((xx - s * tr_ac) / (3.0 * np_), min=1e-8)
        t = mu_x - s * (mu_y @ r_new.T)
        r = r_new.T
    return s, r, t, sigma2
