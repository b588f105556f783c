"""PointNet++ point operations (counterpart of ops/pointnet2.py).

Channel-last (..., N, C) layouts, as in the JAX package.  Furthest point
sampling is ops/fps.py.  `knn` is jitted in the JAX package, so its
squared distances are XLA's fused-multiply-add chain (ops/ball_query.
fma_sq_dist); `ball_query_simple` runs eagerly there, so its squares and
sums are each rounded on their own.  Equal distances order by index, the
lower first, as `lax.top_k` returns them.
"""

import numpy as np
import torch

from gapartnet_tpu_torch.ops.ball_query import fma_sq_dist


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[..., m, :] = points[..., idx[..., m], :]."""
    idx = idx.long()[..., None].expand(idx.shape + points.shape[-1:])
    return torch.gather(points, -2, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, C) points, (M, S) indices -> (M, S, C) neighbourhoods."""
    return points[idx.long()]


def knn(query: torch.Tensor, points: torch.Tensor, k: int):
    """Brute-force k nearest neighbours, ascending by distance, ties by
    index.  query (M, 3), points (N, 3) -> (dists (M, k), idx (M, k) int32)."""
    d2 = fma_sq_dist(query.to(torch.float32), points.to(torch.float32))
    d2, idx = torch.sort(d2, dim=1, stable=True)
    return torch.sqrt(torch.clamp(d2[:, :k], min=0.0)), idx[:, :k].to(torch.int32)


def three_nn(query: torch.Tensor, points: torch.Tensor):
    """The three nearest neighbours: (dists (M, 3), idx (M, 3))."""
    return knn(query, points, 3)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """features (N, C), idx (M, 3), weight (M, 3) -> (M, C): the weighted
    sum of each query's three neighbours' features."""
    return (features[idx.long()] * weight[..., None]).sum(dim=1)


def interpolation_weights(dists: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights, normalized over the last axis."""
    recip = 1.0 / (dists + eps)
    return recip / recip.sum(dim=-1, keepdim=True)


def ball_query_simple(query: torch.Tensor, points: torch.Tensor, radius: float,
                      nsample: int) -> torch.Tensor:
    """Unlabelled first-K ball query with first-hit padding: each query's
    first `nsample` points within `radius` in index order, empty slots
    repeating the first hit, and 0 where there is none.  (M, 3), (N, 3)
    -> (M, nsample) int32."""
    n = points.shape[0]
    d = query[:, None, :] - points[None, :, :]
    d2 = (d * d).sum(dim=-1)
    ok = d2 <= torch.tensor(np.float32(radius * radius), device=d2.device)
    scores = torch.where(ok, torch.arange(n, device=d2.device), n)
    if n < nsample:
        scores = torch.cat([scores, scores.new_full((scores.shape[0], nsample - n), n)], dim=1)
    idx = torch.sort(scores, dim=1).values[:, :nsample]
    idx = torch.where(idx >= n, idx[:, :1], idx)
    return torch.where(idx >= n, 0, idx).to(torch.int32)
