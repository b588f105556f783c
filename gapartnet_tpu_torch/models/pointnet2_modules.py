"""PointNet++ set-abstraction and feature-propagation modules (counterpart
of models/pointnet2_modules.py).

No model of the package uses them; they are here for the library's
completeness.  Channel-last (B, N, C).  Unlike flax, torch layers need
their input width, so each module takes `in_channels`: the features'
channels for SetAbstraction (the centred xyz adds 3), the interpolated
plus skip channels for FeaturePropagation.  Names follow the flax tree
(`mlp.conv0`, `mlp.bn0`, ...).
"""

from typing import Optional, Sequence

import torch
from torch import nn

from gapartnet_tpu_torch.models.norm import MaskedBatchNorm
from gapartnet_tpu_torch.ops.fps import furthest_point_sampling_single
from gapartnet_tpu_torch.ops.pointnet2 import (
    ball_query_simple,
    gather_points,
    interpolation_weights,
    three_interpolate,
    three_nn,
)


class SharedMLP(nn.Module):
    """Per-point Linear (no bias) + BatchNorm (no mask) + ReLU layers."""

    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        self.depth = len(channels)
        for i, c in enumerate(channels):
            setattr(self, f"conv{i}", nn.Linear(in_channels, c, bias=False))
            setattr(self, f"bn{i}", MaskedBatchNorm(c))
            in_channels = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


class SetAbstraction(nn.Module):
    """FPS centroids -> ball-query groups (centred xyz, then features) ->
    shared MLP -> max over each group."""

    def __init__(self, npoint: int, radius: float, nsample: int, mlp: Sequence[int],
                 in_channels: int = 0):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp = SharedMLP(3 + in_channels, mlp)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None):
        idx = torch.stack([furthest_point_sampling_single(x, self.npoint) for x in xyz])
        new_xyz = gather_points(xyz, idx)                          # (B, npoint, 3)
        groups = []
        for bi in range(xyz.shape[0]):
            gi = ball_query_simple(new_xyz[bi], xyz[bi], self.radius, self.nsample).long()
            g = xyz[bi][gi] - new_xyz[bi][:, None, :]              # centred neighbourhoods
            if features is not None:
                g = torch.cat([g, features[bi][gi]], dim=-1)
            groups.append(g)
        out = self.mlp(torch.stack(groups))                        # (B, npoint, nsample, C)
        return new_xyz, out.amax(dim=2)


class FeaturePropagation(nn.Module):
    """Inverse-distance 3-NN interpolation of the coarse features onto the
    fine points, the fine points' own features appended, a shared MLP."""

    def __init__(self, mlp: Sequence[int], in_channels: int):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp)

    def forward(self, xyz_to, xyz_from, feats_to, feats_from):
        rows = []
        for qt, pf, ff in zip(xyz_to, xyz_from, feats_from):
            d, i = three_nn(qt, pf)
            rows.append(three_interpolate(ff, i, interpolation_weights(d)))
        x = torch.stack(rows)
        if feats_to is not None:
            x = torch.cat([x, feats_to], dim=-1)
        return self.mlp(x)
