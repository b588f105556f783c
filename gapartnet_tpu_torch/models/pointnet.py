"""PointNet segmentation backbone (counterpart of models/pointnet.py).

The model's second `backbone_type`: a spatial transformer on xyz, per-point
MLPs with a 64-d feature transformer, the global max pool concatenated back
onto the point features (1088-d), then a 1088 -> 512 -> 256 -> 256 -> fea
head.  Layout (B, N, C); a 1x1 Conv1d is an nn.Linear over the channel
axis.  BatchNorms over points are masked; the transformers' `fc`
BatchNorms see (B, C) rows with no mask.  The max pool runs over valid
points only (padding at float32's lowest value, as the JAX module), and
the output is zero on invalid points.

Module names follow the flax tree (`feat.stn.conv1`, `feat.fstn.fc3`,
`conv4`, ...), so weights.params_from_jax carries JAX weights across.  A
transformer's `fc3` starts at zero (the JAX module's kernel_init=zeros, see
weights.init_weights), so a fresh model starts from identity transforms.
"""

import torch
from torch import nn

from gapartnet_tpu_torch.models.norm import MaskedBatchNorm
from gapartnet_tpu_torch.utils.profiling import span


def masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B, C), the maximum over the points where `mask`."""
    with span("sync:pointnet_low"):     # the copy to the device waits for it
        low = torch.tensor(torch.finfo(x.dtype).min, dtype=x.dtype, device=x.device)
    return torch.where(mask[..., None], x, low).amax(dim=1)


class STN(nn.Module):
    """Spatial transformer predicting a k x k transform (STN3d / STNkd)."""

    def __init__(self, in_channels: int, k: int):
        super().__init__()
        self.k = k
        widths = (in_channels, 64, 128, 1024)
        for i in range(3):
            setattr(self, f"conv{i + 1}", nn.Linear(widths[i], widths[i + 1]))
            setattr(self, f"bn{i + 1}", MaskedBatchNorm(widths[i + 1]))
        self.fc1 = nn.Linear(1024, 512)
        self.bn4 = MaskedBatchNorm(512)
        self.fc2 = nn.Linear(512, 256)
        self.bn5 = MaskedBatchNorm(256)
        self.fc3 = nn.Linear(256, k * k)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"conv{i + 1}")(x)
            x = torch.relu(getattr(self, f"bn{i + 1}")(x, mask))
        g = masked_max(x, mask)                                    # (B, 1024)
        g = torch.relu(self.bn4(self.fc1(g)))
        g = torch.relu(self.bn5(self.fc2(g)))
        g = self.fc3(g)
        iden = torch.eye(self.k, dtype=x.dtype, device=x.device).reshape(-1)
        return (g + iden).reshape(-1, self.k, self.k)


class PointNetEncoder(nn.Module):
    """(B, N, D) points -> (B, N, 1088): the global feature, then the
    64-d point feature after the feature transform."""

    def __init__(self, in_channels: int = 6):
        super().__init__()
        self.stn = STN(in_channels, 3)
        self.conv1 = nn.Linear(in_channels, 64)
        self.bn1 = MaskedBatchNorm(64)
        self.fstn = STN(64, 64)
        self.conv2 = nn.Linear(64, 128)
        self.bn2 = MaskedBatchNorm(128)
        self.conv3 = nn.Linear(128, 1024)
        self.bn3 = MaskedBatchNorm(1024)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        trans = self.stn(x, mask)
        xyz = torch.bmm(x[..., :3], trans)
        x = torch.cat([xyz, x[..., 3:]], dim=-1) if d > 3 else xyz
        x = torch.relu(self.bn1(self.conv1(x), mask))
        point_feat = torch.bmm(x, self.fstn(x, mask))
        x = torch.relu(self.bn2(self.conv2(point_feat), mask))
        x = self.bn3(self.conv3(x), mask)
        g = masked_max(x, mask)                                    # (B, 1024)
        return torch.cat([g[:, None, :].expand(b, n, g.shape[-1]), point_feat], dim=-1)


class PointNetSegBackbone(nn.Module):
    """Per-point features (B, N, fea_dim), zero on invalid points."""

    def __init__(self, fea_dim: int, in_channels: int = 6):
        super().__init__()
        self.feat = PointNetEncoder(in_channels)
        widths = (1088, 512, 256, 256)
        for i in range(3):
            setattr(self, f"conv{i + 1}", nn.Linear(widths[i], widths[i + 1]))
            setattr(self, f"bn{i + 1}", MaskedBatchNorm(widths[i + 1]))
        self.conv4 = nn.Linear(256, fea_dim)

    def forward(self, points: torch.Tensor, point_mask: torch.Tensor) -> torch.Tensor:
        x = self.feat(points, point_mask)
        for i in range(3):
            x = torch.relu(getattr(self, f"bn{i + 1}")(getattr(self, f"conv{i + 1}")(x), point_mask))
        x = self.conv4(x)
        return torch.where(point_mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
