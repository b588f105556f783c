"""Fixed-shape batch structure (counterpart of structures.PointCloudBatch).

Every field keeps an explicit batch dimension and a static capacity with a
validity mask, as in the JAX package.  The inference forward needs only
`points` and `point_mask`; the label fields are optional.
"""

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass
class PointCloudBatch:
    """Shapes (B = batch, N = point capacity, I = instance capacity):

      points:                  (B, N, 6) float32, xyz + rgb
      point_mask:              (B, N)    bool, True for real points
      sem_labels:              (B, N)    int32, -100 = ignore
      instance_labels:         (B, N)    int32, -100 = no instance
      gt_npcs:                 (B, N, 3)
      instance_regions:        (B, N, 9)
      num_points_per_instance: (B, I)    int32
      instance_sem_labels:     (B, I)    int32
      num_instances:           (B,)      int32
    """

    points: torch.Tensor
    point_mask: torch.Tensor
    sem_labels: Optional[torch.Tensor] = None
    instance_labels: Optional[torch.Tensor] = None
    gt_npcs: Optional[torch.Tensor] = None
    instance_regions: Optional[torch.Tensor] = None
    num_points_per_instance: Optional[torch.Tensor] = None
    instance_sem_labels: Optional[torch.Tensor] = None
    num_instances: Optional[torch.Tensor] = None
    pc_ids: Any = None

    @property
    def batch_size(self) -> int:
        return self.points.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[1]

    def to(self, device) -> "PointCloudBatch":
        """A copy with every tensor field moved to `device`."""
        moved = {
            f.name: (
                getattr(self, f.name).to(device)
                if isinstance(getattr(self, f.name), torch.Tensor)
                else getattr(self, f.name)
            )
            for f in dataclasses.fields(self)
        }
        return PointCloudBatch(**moved)

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "PointCloudBatch":
        """Build from a dict of numpy arrays (synthetic_batch's layout)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in arrays.items():
            if k not in fields:
                continue
            kw[k] = v if k == "pc_ids" else torch.as_tensor(v, device=device)
        return cls(**kw)
