"""Static model configuration and the constants the port needs.

Counterpart of `GAPartNetConfig` in the JAX package (models/gapartnet.py),
with the same fields and defaults so that the two compare equal field for
field.  The TPU-only fields (`hash_probe_impl`, `rulebook_impl`,
`remat_blocks`) are kept for that comparison only: the port implements one
path for each (sorted-key probing, searchsorted rulebooks, no remat).
"""

import dataclasses
from typing import Optional, Tuple

from gapartnet_tpu_torch.constants import SYMMETRY_INDICES

NUM_PART_CLASSES = 10


@dataclasses.dataclass(frozen=True)
class GAPartNetConfig:
    """Mirrors gapartnet.yaml model.init_args plus the fixed capacities."""

    in_channels: int = 6
    num_part_classes: int = NUM_PART_CLASSES
    backbone_type: str = "SparseUNet"
    channels: Tuple[int, ...] = (16, 32, 48, 64, 80, 96, 112)
    block_repeat: int = 2
    # instance_seg_cfg (gapartnet.yaml:20-26)
    ball_query_radius: float = 0.04
    max_num_points_per_query: int = 50
    min_num_points_per_proposal: int = 5
    max_num_points_per_query_shift: int = 300
    score_fullscale: float = 28.0
    score_scale: float = 50.0
    # semantic losses
    ignore_sem_label: int = -100
    use_sem_focal_loss: bool = True
    sem_focal_alpha: Optional[Tuple[float, ...]] = None
    use_sem_dice_loss: bool = True
    symmetry_indices: Tuple[int, ...] = SYMMETRY_INDICES
    # validation / inference
    val_score_threshold: float = 0.09
    val_min_num_points_per_proposal: int = 3
    val_nms_iou_threshold: float = 0.3
    val_ap_iou_threshold: float = 0.5
    # clustering: the port implements "hash" only
    clustering_impl: str = "hash"
    # (cell, label) node-table capacity PER SET (0 = N); overflow is counted
    # in counters["ccl_node_overflow"]
    hash_node_capacity: int = 2048
    # same-label candidate cap per node (0 = derive from hash_max_degree);
    # overflow is counted in counters["ccl_cand_truncated"]
    hash_cand_cap: int = 0
    # post-distance-check neighbour-table width (same counter)
    hash_max_degree: int = 24
    # TPU-only probe variant selector; the port always probes sorted keys
    hash_probe_impl: str = "auto"
    offset_loss_weight: float = 1.0
    # conv compute precision; the port's kernel computes float32 only
    conv_compute_dtype: str = "float32"
    # TPU-only: rematerialization in backward
    remat_blocks: bool = False
    # TPU-only rulebook lookup selector; the port always uses searchsorted
    # and applies `input_grid_extent` as a bound on neighbour links
    rulebook_impl: str = "dense"
    # proposal UNets: "dense" (conv3d over (G, S^3) grids), "sparse" (the
    # submanifold kernels over the proposal voxels) or "auto" = dense at
    # eval, sparse at train
    proposal_conv_impl: str = "auto"
    # live-grid capacity per cloud for the dense proposal UNets; overflow is
    # counted in counters["dense_grids_dropped"]
    dense_grid_capacity: int = 96
    # level-0 coordinate bound: out-of-extent voxels lose neighbour links
    input_grid_extent: Tuple[int, int, int] = (288, 288, 288)
    voxel_size: Tuple[float, float, float] = (0.01, 0.01, 0.01)
    max_points: int = 20000
    max_proposals: int = 128
    max_instances: int = 64
    level_capacity_divisors: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    level_capacities: Optional[Tuple[int, ...]] = None
    proposal_level_divisors: Tuple[int, ...] = (1, 2)
    # voxel capacity of the sparse (train) proposal grid; overflow is
    # counted in counters["proposal_voxels_dropped"]; 0 = max_points
    proposal_voxel_capacity: int = 8192

    def input_capacities(self) -> Tuple[int, ...]:
        """Per-level voxel capacity of the backbone's sparse grids."""
        if self.level_capacities is not None:
            if len(self.level_capacities) != len(self.level_capacity_divisors):
                raise ValueError(
                    f"level_capacities {self.level_capacities} and "
                    f"level_capacity_divisors {self.level_capacity_divisors} "
                    "differ in length"
                )
            return tuple(
                min(max(int(c), 64), self.max_points)
                for c in self.level_capacities
            )
        return tuple(
            max(self.max_points // d, 64) for d in self.level_capacity_divisors
        )

    def proposal_capacities(self) -> Tuple[int, ...]:
        """Per-level voxel capacity of the sparse proposal grids, clamped to
        the 2N entries (each valid point appears once per clustering set)."""
        v0 = min(self.proposal_voxel_capacity or self.max_points, 2 * self.max_points)
        return tuple(max(v0 // d, 64) for d in self.proposal_level_divisors)


def eval_capacity_config(cfg: GAPartNetConfig) -> GAPartNetConfig:
    """The capacities of an eval forward (train/trainer.py:452).  An eval
    clusters on the sem head's predictions, which no label scan bounds (at
    random weights they mark most points foreground): the hash-CCL node
    cap at max_points, candidate and degree caps of 64 (the 62-offset probe
    width, so neither truncates), twice the proposals, and a dense pool of
    at least the original proposal cap.  (The port clusters by hash-CCL
    only, so the hash caps always apply.)"""
    return dataclasses.replace(
        cfg, hash_node_capacity=cfg.max_points, hash_cand_cap=64, hash_max_degree=64,
        max_proposals=2 * cfg.max_proposals,
        dense_grid_capacity=max(cfg.dense_grid_capacity, cfg.max_proposals))
