"""Fixed-shape point-cloud voxelization (counterpart of ops/voxelize.py).

Voxel coordinates pack into one int32 key (10 bits per axis, x major); keys
are sorted, voxel boundaries found by run-length flags and features
mean-reduced per voxel.  Output voxels are in ascending key order, which the
rulebook lookup (ops/sparse_conv.py) relies on.  Sorts are stable, as JAX's
argsort is.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from gapartnet_tpu_torch.ops.segment import segment_mean
from gapartnet_tpu_torch.utils.profiling import span

COORD_BITS = 10
COORD_MAX = 1 << COORD_BITS  # 1024 per axis
KEY_SENTINEL = int(np.iinfo(np.int32).max)


def div_const(x: torch.Tensor, c) -> torch.Tensor:
    """`x / c` for a constant `c`, computed as the JAX reference computes it.

    Under `jax.jit`, XLA rewrites division by a constant into multiplication
    by the constant's float32 reciprocal, and the model's integer outputs
    (voxel keys, hash cells, proposal cells) take the floor of such
    quotients.  The port multiplies by the same float32 reciprocal, held in
    a tensor on `x`'s device, so that its cells agree with the reference's
    and the card's agree with the CPU's.
    """
    inv = np.float32(1.0) / np.asarray(c, np.float32)
    with span("sync:div_constant"):     # the copy to the device waits for it
        inv = torch.as_tensor(inv, dtype=x.dtype, device=x.device)
    return x * inv


def pack_coords(coords: torch.Tensor) -> torch.Tensor:
    """Pack integer (x, y, z) in [0, 1024) into one int32 key (x major)."""
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    return (x << (2 * COORD_BITS)) | (y << COORD_BITS) | z


def unpack_key(key: torch.Tensor) -> torch.Tensor:
    mask = COORD_MAX - 1
    x = (key >> (2 * COORD_BITS)) & mask
    y = (key >> COORD_BITS) & mask
    z = key & mask
    return torch.stack([x, y, z], dim=-1)


def _run_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """True at the first element of each run of equal valid keys (last dim)."""
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    return first & (sorted_keys != KEY_SENTINEL)


def dedup_keys(keys: torch.Tensor, valid: torch.Tensor):
    """Sort + run-length deduplicate int32 keys (invalid -> KEY_SENTINEL).

    Returns (unique_keys (M,) ascending sentinel-padded,
             id_per_entry (M,) int32 with -1 for invalid,
             num_unique () int32).
    """
    m = keys.shape[0]
    keys = torch.where(valid, keys, torch.full_like(keys, KEY_SENTINEL))
    sorted_keys, order = torch.sort(keys, stable=True)
    first = _run_starts(sorted_keys)
    uid_sorted = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    num_unique = first.sum().to(torch.int32)
    id_per_entry = torch.empty_like(keys)
    id_per_entry[order] = torch.where(
        sorted_keys != KEY_SENTINEL, uid_sorted, torch.full_like(uid_sorted, -1)
    )
    unique_keys = torch.full((m + 1,), KEY_SENTINEL, dtype=torch.int32, device=keys.device)
    unique_keys[torch.where(first, uid_sorted, torch.full_like(uid_sorted, m)).long()] = sorted_keys
    return unique_keys[:m], id_per_entry, num_unique


class VoxelizeResult(NamedTuple):
    voxel_keys: torch.Tensor      # (N,) int32, ascending, KEY_SENTINEL padded
    voxel_features: torch.Tensor  # (N, C) mean-reduced features per voxel
    voxel_mask: torch.Tensor      # (N,) bool
    pc_voxel_id: torch.Tensor     # (N,) int32, -1 for invalid points
    num_voxels: torch.Tensor      # () int32


def voxelize_single(
    pt_xyz: torch.Tensor,
    pt_features: torch.Tensor,
    voxel_size,
    range_min: torch.Tensor,
    range_max: torch.Tensor,
    point_mask: Optional[torch.Tensor] = None,
) -> VoxelizeResult:
    """Voxelize one point cloud with mean feature reduction.

    voxel_size is a constant (3,) tuple; range_min / range_max (3,) tensors
    bound the inclusive spatial range (points outside get pc_voxel_id -1).
    """
    n = pt_xyz.shape[0]
    coords = torch.floor(div_const(pt_xyz - range_min, voxel_size)).to(torch.int32)
    in_range = ((pt_xyz >= range_min) & (pt_xyz <= range_max)).all(dim=-1)
    in_grid = ((coords >= 0) & (coords < COORD_MAX)).all(dim=-1)
    valid = in_range & in_grid
    if point_mask is not None:
        valid = valid & point_mask
    coords = coords.clamp(0, COORD_MAX - 1)

    keys = torch.where(valid, pack_coords(coords), torch.full_like(coords[:, 0], KEY_SENTINEL))
    unique_keys, pc_voxel_id, num_voxels = dedup_keys(keys, valid)
    voxel_features = segment_mean(pt_features, pc_voxel_id, n, mask=valid)
    voxel_mask = torch.arange(n, device=pt_xyz.device) < num_voxels
    return VoxelizeResult(
        voxel_keys=unique_keys,
        voxel_features=voxel_features,
        voxel_mask=voxel_mask,
        pc_voxel_id=pc_voxel_id,
        num_voxels=num_voxels,
    )
