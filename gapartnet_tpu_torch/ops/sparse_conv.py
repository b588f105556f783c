"""Rulebook sparse 3D convolution geometry and the non-kernel convs.

Counterpart of ops/sparse_conv.py.  A sparse grid is a per-sample sorted
array of packed int32 voxel keys (ops/voxelize.pack_coords) with
KEY_SENTINEL padding.  All geometry is built once per grid:

  * submanifold conv (k=3): a (27, V) neighbour table, -1 where absent;
    the conv itself is the CUDA kernel in ops/subm_conv.py;
  * strided conv (k=2, s=2): each voxel has one parent (coord >> 1) and one
    kernel position (coord & 1); conv = per-position matmul + scatter-add;
  * inverse conv (k=2): the transpose of the stored strided pairs.

Functions here take a leading batch dimension (the JAX package vmaps its
single-sample functions over it).  The strided, inverse and pointwise convs
are plain torch, as the JAX package leaves them to XLA.
"""

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from gapartnet_tpu_torch.ops.voxelize import (
    COORD_MAX,
    KEY_SENTINEL,
    _run_starts,
    pack_coords,
    unpack_key,
)
from gapartnet_tpu_torch.utils.profiling import span


def kernel_offsets(kernel_size: int) -> List[tuple]:
    """Kernel offsets, x-major (dx slowest, dz fastest), matching the key
    packing order.  k=3: [-1, 0, 1]; k=2 (stride 2): [0, 1]."""
    if kernel_size == 3:
        r = (-1, 0, 1)
    elif kernel_size == 2:
        r = (0, 1)
    else:
        raise NotImplementedError(kernel_size)
    return [(dx, dy, dz) for dx in r for dy in r for dz in r]


def build_subm_rulebook(
    keys: torch.Tensor, extent: Optional[Sequence[int]] = None
) -> torch.Tensor:
    """Neighbour table for the 3x3x3 submanifold conv.

    keys: (B, V) sorted packed keys, KEY_SENTINEL padded.
    Returns nbr (B, 27, V) int32: index of each voxel's neighbour at each
    kernel offset, or -1 when absent.

    extent: optional (ex, ey, ez) coordinate bound, with the JAX dense-table
    semantics: a neighbour whose coordinates lie outside the extent is
    reported absent.  The lookup itself is a searchsorted over the keys;
    keys are unique, so the table is identical to the JAX dense-table one.
    """
    b, v = keys.shape
    dev = keys.device
    coords = unpack_key(keys)                                   # (B, V, 3)
    valid = keys != KEY_SENTINEL
    with span("sync:rulebook_constant"):
        offs = torch.tensor(kernel_offsets(3), dtype=torch.int32, device=dev)
    tgt = coords[:, None, :, :] + offs[None, :, None, :]        # (B, 27, V, 3)
    ok = ((tgt >= 0) & (tgt < COORD_MAX)).all(dim=-1) & valid[:, None, :]
    if extent is not None:
        with span("sync:rulebook_constant"):
            ext = torch.tensor(tuple(extent), dtype=torch.int32, device=dev)
        ok = ok & (tgt < ext).all(dim=-1)
    tgt_key = torch.where(ok, pack_coords(tgt), torch.full_like(tgt[..., 0], KEY_SENTINEL - 1))
    idx = torch.searchsorted(keys, tgt_key.reshape(b, -1)).clamp_(0, v - 1)
    found = (torch.gather(keys, 1, idx) == tgt_key.reshape(b, -1)) & ok.reshape(b, -1)
    nbr = torch.where(found, idx.to(torch.int32), torch.full_like(idx, -1, dtype=torch.int32))
    return nbr.reshape(b, 27, v)


class DownsampleMap(NamedTuple):
    """Geometry of one stride-2 downsample (leading B on every field)."""

    out_keys: torch.Tensor        # (B, V_out) sorted keys of the coarse grid
    out_num_voxels: torch.Tensor  # (B,) int32
    child_parent: torch.Tensor    # (B, V_in) index into coarse grid, -1 invalid
    child_pos: torch.Tensor       # (B, V_in) kernel position in [0, 8)
    num_dropped: torch.Tensor     # (B,) int32 voxels lost to capacity overflow


def build_downsample(keys: torch.Tensor, out_capacity: int) -> DownsampleMap:
    """Stride-2 kernel-2 downsample geometry.  keys (B, V_in).

    The sort is required even though `keys` arrive sorted: `>> 1` per axis
    does not keep x-major lexicographic order."""
    b, v = keys.shape
    dev = keys.device
    valid = keys != KEY_SENTINEL
    coords = unpack_key(keys)
    parent_coords = coords >> 1
    pos = ((coords[..., 0] & 1) << 2) | ((coords[..., 1] & 1) << 1) | (coords[..., 2] & 1)
    parent_key = torch.where(valid, pack_coords(parent_coords), torch.full_like(keys, KEY_SENTINEL))

    sorted_pk, order = torch.sort(parent_key, dim=1, stable=True)
    first = _run_starts(sorted_pk)
    rank = torch.cumsum(first.to(torch.int32), 1, dtype=torch.int32) - 1
    num_unique = first.sum(1).to(torch.int32)
    num_out = torch.clamp(num_unique, max=out_capacity)
    num_dropped = num_unique - num_out

    keep = first & (rank < out_capacity)
    out_keys = torch.full((b, out_capacity + 1), KEY_SENTINEL, dtype=torch.int32, device=dev)
    out_keys.scatter_(
        1, torch.where(keep, rank, torch.full_like(rank, out_capacity)).long(), sorted_pk
    )
    parent_rank_sorted = torch.where(
        (sorted_pk != KEY_SENTINEL) & (rank < out_capacity), rank, torch.full_like(rank, -1)
    )
    child_parent = torch.empty_like(keys)
    child_parent.scatter_(1, order, parent_rank_sorted)
    return DownsampleMap(
        out_keys=out_keys[:, :out_capacity].contiguous(),
        out_num_voxels=num_out,
        child_parent=child_parent,
        child_pos=pos.to(torch.int32),
        num_dropped=num_dropped,
    )


def linear_conv_apply(features: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """k=1 submanifold conv == pointwise linear (ResBlock shortcut)."""
    return torch.matmul(features, weights)


def downsample_conv_apply(
    features: torch.Tensor,   # (B, V_in, Cin)
    ds: DownsampleMap,
    weights: torch.Tensor,    # (8, Cin, Cout)
    out_capacity: int,
) -> torch.Tensor:
    """Strided conv: per-position matmuls + scatter-add into parents."""
    b, v, _ = features.shape
    cout = weights.shape[-1]
    proj = torch.einsum("bvc,pcd->bvpd", features, weights)       # (B, V_in, 8, Cout)
    idx = ds.child_pos.long()[:, :, None, None].expand(b, v, 1, cout)
    contrib = torch.gather(proj, 2, idx).squeeze(2)                # (B, V_in, Cout)
    ok = ds.child_parent >= 0
    tgt = torch.where(ok, ds.child_parent, torch.full_like(ds.child_parent, out_capacity))
    out = features.new_zeros((b, out_capacity + 1, cout))
    out.scatter_add_(
        1, tgt.long()[:, :, None].expand(b, v, cout),
        torch.where(ok[..., None], contrib, torch.zeros((), dtype=contrib.dtype, device=contrib.device)),
    )
    return out[:, :out_capacity]


def inverse_conv_apply(
    coarse_features: torch.Tensor,  # (B, V_out, Cin)
    ds: DownsampleMap,
    weights: torch.Tensor,          # (8, Cin, Cout)
) -> torch.Tensor:
    """Inverse (transposed) conv back onto the stored finer grid."""
    b, v = ds.child_parent.shape
    cin = coarse_features.shape[-1]
    cout = weights.shape[-1]
    ok = ds.child_parent >= 0
    par = ds.child_parent.clamp(min=0).long()[:, :, None].expand(b, v, cin)
    gathered = torch.gather(coarse_features, 1, par)
    gathered = torch.where(ok[..., None], gathered, torch.zeros((), dtype=gathered.dtype, device=gathered.device))
    proj = torch.einsum("bvc,pcd->bvpd", gathered, weights)
    idx = ds.child_pos.long()[:, :, None, None].expand(b, v, 1, cout)
    out = torch.gather(proj, 2, idx).squeeze(2)
    return torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))


class GridLevel(NamedTuple):
    keys: torch.Tensor        # (B, V_l)
    num_voxels: torch.Tensor  # (B,)
    subm_nbr: torch.Tensor    # (B, 27, V_l)

    @property
    def voxel_mask(self) -> torch.Tensor:
        v = self.keys.shape[-1]
        return torch.arange(v, device=self.keys.device)[None, :] < self.num_voxels[:, None]


class GridHierarchy(NamedTuple):
    """Per-level submanifold rulebooks plus the stride-2 maps between levels."""

    levels: Tuple[GridLevel, ...]
    downsamples: Tuple[DownsampleMap, ...]


def build_hierarchy(
    keys: torch.Tensor,           # (B, V0) sorted packed keys
    num_voxels: torch.Tensor,     # (B,)
    capacities: Sequence[int],    # per-level voxel capacity
    extent: Optional[Sequence[int]] = None,  # level-0 coordinate bound
) -> GridHierarchy:
    levels = []
    downsamples = []
    cur_keys, cur_nv = keys, num_voxels
    cur_extent = tuple(extent) if extent is not None else None
    for li, cap in enumerate(capacities):
        with span("grid:level"):
            nbr = build_subm_rulebook(cur_keys, extent=cur_extent)
            levels.append(GridLevel(keys=cur_keys, num_voxels=cur_nv, subm_nbr=nbr))
            if li + 1 < len(capacities):
                ds = build_downsample(cur_keys, capacities[li + 1])
                downsamples.append(ds)
                cur_keys, cur_nv = ds.out_keys, ds.out_num_voxels
                if cur_extent is not None:
                    cur_extent = tuple(-(-x // 2) for x in cur_extent)
    return GridHierarchy(levels=tuple(levels), downsamples=tuple(downsamples))
