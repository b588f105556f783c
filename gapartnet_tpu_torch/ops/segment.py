"""Fixed-shape segment reductions (counterpart of ops/segment.py).

Every op takes a per-element segment id, an optional validity mask and a
static segment count.  Masked or out-of-range ids go to one dump slot past
the end, which is sliced off afterwards: this is the port's form of JAX's
`mode="drop"` scatter, since torch raises on out-of-bounds indices.
Empty segments keep the reduction's identity (0 for sums, +inf / int max
for min, -inf / int min for max), as `jax.ops.segment_*` does.
"""

from typing import Optional

import torch


def dump_ids(
    segment_ids: torch.Tensor, num_segments: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """int64 ids with masked and out-of-range elements sent to `num_segments`."""
    ids = segment_ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    if mask is not None:
        ok = ok & mask
    return torch.where(ok, ids, torch.full_like(ids, num_segments))


def segment_sum(values, segment_ids, num_segments: int, mask=None):
    ids = dump_ids(segment_ids, num_segments, mask)
    out = values.new_zeros((num_segments + 1,) + tuple(values.shape[1:]))
    out.index_add_(0, ids, values)
    return out[:num_segments]


def segment_count(segment_ids, num_segments: int, mask=None):
    ones = torch.ones(segment_ids.shape[:1], dtype=torch.int32, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask=mask)


def segment_mean(values, segment_ids, num_segments: int, mask=None):
    total = segment_sum(values, segment_ids, num_segments, mask=mask)
    count = segment_count(segment_ids, num_segments, mask=mask)
    denom = torch.clamp(count, min=1).to(values.dtype)
    if values.ndim > 1:
        denom = denom.reshape(denom.shape + (1,) * (values.ndim - 1))
    return total / denom


def _identity(dtype, reduce: str):
    if dtype.is_floating_point:
        return float("inf") if reduce == "amin" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if reduce == "amin" else info.min


def _segment_extreme(values, segment_ids, num_segments: int, mask, reduce: str):
    ids = dump_ids(segment_ids, num_segments, mask)
    shape = (num_segments + 1,) + tuple(values.shape[1:])
    out = torch.full(shape, _identity(values.dtype, reduce), dtype=values.dtype,
                     device=values.device)
    idx = ids.reshape((-1,) + (1,) * (values.ndim - 1)).expand_as(values)
    out.scatter_reduce_(0, idx, values, reduce=reduce, include_self=True)
    return out[:num_segments]


def segment_min(values, segment_ids, num_segments: int, mask=None):
    return _segment_extreme(values, segment_ids, num_segments, mask, "amin")


def segment_max(values, segment_ids, num_segments: int, mask=None):
    return _segment_extreme(values, segment_ids, num_segments, mask, "amax")
