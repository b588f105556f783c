"""Plain PyTorch geometry and arithmetic of the reference model.

A frozen copy of the measured program's plain semantics, kept with the
benchmark so that no later change to the program moves its yardstick.  It
imports nothing of the program.  Where the program has a fixed capacity
(voxel levels, hash-CCL tables, propagation iterations), the reference has
none: it sizes every table from the data it is given (one host read per
table), so a capacity that clips real data in the program shows here as a
difference and not as a shared truncation.

  * voxels: 1 cm cells over each cloud's own bounding box, packed int32
    keys (10 bits an axis, x major), sorted, features mean-reduced;
  * submanifold conv (k = 3): a (27, V) neighbour table, then a gather and
    one matmul; its backward is the conv of the output gradient with the
    tap-reversed, transposed weights, and the wgrad the gather contracted
    with the output gradient;
  * strided conv (k = 2, s = 2): each voxel has one parent and one kernel
    position; its inverse is the transpose of the stored pairs;
  * hash-grid clustering: (cell, label) nodes with cells of radius / sqrt 3,
    the first 8 member points of each node as its representatives, an edge
    between same-label nodes in the 5^3 neighbourhood when a pair of
    representatives lies within the radius, and connected components by
    min-label propagation run to its fixpoint.
"""

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

COORD_BITS = 10
COORD_MAX = 1 << COORD_BITS
KEY_SENTINEL = int(np.iinfo(np.int32).max)
K_TAPS = 27


def div_const(x: torch.Tensor, c) -> torch.Tensor:
    """x / c as a product with c's float32 reciprocal (the integer cells
    of the model floor such quotients)."""
    inv = np.float32(1.0) / np.asarray(c, np.float32)
    return x * torch.as_tensor(inv, dtype=x.dtype, device=x.device)


def pack_coords(coords: torch.Tensor) -> torch.Tensor:
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    return (x << (2 * COORD_BITS)) | (y << COORD_BITS) | z


def unpack_key(key: torch.Tensor) -> torch.Tensor:
    m = COORD_MAX - 1
    return torch.stack([(key >> (2 * COORD_BITS)) & m, (key >> COORD_BITS) & m, key & m], dim=-1)


def run_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    return first & (sorted_keys != KEY_SENTINEL)


def dedup_keys(keys: torch.Tensor, valid: torch.Tensor):
    """(unique keys ascending, sentinel padded (M,), id per entry (-1
    invalid), number unique)."""
    m = keys.shape[0]
    keys = torch.where(valid, keys, torch.full_like(keys, KEY_SENTINEL))
    sorted_keys, order = torch.sort(keys, stable=True)
    first = run_starts(sorted_keys)
    uid = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    ids = torch.empty_like(keys)
    ids[order] = torch.where(sorted_keys != KEY_SENTINEL, uid, torch.full_like(uid, -1))
    uniq = torch.full((m + 1,), KEY_SENTINEL, dtype=torch.int32, device=keys.device)
    uniq[torch.where(first, uid, torch.full_like(uid, m)).long()] = sorted_keys
    return uniq[:m], ids, first.sum().to(torch.int32)


# ----------------------------------------------------------------- segments

def _dump_ids(ids, n, mask):
    ids = ids.long()
    ok = (ids >= 0) & (ids < n)
    if mask is not None:
        ok = ok & mask
    return torch.where(ok, ids, torch.full_like(ids, n))


def segment_sum(values, ids, n: int, mask=None):
    out = values.new_zeros((n + 1,) + tuple(values.shape[1:]))
    out.index_add_(0, _dump_ids(ids, n, mask), values)
    return out[:n]


def segment_count(ids, n: int, mask=None):
    return segment_sum(torch.ones(ids.shape[:1], dtype=torch.int32, device=ids.device), ids, n, mask)


def segment_mean(values, ids, n: int, mask=None):
    total = segment_sum(values, ids, n, mask)
    cnt = torch.clamp(segment_count(ids, n, mask), min=1).to(values.dtype)
    return total / cnt.reshape(cnt.shape + (1,) * (values.ndim - 1))


def _segment_extreme(values, ids, n, mask, reduce):
    if values.dtype.is_floating_point:
        ident = float("inf") if reduce == "amin" else float("-inf")
    else:
        info = torch.iinfo(values.dtype)
        ident = info.max if reduce == "amin" else info.min
    out = torch.full((n + 1,) + tuple(values.shape[1:]), ident, dtype=values.dtype,
                     device=values.device)
    idx = _dump_ids(ids, n, mask).reshape((-1,) + (1,) * (values.ndim - 1)).expand_as(values)
    out.scatter_reduce_(0, idx, values, reduce=reduce, include_self=True)
    return out[:n]


def segment_min(values, ids, n: int, mask=None):
    return _segment_extreme(values, ids, n, mask, "amin")


def segment_max(values, ids, n: int, mask=None):
    return _segment_extreme(values, ids, n, mask, "amax")


# ------------------------------------------------------------ voxel grids

def voxelize(points: torch.Tensor, voxel_size) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One cloud (N, 6): (keys (N,) ascending, sentinel padded, features
    (N, 6) mean per voxel, voxel id per point)."""
    xyz = points[:, :3]
    rmin = xyz.amin(dim=0) - 1e-4
    coords = torch.floor(div_const(xyz - rmin, voxel_size)).to(torch.int32)
    valid = ((coords >= 0) & (coords < COORD_MAX)).all(dim=-1)
    keys = torch.where(valid, pack_coords(coords.clamp(0, COORD_MAX - 1)),
                       torch.full_like(coords[:, 0], KEY_SENTINEL))
    uniq, ids, _ = dedup_keys(keys, valid)
    feats = segment_mean(points, ids, points.shape[0], mask=valid)
    return uniq, feats, ids


def voxelize_batch(points: torch.Tensor, mask: torch.Tensor, voxel_size):
    """Every cloud of (B, N, 6) voxelized: (keys (B, N), features (B, N, 6),
    voxel id per point (B, N), -1 for invalid points)."""
    b, n, _ = points.shape
    keys = torch.full((b, n), KEY_SENTINEL, dtype=torch.int32, device=points.device)
    feats = points.new_zeros(points.shape)
    pvid = torch.full((b, n), -1, dtype=torch.int32, device=points.device)
    for i in range(b):
        k, f, ids = voxelize(points[i][mask[i]], voxel_size)
        keys[i, :k.shape[0]] = k
        feats[i, :f.shape[0]] = f
        pvid[i, mask[i]] = ids
    return keys, feats, pvid


def kernel_offsets(k: int) -> List[tuple]:
    r = (-1, 0, 1) if k == 3 else (0, 1)
    return [(dx, dy, dz) for dx in r for dy in r for dz in r]


def subm_rulebook(keys: torch.Tensor) -> torch.Tensor:
    """keys (B, V) sorted -> nbr (B, 27, V) int32, -1 where absent."""
    b, v = keys.shape
    coords = unpack_key(keys)
    valid = keys != KEY_SENTINEL
    offs = torch.tensor(kernel_offsets(3), dtype=torch.int32, device=keys.device)
    tgt = coords[:, None, :, :] + offs[None, :, None, :]
    ok = ((tgt >= 0) & (tgt < COORD_MAX)).all(dim=-1) & valid[:, None, :]
    tk = torch.where(ok, pack_coords(tgt), torch.full_like(tgt[..., 0], KEY_SENTINEL - 1))
    idx = torch.searchsorted(keys, tk.reshape(b, -1)).clamp_(0, v - 1)
    found = (torch.gather(keys, 1, idx) == tk.reshape(b, -1)) & ok.reshape(b, -1)
    return torch.where(found, idx.to(torch.int32), torch.full_like(idx, -1, dtype=torch.int32)
                       ).reshape(b, 27, v)


class Down(NamedTuple):
    child_parent: torch.Tensor  # (B, V_in) parent index, -1 invalid
    child_pos: torch.Tensor     # (B, V_in) kernel position in [0, 8)


class Level(NamedTuple):
    keys: torch.Tensor          # (B, V)
    nbr: torch.Tensor           # (B, 27, V)
    mask: torch.Tensor          # (B, V) bool


def downsample(keys: torch.Tensor) -> Tuple[torch.Tensor, Down]:
    """Stride-2 parents of a level, sized to the largest parent count of
    the batch: (parent keys (B, V_out), Down)."""
    b, v = keys.shape
    valid = keys != KEY_SENTINEL
    coords = unpack_key(keys)
    pos = ((coords[..., 0] & 1) << 2) | ((coords[..., 1] & 1) << 1) | (coords[..., 2] & 1)
    pk = torch.where(valid, pack_coords(coords >> 1), torch.full_like(keys, KEY_SENTINEL))
    spk, order = torch.sort(pk, dim=1, stable=True)
    first = run_starts(spk)
    rank = torch.cumsum(first.to(torch.int32), 1, dtype=torch.int32) - 1
    cap = max(int(first.sum(1).max()), 1)
    out = torch.full((b, cap + 1), KEY_SENTINEL, dtype=torch.int32, device=keys.device)
    out.scatter_(1, torch.where(first, rank, torch.full_like(rank, cap)).long(), spk)
    parent_sorted = torch.where(spk != KEY_SENTINEL, rank, torch.full_like(rank, -1))
    child_parent = torch.empty_like(keys)
    child_parent.scatter_(1, order, parent_sorted)
    return out[:, :cap].contiguous(), Down(child_parent, pos.to(torch.int32))


def hierarchy(keys: torch.Tensor, num_levels: int) -> Tuple[List[Level], List[Down]]:
    """Rulebooks of every level and the stride-2 maps between them."""
    levels, downs = [], []
    for li in range(num_levels):
        levels.append(Level(keys, subm_rulebook(keys), keys != KEY_SENTINEL))
        if li + 1 < num_levels:
            keys, d = downsample(keys)
            downs.append(d)
    return levels, downs


def down_conv(x: torch.Tensor, d: Down, w: torch.Tensor, v_out: int) -> torch.Tensor:
    b, v, _ = x.shape
    cout = w.shape[-1]
    proj = torch.einsum("bvc,pcd->bvpd", x, w)
    contrib = torch.gather(proj, 2, d.child_pos.long()[:, :, None, None].expand(b, v, 1, cout))[:, :, 0]
    ok = d.child_parent >= 0
    tgt = torch.where(ok, d.child_parent, torch.full_like(d.child_parent, v_out)).long()
    out = x.new_zeros((b, v_out + 1, cout))
    out.scatter_add_(1, tgt[:, :, None].expand(b, v, cout),
                     torch.where(ok[..., None], contrib, torch.zeros((), device=x.device)))
    return out[:, :v_out]


def up_conv(x: torch.Tensor, d: Down, w: torch.Tensor) -> torch.Tensor:
    b, v = d.child_parent.shape
    cout = w.shape[-1]
    ok = d.child_parent >= 0
    g = torch.gather(x, 1, d.child_parent.clamp(min=0).long()[:, :, None].expand(b, v, x.shape[-1]))
    proj = torch.einsum("bvc,pcd->bvpd", g, w)
    out = torch.gather(proj, 2, d.child_pos.long()[:, :, None, None].expand(b, v, 1, cout))[:, :, 0]
    return torch.where(ok[..., None], out, torch.zeros((), device=x.device))


def gather_taps(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """(B, V, C) at nbr (B, 27, V) -> (B, V, 27 C), zeros where -1."""
    b, v, c = x.shape
    bidx = torch.arange(b, device=x.device)[:, None, None]
    g = x[bidx, nbr.clamp(min=0).long()]
    g = torch.where((nbr >= 0)[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))
    return g.permute(0, 2, 1, 3).reshape(b, v, K_TAPS * c)


def _conv(x, nbr, w):
    k, cin, cout = w.shape
    return torch.matmul(gather_taps(x, nbr), w.reshape(k * cin, cout))


class _Subm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, nbr, w):
        ctx.save_for_backward(x, nbr, w)
        return _conv(x, nbr, w)

    @staticmethod
    def backward(ctx, g):
        x, nbr, w = ctx.saved_tensors
        dx = _conv(g, nbr, w.flip(0).transpose(1, 2)) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[2]:
            dw = torch.einsum("bvk,bvd->kd", gather_taps(x, nbr), g).reshape(w.shape)
        return dx, None, dw


def subm_conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[b, v] = sum_k W[k]^T x[b, nbr[b, k, v]]."""
    return _Subm.apply(x, nbr, w)


# --------------------------------------------------------- hash clustering

CELL_BITS = 7
LABEL_BITS = 4
SET_STRIDE = 131
CELL_X_EXTENT = SET_STRIDE + (1 << CELL_BITS)
REPS = 8
HALF_OFFSETS = [(dx, dy, dz) for dx in range(-2, 3) for dy in range(-2, 3) for dz in range(-2, 3)
                if (dx, dy, dz) > (0, 0, 0)]


def _pack_node(cell, label):
    c = 1 << CELL_BITS
    return (((cell[..., 0] * c + cell[..., 1]) * c + cell[..., 2]) << LABEL_BITS) | label


def _components(edges_src: torch.Tensor, edges_dst: torch.Tensor, m: int) -> torch.Tensor:
    """Minimum node id of each node's connected component, by min-label
    propagation over both edge directions until nothing changes."""
    lab = torch.arange(m, dtype=torch.int64, device=edges_src.device)
    src = torch.cat([edges_src, edges_dst])
    dst = torch.cat([edges_dst, edges_src])
    while True:
        new = lab.clone()
        new.scatter_reduce_(0, dst, lab[src], reduce="amin", include_self=True)
        new = new[new]
        if torch.equal(new, lab):
            return lab
        lab = new


def hash_components(xyz: torch.Tensor, sem: torch.Tensor, valid: torch.Tensor, radius: float,
                    set_mask: torch.Tensor) -> torch.Tensor:
    """Labels (N,) int32: the minimum point index of each point's component,
    points outside any node labelling themselves."""
    dev = xyz.device
    n = xyz.shape[0]
    i32 = torch.int32
    r2 = torch.tensor(np.float32(radius * radius), device=dev)
    s = radius / (3.0 ** 0.5)
    ar = torch.arange(n, dtype=i32, device=dev)
    big = torch.tensor(1e9, dtype=xyz.dtype, device=dev)
    mn = torch.where(valid[:, None], xyz, big).amin(dim=0) - s
    cell = torch.floor(div_const(xyz - mn, s)).to(i32)
    ok = (valid & ((cell >= 0) & (cell < (1 << CELL_BITS))).all(dim=-1)
          & (sem >= 0) & (sem < (1 << LABEL_BITS)))
    cell = cell.clone()
    cell[:, 0] += torch.where(set_mask, SET_STRIDE, 0).to(i32)
    keys = torch.where(ok, _pack_node(cell, sem.to(i32)), torch.full_like(ar, KEY_SENTINEL))
    sk, order = torch.sort(keys, stable=True)
    first = run_starts(sk)
    node_sorted = torch.cumsum(first.to(i32), 0, dtype=i32) - 1
    m = max(int(first.sum()), 1)
    point_node = torch.empty_like(ar)
    point_node[order] = torch.where(sk != KEY_SENTINEL, node_sorted, torch.full_like(ar, -1))
    slot = torch.where(first, node_sorted, torch.full_like(ar, m)).long()
    node_keys = torch.full((m + 1,), KEY_SENTINEL, dtype=i32, device=dev)
    node_keys[slot] = sk
    node_keys = node_keys[:m]
    start = torch.zeros((m + 1,), dtype=i32, device=dev)
    start[slot] = ar
    rank = ar - start[:m][node_sorted.clamp(0, m - 1).long()]
    rows = torch.where((sk != KEY_SENTINEL) & (rank < REPS), node_sorted, torch.full_like(ar, m)).long()
    reps = torch.full((m + 1, REPS), -1, dtype=i32, device=dev)
    reps[rows, rank.clamp(0, REPS - 1).long()] = order.to(i32)
    reps = reps[:m]
    rep_ok = reps >= 0
    rep_xyz = xyz[reps.clamp(min=0).long()]

    c = 1 << CELL_BITS
    ck = node_keys >> LABEL_BITS
    ncell = torch.stack([ck // (c * c), (ck // c) % c, ck % c], dim=-1)
    nlab = node_keys & ((1 << LABEL_BITS) - 1)
    offs = torch.tensor(HALF_OFFSETS, dtype=i32, device=dev)
    tgt = ncell[None] + offs[:, None]
    bound = torch.tensor([CELL_X_EXTENT, c, c], dtype=i32, device=dev)
    tin = ((tgt >= 0) & (tgt < bound)).all(dim=-1)
    tk = torch.where(tin, _pack_node(tgt, nlab[None]), torch.full_like(tgt[..., 0], KEY_SENTINEL - 1))
    vid = torch.searchsorted(node_keys, tk.reshape(-1)).clamp_(0, m - 1).reshape(tk.shape)
    found = (node_keys[vid] == tk) & tin                                  # (62, M)
    src_all, dst_all = [], []
    for o in range(len(HALF_OFFSETS)):
        a = torch.nonzero(found[o])[:, 0]
        if a.numel() == 0:
            continue
        bnode = vid[o, a]
        d = rep_xyz[a][:, :, None, :] - rep_xyz[bnode][:, None, :, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        pair = rep_ok[a][:, :, None] & rep_ok[bnode][:, None, :] & (d2 <= r2)
        hit = pair.any(dim=2).any(dim=1)
        src_all.append(a[hit])
        dst_all.append(bnode[hit])
    src = torch.cat(src_all) if src_all else torch.zeros(0, dtype=torch.int64, device=dev)
    dst = torch.cat(dst_all) if dst_all else torch.zeros(0, dtype=torch.int64, device=dev)
    root = _components(src.long(), dst.long(), m)
    has = ok & (point_node >= 0)
    proot = torch.where(has, root[point_node.clamp(min=0).long()], torch.full_like(root[:1], -1).expand(n))
    minp = torch.full((m + 1,), n, dtype=torch.int64, device=dev)
    minp.scatter_reduce_(0, torch.where(has, proot, torch.full_like(proot, m)), ar.long(),
                         reduce="amin", include_self=True)
    return torch.where(has, minp[proot.clamp(min=0)].to(i32), ar)
