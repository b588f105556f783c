"""The work a step or a request needs, counted from its inputs.

Operations and bytes come from shapes: the voxel grids, rulebooks and
proposal grids that the reference (portbench/reference) works out from the
same inputs, and the layer widths of the configuration.  Nothing here reads
what the program launches, so work the program skips or repeats does not
change the count.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit.  The
model computes in float32 with TF32 off; the fastest fp32-accurate rate on
the tensor cores is three TF32 products per fp32 product (3xTF32), a third
of the TF32 peak, which is the peak of `mfu_pct.*` and of the subm conv
roofline.  (A frozen copy of chip_smoke.py's `_bound` arithmetic.)
"""

from typing import Dict, List, NamedTuple, Sequence, Tuple

PEAK_TF32_FLOPS = 495e12
PEAK_FP32_ACCURATE_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_ACCURATE_FLOPS) -> float:
    """The least time: the larger of the operations at the peak rate and
    the bytes at the HBM rate."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES_PER_S)


def subm_conv_work(cin: int, cout: int, voxels: int, pairs: int) -> Tuple[int, int]:
    """(operations, bytes) of one 3x3x3 submanifold conv over `voxels`
    live voxels with `pairs` existing neighbour pairs: a multiply-add per
    pair and channel pair; the input rows, the output rows, the weights
    and the 27-wide neighbour table each read or written once, in 4-byte
    words.  Its dgrad and wgrad need the same (the roles of the rows
    change, not their number)."""
    return 2 * cin * cout * pairs, 4 * (voxels * (cin + cout) + 27 * cin * cout + 27 * voxels)


class Geometry(NamedTuple):
    """Per grid level, summed over the batch: live voxels and existing
    submanifold neighbour pairs."""

    voxels: Sequence[int]
    pairs: Sequence[int]


class Layer(NamedTuple):
    kind: str       # "subm", "point" (a matmul per row) or "stride" (one tap per fine voxel)
    level: int
    cin: int
    cout: int
    dgrad: bool     # whether the layer's input needs a gradient


def unet_layers(channels: Sequence[int], repeat: int, stem_in) -> List[Layer]:
    """The matmul layers of a SparseUNet: the stem conv (none for the
    proposal UNets), per level `repeat` encoder blocks of two convs, the
    stride-2 down and inverse up convs, and the decoder: a block on the
    concatenation (with its pointwise shortcut) and `repeat` - 1 more."""
    out = [] if stem_in is None else [Layer("subm", 0, stem_in, channels[0], False)]
    last = len(channels) - 1
    for li, c in enumerate(channels):
        out += [Layer("subm", li, c, c, True)] * (2 * repeat)
        if li < last:
            n = channels[li + 1]
            out += [Layer("stride", li, c, n, True), Layer("stride", li, n, c, True),
                    Layer("subm", li, 2 * c, c, True), Layer("point", li, 2 * c, c, True),
                    Layer("subm", li, c, c, True)]
            out += [Layer("subm", li, c, c, True)] * (2 * (repeat - 1))
    return out


def pointnet_layers(cin: int, fea: int) -> List[Tuple[str, int, int, bool]]:
    """(rows, cin, cout, dgrad) of the PointNet backbone's matmuls; rows
    "points" (every point) or "clouds" (one row a cloud)."""
    def stn(c, k, first):
        return [("points", c, 64, not first), ("points", 64, 128, True), ("points", 128, 1024, True),
                ("clouds", 1024, 512, True), ("clouds", 512, 256, True), ("clouds", 256, k * k, True)]
    return (stn(cin, 3, True) + [("points", 3, 3, False), ("points", cin, 64, False)]
            + stn(64, 64, False) + [("points", 64, 64, True), ("points", 64, 128, True),
                                    ("points", 128, 1024, True), ("points", 1088, 512, True),
                                    ("points", 512, 256, True), ("points", 256, 256, True),
                                    ("points", 256, fea, True)])


def _passes(train: bool, dgrad: bool) -> int:
    return 1 if not train else (3 if dgrad else 2)


def unet_flops(layers: List[Layer], geo: Geometry, train: bool) -> float:
    total = 0.0
    for l in layers:
        rows = geo.pairs[l.level] if l.kind == "subm" else geo.voxels[l.level]
        total += 2.0 * l.cin * l.cout * rows * _passes(train, l.dgrad)
    return total


def step_flops(model: dict, points: int, clouds: int, backbone: Geometry, proposals: Geometry,
               num_proposals: int, train: bool) -> float:
    """Model FLOPs of one step (train: forward, dgrad and wgrad) or one
    eval forward: every matmul layer once, at the rows the inputs need."""
    ch, rep, c = model["channels"], model["block_repeat"], model["num_part_classes"]
    fea = ch[0]
    if model["backbone_type"] == "PointNet":
        total = sum(2.0 * ci * co * (points if r == "points" else clouds) * _passes(train, d)
                    for r, ci, co, d in pointnet_layers(model["in_channels"], fea))
    else:
        total = unet_flops(unet_layers(ch, rep, model["in_channels"]), backbone, train)
    heads = [(points, fea, c), (points, fea, fea), (points, fea, 3),
             (num_proposals, fea, c - 1), (proposals.voxels[0], fea, 3 * (c - 1))]
    total += sum(2.0 * r * ci * co * _passes(train, True) for r, ci, co in heads)
    total += 2 * unet_flops(unet_layers(ch[:2], rep, None), proposals, train)
    return total


def subm_bound_s(model: dict, backbone: Geometry, proposals: Geometry, train: bool) -> float:
    """The least device time of the step's (train) or the forward's (eval)
    submanifold conv kernels: the backbone's, and in training the two
    proposal UNets' (the eval path runs those as dense convs, not through
    these kernels).  The bound of each conv is taken alone and summed."""
    ch, rep = model["channels"], model["block_repeat"]
    nets = [] if model["backbone_type"] == "PointNet" else [
        (unet_layers(ch, rep, model["in_channels"]), backbone)]
    if train:
        nets += [(unet_layers(ch[:2], rep, None), proposals)] * 2
    total = 0.0
    for layers, geo in nets:
        for l in layers:
            if l.kind != "subm":
                continue
            ops, nbytes = subm_conv_work(l.cin, l.cout, geo.voxels[l.level], geo.pairs[l.level])
            total += bound_s(ops, nbytes) * _passes(train, l.dgrad)
    return total


def geometry(levels) -> Geometry:
    """Geometry of the reference's grid levels (reference.ops.Level)."""
    return Geometry([int(lv.mask.sum()) for lv in levels], [int((lv.nbr >= 0).sum()) for lv in levels])


def work_of(model: dict, ref_cfg, points, mask, entry_point, entry_pid, nprop, rand_a, rand_b,
            train: bool) -> Dict[str, float]:
    """{"flops", "subm_bound_s"} of one step or request, from the
    reference's grids of these inputs."""
    from portbench.reference import model as ref_model
    from portbench.reference import ops

    if model["backbone_type"] == "PointNet":
        bb = Geometry([0], [0])
    else:
        keys, _, _ = ops.voxelize_batch(points, mask, ref_cfg.voxel_size)
        bb = geometry(ops.hierarchy(keys, ref_cfg.num_levels)[0])
    p = max(max(nprop), 1)
    levels, _, _, _ = ref_model.proposal_grids(ref_cfg, points[..., :3], entry_point, entry_pid, p,
                                               rand_a, rand_b)
    pg = geometry(levels)
    npts = int(mask.sum())
    return {"flops": step_flops(model, npts, points.shape[0], bb, pg, sum(nprop), train),
            "subm_bound_s": subm_bound_s(model, bb, pg, train)}

