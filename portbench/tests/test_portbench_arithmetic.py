"""The harness's arithmetic on synthetic inputs: percentiles over every
request, the union of device intervals, the work of a subm conv and of a
model, the leaf-norm gaps."""

import numpy as np
import pytest
import torch

from portbench import compare, stats, weights, work
from portbench.reference import ops


def test_p95_over_every_request():
    lat = list(range(1, 201))                       # 1..200 ms, shuffled
    np.random.default_rng(0).shuffle(lat)
    assert stats.percentile(lat, 95) == pytest.approx(190.05)
    assert stats.percentile(lat, 50) == pytest.approx(100.5)


def test_union_and_gaps_of_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert stats.union_length(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert stats.union_length([], 0.0, 1.0) == 0.0
    assert stats.gaps([(-1.0, 0.5)], 0.0, 1.0) == [(0.5, 1.0)]


def test_subm_conv_work_and_bound():
    ops_, nbytes = work.subm_conv_work(cin=16, cout=32, voxels=1000, pairs=9000)
    assert ops_ == 2 * 16 * 32 * 9000
    assert nbytes == 4 * (1000 * 48 + 27 * 16 * 32 + 27 * 1000)
    assert work.bound_s(ops_, nbytes) == pytest.approx(
        max(ops_ / (495e12 / 3), nbytes / 3.35e12))


def test_unet_layers_count_the_flagship_convs():
    layers = work.unet_layers([16, 32, 48, 64, 80, 96, 112], 2, 6)
    subm = [l for l in layers if l.kind == "subm"]
    assert len(subm) == 53                           # the backbone's 53 subm convs
    assert sum(not l.dgrad for l in layers) == 1     # the stem's input needs no gradient
    assert len([l for l in work.unet_layers([16, 32], 2, None) if l.kind == "subm"]) == 12


def test_geometry_of_a_line_of_voxels():
    """Five voxels in a row: 5 + 2 * 4 neighbour pairs at level 0."""
    coords = torch.tensor([[0, 0, i] for i in range(5)], dtype=torch.int32)
    keys = ops.pack_coords(coords)[None]
    levels, _ = ops.hierarchy(keys, 2)
    geo = work.geometry(levels)
    assert geo.voxels == [5, 3] and geo.pairs[0] == 13 and geo.pairs[1] == 3 + 2 * 2


def test_train_flops_are_three_passes_but_the_stem():
    geo = work.Geometry([10, 4], [50, 8])
    layers = work.unet_layers([16, 32], 2, 6)
    fwd = work.unet_flops(layers, geo, False)
    stem = 2 * 6 * 16 * 50
    assert work.unet_flops(layers, geo, True) == pytest.approx(3 * fwd - stem)


def test_leaf_gaps_leave_out_round_off_leaves():
    ref = {"a": 1.0, "b": 2.0, "c": 3.0, "noise": 1e-5, "dead": 0.0}
    prog = {"a": 1.01, "b": 2.0, "c": 3.0, "noise": 5e-3, "dead": 0.0}
    gaps = compare.leaf_gaps(prog, ref, ref)
    assert set(gaps) == {"a", "b", "c"}              # under 1e-3 of the median (2.0) goes
    assert compare.leaf_norm_gap(prog, ref, ref) == pytest.approx(0.01 / 2.0)
    assert compare.median_leaf_gap(prog, ref, ref) == 0.0


def test_weights_are_the_seeds():
    shapes = {"a.kernel": torch.Size([27, 4, 8]), "b.weight": torch.Size([3, 5]),
              "b.bias": torch.Size([3]), "bn.weight": torch.Size([8]),
              "bn.running_var": torch.Size([8]), "stn.fc3.weight": torch.Size([9, 4])}
    a = weights.make_state(shapes, 2 ** 31 + 11, "cpu")
    b = weights.make_state(shapes, 2 ** 31 + 11, "cpu")
    c = weights.make_state(shapes, 2 ** 31 + 12, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["a.kernel"], c["a.kernel"])
    assert float(a["a.kernel"].abs().max()) <= (6.0 / (27 * 4)) ** 0.5
    assert torch.equal(a["bn.weight"], torch.ones(8)) and torch.equal(a["b.bias"], torch.zeros(3))
    assert torch.equal(a["stn.fc3.weight"], torch.zeros(9, 4))
