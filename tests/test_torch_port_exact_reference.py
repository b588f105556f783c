"""Exact clustering against the benchmark's plain reference
(portbench/reference/exact.py: a blocked first-K ball query with no tile
and no band, min-label propagation run to its fixpoint), with the
published K = 50 / 300 and r = 0.04, on clouds of more than 1024 points
(the reference computes the squared distance with the chain the port
takes above 1024 points, fma(dz, dz, fma(dy, dy, dx * dx))):

  * `ball_query_single` and `connected_components_single`, integers
    exactly, on a random labelled cloud with invalid points, a blob where
    both caps bind, and lattices at spacing exactly r (neighbour pairs
    within an ulp of r2 on both sides), and the ball query's recorded
    counts (full rows, hits, index sum) against the reference's;
  * `cluster_single(impl="exact")` on the benchmark's asset and on a random
    cloud with offsets, against the reference's proposals, exactly;
  * a two-cloud SparseUNet train step with `clustering_impl="exact"`
    (`train.loop.train_step`, capacities by `entry._fitted_capacities` and
    `entry._exact_proposals`) against the reference model on the
    reference's proposals, from the same seeded weights and jitter, and
    the step's recorded ball-query counts against the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gapartnet_tpu_torch.models.grouping import cluster_single
from gapartnet_tpu_torch.ops.ball_query import ball_query_single, fma_sq_dist
from gapartnet_tpu_torch.ops.ccl import connected_components_single
from gapartnet_tpu_torch.utils import profiling
from portbench import cloud, compare, weights
from portbench.reference import exact
from portbench.reference import model as ref
from tests.test_torch_port_exact_cluster import _blob, _cloud, _lattice

RADIUS = 0.04
# the train step's tolerances: both sides are float32 on the CPU and sum
# in other orders (the reference's convs gather and sum per tap, the
# port's rulebook kernels per pair), so they agree to rounding only
LOSS_RTOL = 1e-6   # the loss is a mean of per-point terms, a few float32 roundings deep (0 measured)
GRAD_RTOL = 1e-4   # per leaf |g - g_ref| over max(|g_ref|, median leaf |g|): the deepest leaves
                   # take the rounding of 30+ layers back (2.3e-6 measured), as in test_torch_port_train
CASES = {
    "cloud": lambda: _cloud(11, 1500),
    "blob": lambda: _blob(12, 1100),
    "lattice": lambda: _lattice(1100),
    "axis_lattice": lambda: _lattice(1100, rotate=False),
}


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_reference_chain_is_the_ports():
    """The reference's squared distance equals the port's above 1024
    points bitwise, on a lattice whose neighbour pairs straddle r2."""
    xyz, = _tensors(_lattice(1100)[0])
    got = exact.sq_dist(xyz, xyz)
    np.testing.assert_array_equal(got.numpy(), fma_sq_dist(xyz, xyz).numpy())
    r2 = np.float32(RADIUS * RADIUS)
    near = np.abs(got.numpy().astype(np.float64) - r2) <= 4 * np.spacing(r2)
    assert (near & (got.numpy() <= r2)).any() and (near & (got.numpy() > r2)).any()


@pytest.mark.parametrize("k", [50, 300])
@pytest.mark.parametrize("case", list(CASES))
def test_ball_query_and_ccl_match_reference(case, k):
    xyz, sem, valid = _tensors(*CASES[case]())
    want_nbr, want_hits = exact.ball_query(xyz, sem, valid, RADIUS, k)
    with profiling.record() as rec:
        got_nbr, got_cnt = ball_query_single(xyz, sem, valid, RADIUS, k)
    np.testing.assert_array_equal(got_nbr.numpy(), want_nbr.numpy())
    np.testing.assert_array_equal(got_cnt.numpy(), want_hits.numpy())
    want_counts = exact.ball_query_counts(want_nbr, want_hits, k)
    assert {name: rec.counts[name] for name in want_counts} == want_counts
    want = exact.components(want_nbr, valid)
    got, unconverged = connected_components_single(got_nbr, valid)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert unconverged == 0
    if case == "blob":
        assert (want_hits == k).all()                    # the cap binds on every row
    else:
        assert len(torch.unique(want[valid])) > 1


def _asset_cloud(seed=3):
    c = cloud.make_pool(seed, 1, 64)[0]
    valid = (c["sem_labels"] > 0) & (c["instance_labels"] >= 0)
    return c["points"][:, :3], c["cluster_offsets"], c["sem_labels"], valid


def _random_with_offsets():
    xyz, sem, valid = _cloud(13, 1500, extent=0.25)
    return xyz, (np.random.RandomState(14).randn(1500, 3) * 0.01).astype(np.float32), sem, valid


@pytest.mark.parametrize("make", [_asset_cloud, _random_with_offsets], ids=["asset", "random"])
def test_cluster_single_exact_matches_reference(make):
    xyz, off, sem, valid = _tensors(*make())
    want_pid, want_n, _ = exact.cloud_proposals(xyz, off, sem, valid, RADIUS, 50, 300, 5)
    got = cluster_single(xyz, off, sem, valid, RADIUS, 5, 2 * len(xyz), impl="exact",
                         max_num_points_per_query=50, max_num_points_per_query_shift=300)
    np.testing.assert_array_equal(got.entry_proposal.numpy(), want_pid.numpy())
    assert int(got.num_proposals) == want_n > 1
    assert int(got.num_dropped) == int(got.ccl_unconverged) == 0


def test_exact_train_step_matches_reference():
    """One train step of two 1500-point clouds of the asset, all stages on,
    from the same seeded weights and jitter: proposals exactly, the loss
    less its NPCS term (a sem near-tie may tip the NPCS head an entry
    reads) within LOSS_RTOL, every gradient within GRAD_RTOL."""
    from gapartnet_tpu_torch.entry import _exact_proposals, _fitted_capacities, max_fitted
    from gapartnet_tpu_torch.models.gapartnet import GAPartNet
    from gapartnet_tpu_torch.structures import PointCloudBatch
    from gapartnet_tpu_torch.train import loop
    from portbench import program

    model = dict(ref_model_block(), channels=[16, 32], level_capacity_divisors=[1, 2],
                 max_points=1500, max_proposals=32)
    pool = cloud.make_pool(5, 2, model["max_instances"], 1500)
    batch = cloud.stack(pool)
    rcfg = ref.RefConfig.from_model(model)
    state = weights.make_state({k: v.shape for k, v in ref.GAPartNet(rcfg).state_dict().items()}, 5, "cpu")

    cfg = program.config(model)
    fitted = []
    for c in pool:
        fields, _ = _fitted_capacities(cfg, c["points"][:, :3], c["sem_labels"], c["instance_labels"])
        fields.update(_exact_proposals(cfg, c["points"][:, :3], c["sem_labels"], c["cluster_offsets"], "cpu"))
        fitted.append(fields)
    tm = GAPartNet(dataclasses.replace(cfg, **max_fitted(fitted)))
    tm.load_state_dict(state, strict=True)
    opt = loop.adam(tm.named_parameters(), 1e-3)
    seen = {}
    tm.register_forward_hook(lambda mod, args, out: seen.setdefault("out", out))
    with profiling.record() as rec:
        metrics = loop.train_step(tm, opt, PointCloudBatch.from_numpy(batch, "cpu"),
                                  torch.Generator().manual_seed(9), True, True, True,
                                  cluster_sem_override=torch.from_numpy(batch["sem_labels"]),
                                  cluster_offset_override=torch.from_numpy(batch["cluster_offsets"]))
    got_grads = {k: opt.state[p]["exp_avg"] / 0.1 for k, p in tm.named_parameters()}

    b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    valid = (b["sem_labels"] > 0) & b["point_mask"] & (b["instance_labels"] >= 0)
    props, want_counts = exact.batch_proposals(b["points"], b["cluster_offsets"], b["sem_labels"],
                                               valid, model)
    rm = ref.GAPartNet(rcfg)
    rm.load_state_dict(state, strict=True)
    rm.train()
    out = rm(b["points"], b["point_mask"], labels=b, proposals=props,
             jitter=torch.rand((2, 3), generator=torch.Generator().manual_seed(9)))
    out["total_loss"].backward()

    got = seen["out"].proposals
    np.testing.assert_array_equal(got.entry_proposal.numpy(), props[1].numpy())
    assert got.num_proposals.tolist() == props[2] and min(props[2]) > 1
    assert {name: rec.counts[name] for name in want_counts} == want_counts
    assert all(float(v) == 0 for k, v in metrics.items() if k.startswith("counters/"))
    assert "counters/ccl_exact_unconverged" in metrics
    want_loss = float((out["total_loss"] - out["loss_prop_npcs"]).detach())
    got_loss = float(metrics["loss/total_loss"] - metrics["loss/loss_prop_npcs"])
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    want_grads = {k: p.grad for k, p in rm.named_parameters()}
    med = float(np.median([float(g.norm()) for g in want_grads.values()]))
    gaps = {k: float((got_grads[k] - g).norm()) / max(float(g.norm()), med)
            for k, g in want_grads.items()}
    assert max(gaps.values()) <= GRAD_RTOL, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    assert compare.leaf_norm_gap(compare.leaf_norms(got_grads), compare.leaf_norms(want_grads),
                                 compare.leaf_norms(want_grads)) <= GRAD_RTOL


def ref_model_block():
    """The `model` block of the benchmark's exact configuration."""
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "portbench/configs/gapartnet-sparseunet-exact-fp32.json"
    return json.loads(path.read_text())["model"]
