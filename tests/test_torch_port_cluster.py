"""Hash-grid clustering: the port against the JAX package, exactly.

Labels, proposal ids and all three counters (node overflow, candidate /
degree truncation, dropped proposals) must be identical, including cases
that hit the candidate cap and the node cap so the counters are non-zero.
The JAX side runs jitted (as in the model), where division by the cell
size becomes multiplication by its float32 reciprocal; the port does the
same.  The proposal grids that follow clustering are compared too: the
dense cells of the eval path, and the sparse proposal grid of the train
path (keys, voxel counts and each entry's voxel, exactly, for given jitter
draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapartnet_tpu.models import grouping as jg
from gapartnet_tpu.ops.hash_ccl import hash_connected_components as jax_ccl
from gapartnet_tpu_torch.models import grouping as tg
from gapartnet_tpu_torch.ops.hash_ccl import hash_connected_components as port_ccl


def _cloud(seed, n=300, extent=0.3, classes=3):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(n, 3) * extent).astype(np.float32)
    sem = rng.randint(0, classes + 1, n).astype(np.int32)
    valid = (sem > 0) & (rng.rand(n) > 0.1)
    off = (rng.randn(n, 3) * 0.02).astype(np.float32)
    return xyz, sem, valid, off


def _blobs(seed, per=120):
    """Tight same-label blobs: dense neighbourhoods that overflow small caps."""
    rng = np.random.RandomState(seed)
    centers = np.array([[0.1, 0.1, 0.1], [0.2, 0.12, 0.1], [0.1, 0.25, 0.2]], np.float32)
    xyz = np.concatenate([c + rng.randn(per, 3).astype(np.float32) * 0.03 for c in centers])
    sem = np.repeat(np.array([1, 1, 2], np.int32), per)
    valid = np.ones(len(xyz), bool)
    off = np.zeros_like(xyz)
    return xyz, sem, valid, off


def _dual(xyz, sem, valid, off):
    n = len(xyz)
    return (np.concatenate([xyz, xyz + off]), np.concatenate([sem, sem]),
            np.concatenate([valid, valid]), np.arange(2 * n) >= n)


CASES = {
    # name: (data, radius, kwargs, which counter must be non-zero)
    "plain": (_cloud(0), 0.04, dict(node_capacity=0, cand_cap=0, max_degree=24), None),
    "full_cand_cap": (_cloud(1), 0.04, dict(node_capacity=512, cand_cap=64, max_degree=24), None),
    "cand_cap_hit": (_blobs(2), 0.04, dict(node_capacity=0, cand_cap=4, max_degree=4), "cand"),
    "degree_cap_hit": (_blobs(3), 0.04, dict(node_capacity=0, cand_cap=32, max_degree=6), "cand"),
    "node_cap_hit": (_cloud(4, extent=0.6), 0.04, dict(node_capacity=64, cand_cap=0, max_degree=12), "node"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_hash_ccl_matches(name):
    (xyz, sem, valid, off), radius, kw, hit = CASES[name]
    both, sem2, valid2, set_mask = _dual(xyz, sem, valid, off)
    jl, jov, jtr = jax_ccl(jnp.asarray(both), jnp.asarray(sem2), jnp.asarray(valid2), radius,
                           set_mask=jnp.asarray(set_mask), probe_impl="sort", **kw)
    tl, tov, ttr = port_ccl(torch.from_numpy(both), torch.from_numpy(sem2),
                            torch.from_numpy(valid2), radius,
                            set_mask=torch.from_numpy(set_mask), **kw)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(tov) == int(jov)
    assert int(ttr) == int(jtr)
    if hit == "cand":
        assert int(ttr) > 0
    elif hit == "node":
        assert int(tov) > 0
    # some non-trivial components exist
    lab = tl.numpy()
    assert (lab[valid2] != np.arange(len(lab))[valid2]).any()


def test_hash_ccl_single_set_matches_table_probe():
    xyz, sem, valid, _ = _cloud(5, n=400)
    jl, jov, jtr = jax_ccl(jnp.asarray(xyz), jnp.asarray(sem), jnp.asarray(valid), 0.04,
                           probe_impl="table")
    tl, tov, ttr = port_ccl(torch.from_numpy(xyz), torch.from_numpy(sem),
                            torch.from_numpy(valid), 0.04)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (int(tov), int(ttr)) == (int(jov), int(jtr))


@pytest.mark.parametrize("node_cap,max_props", [(0, 32), (24, 32), (0, 4)])
def test_cluster_single_matches(node_cap, max_props):
    xyz, sem, valid, off = _cloud(6, n=400)
    jp = jg.cluster_single(
        jnp.asarray(xyz), jnp.asarray(off), jnp.asarray(sem), jnp.asarray(valid),
        0.04, 50, 300, 3, max_props, impl="hash", hash_node_capacity=node_cap,
        probe_impl="sort", hash_cand_cap=0, hash_max_degree=24,
    )
    tp = tg.cluster_single(
        torch.from_numpy(xyz), torch.from_numpy(off), torch.from_numpy(sem),
        torch.from_numpy(valid), 0.04, 3, max_props, hash_node_capacity=node_cap,
        hash_cand_cap=0, hash_max_degree=24,
    )
    for f in jp._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), err_msg=f)
    assert int(tp.num_proposals) > 0
    if node_cap:
        assert int(tp.ccl_overflow) > 0
    if max_props == 4:
        assert int(tp.num_dropped) > 0


def test_dense_voxelize_matches():
    """Proposal cube cells of the dense ScoreNet path (eval jitter 0.5)."""
    import jax

    xyz, sem, valid, off = _cloud(7, n=400)
    p = 16
    jp = jg.cluster_single(jnp.asarray(xyz), jnp.asarray(off), jnp.asarray(sem),
                           jnp.asarray(valid), 0.04, 50, 300, 3, p, probe_impl="sort")
    tp = tg.cluster_single(torch.from_numpy(xyz), torch.from_numpy(off), torch.from_numpy(sem),
                           torch.from_numpy(valid), 0.04, 3, p)
    half = np.full(3, 0.5, np.float32)
    jcell = jax.jit(lambda x, pr: jg.segmented_dense_voxelize_single(
        x, pr, jnp.asarray(half), jnp.asarray(half), p))(jnp.asarray(xyz), jp)
    tcell = tg.segmented_dense_voxelize_single(
        torch.from_numpy(xyz), tp, torch.from_numpy(half), torch.from_numpy(half), p)
    jcell, tcell = np.asarray(jcell), tcell.numpy()
    np.testing.assert_array_equal(tcell < 0, jcell < 0)
    # the port's float64 proposal mean may move a cell by one on a boundary
    differ = tcell != jcell
    assert differ.sum() <= max(1, 1e-3 * (jcell >= 0).sum())
    assert (tcell >= 0).sum() > 0


def test_proposal_cell_equal():
    assert tg.PROPOSAL_CELL == jg.PROPOSAL_CELL


@pytest.mark.parametrize("seed,p", [(0, 16), (1, 40), (2, 16)])
def test_segmented_voxelize_matches(seed, p):
    xyz, sem, valid, off = _cloud(seed, n=400)
    jp = jg.cluster_single(jnp.asarray(xyz), jnp.asarray(off), jnp.asarray(sem),
                           jnp.asarray(valid), 0.04, 50, 300, 3, p, probe_impl="sort")
    tp = tg.cluster_single(torch.from_numpy(xyz), torch.from_numpy(off), torch.from_numpy(sem),
                           torch.from_numpy(valid), 0.04, 3, p)
    rand = np.random.RandomState(100 + seed).rand(2, 3).astype(np.float32)
    jgrid = jax.jit(lambda x, pr, a, b: jg.segmented_voxelize_single(x, pr, a, b, p))(
        jnp.asarray(xyz), jp, jnp.asarray(rand[0]), jnp.asarray(rand[1]))
    tgrid = tg.segmented_voxelize_single(torch.from_numpy(xyz), tp, torch.from_numpy(rand[0]),
                                         torch.from_numpy(rand[1]), p)
    for f in jgrid._fields:
        np.testing.assert_array_equal(getattr(tgrid, f).numpy(), np.asarray(getattr(jgrid, f)),
                                      err_msg=f)
    assert int(tgrid.num_voxels) > 0
    # proposals beyond the first 32 land in the next row of super-grid cells
    if p > 32:
        assert (tp.entry_proposal.numpy() >= 32).any()
        assert ((tgrid.keys.numpy() >> 10) & 1023).max() >= 32


def _padded(data, n):
    """A cloud padded with invalid points to n points."""
    xyz, sem, valid, off = data
    k = n - len(xyz)
    return (np.concatenate([xyz, np.zeros((k, 3), np.float32)]),
            np.concatenate([sem, np.zeros(k, np.int32)]),
            np.concatenate([valid, np.zeros(k, bool)]),
            np.concatenate([off, np.zeros((k, 3), np.float32)]))


def _no_points(seed, n=300):
    xyz, sem, _, off = _cloud(seed, n=n)
    return xyz, sem, np.zeros(len(xyz), bool), off


# name: (clouds, kwargs, MAX_ITERS or None); every batch holds a cloud that
# hits a cap, one that hits none, and a cloud with no valid point
BATCHES = {
    # node cap and candidate cap, both propagation phases
    "node_and_cand_caps": (
        [CASES["cand_cap_hit"][0], CASES["node_cap_hit"][0], _cloud(8, n=60), _no_points(9)],
        dict(node_capacity=256, cand_cap=8, max_degree=12), None),
    # degree cap, the narrow phase alone
    "degree_cap": (
        [_no_points(10), CASES["plain"][0], CASES["full_cand_cap"][0], CASES["degree_cap_hit"][0]],
        dict(node_capacity=0, cand_cap=32, max_degree=6), None),
    # the iteration cap cuts some clouds off and not others
    "iteration_cap": (
        [CASES["cand_cap_hit"][0], CASES["node_cap_hit"][0], _cloud(8, n=60), _no_points(9)],
        dict(node_capacity=256, cand_cap=8, max_degree=12), 2),
}


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_hash_ccl_batch_matches_per_cloud(name, monkeypatch):
    """One batched call gives every cloud the labels and both counters of
    its one-sample call, bitwise, and of `jax.vmap` of the JAX function:
    clouds that converge after different numbers of iterations, clouds cut
    off by the iteration cap, a cloud with no valid point."""
    from gapartnet_tpu_torch.ops import hash_ccl
    from gapartnet_tpu_torch.utils import profiling

    clouds, kw, max_iters = BATCHES[name]
    n = max(len(c[0]) for c in clouds)
    duals = [_dual(*_padded(c, n)) for c in clouds]
    x, s, v, m = (np.stack(a) for a in zip(*duals))

    def per_cloud():
        """Each cloud's one-sample result and its iterations per phase."""
        out, phases = [], []
        for d in duals:
            with profiling.record() as rec:
                out.append(port_ccl(*[torch.from_numpy(a) for a in d[:3]], 0.04,
                                    set_mask=torch.from_numpy(d[3]), **kw))
            parents = [s.parent for s in rec.spans if s.name == "ccl:iteration"]
            phases.append([parents.count(i) for i, s in enumerate(rec.spans)
                           if s.name == "ccl:propagate"])
            assert rec.counts["hash_ccl_iterations"] == sum(phases[-1])
        return out, phases

    uncapped, phases = per_cloud()
    if max_iters is not None:
        monkeypatch.setattr(hash_ccl, "MAX_ITERS", max_iters)
    want, capped = per_cloud()
    tests = [sum(p) for p in capped]
    with profiling.record() as rec:
        got = hash_ccl.hash_connected_components_batch(
            torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(v), 0.04,
            set_mask=torch.from_numpy(m), **kw)
    assert rec.counts["hash_ccl_clouds"] == len(clouds)
    # a batch's phase runs until its slowest cloud has converged or the cap
    assert rec.counts["hash_ccl_iterations"] == rec.summary()["sync:ccl_converged"]["n"] == sum(
        max(p) for p in zip(*capped))
    for i, (lab, ovf, trunc) in enumerate(want):
        np.testing.assert_array_equal(got[0][i].numpy(), lab.numpy(), err_msg=f"cloud {i}")
        assert (int(got[1][i]), int(got[2][i])) == (int(ovf), int(trunc)), i

    jl, jov, jtr = jax.vmap(lambda a, b, c, d: jax_ccl(
        a, b, c, 0.04, set_mask=d, probe_impl="sort", max_iters=max_iters or 32, **kw))(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(v), jnp.asarray(m))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jl))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jov))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jtr))

    # the batch mixes what the case names
    ovf, trunc = got[1].numpy(), got[2].numpy()
    assert ((ovf > 0) | (trunc > 0)).any() and ((ovf == 0) & (trunc == 0)).any()
    empty = [i for i, c in enumerate(clouds) if not c[2].any()]
    assert len(empty) == 1 and (got[0][empty[0]].numpy() == np.arange(2 * n)).all()
    assert len({t for i, t in enumerate(tests) if i not in empty}) > 1   # unequal iterations
    if name == "node_and_cand_caps":
        assert (ovf > 0).any() and (trunc > 0).any()
    # a phase that needs more iterations than the cap is cut off
    cut = [max(p) > (max_iters or 32) for p in phases]
    if max_iters is not None:
        assert any(cut) and not all(cut)
    else:
        assert not any(cut)
        assert all(torch.equal(w[0], u[0]) for w, u in zip(want, uncapped))


@pytest.mark.parametrize("node_cap,max_props", [(0, 32), (24, 32), (0, 4)])
def test_cluster_batch_matches_cluster_single(node_cap, max_props):
    """Every field of the batched hash clustering equals `stack_proposals`
    of per-cloud `cluster_single`, with proposals dropped beyond the cap
    and with node-table overflow."""
    clouds = [_cloud(11 + i, n=400) for i in range(3)] + [_no_points(14, n=400)]
    x, o, s, v = (torch.from_numpy(np.stack(a)) for a in zip(*[(c[0], c[3], c[1], c[2])
                                                                 for c in clouds]))
    kw = dict(hash_node_capacity=node_cap, hash_cand_cap=0, hash_max_degree=24)
    got = tg.cluster_hash_batch(x, o, s, v, 0.04, 3, max_props, **kw)
    want = tg.stack_proposals([tg.cluster_single(x[i], o[i], s[i], v[i], 0.04, 3, max_props, **kw)
                               for i in range(len(clouds))])
    for f in want._fields:
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f).numpy(), err_msg=f)
    assert int(got.num_proposals[-1]) == 0 and int(got.num_proposals.sum()) > 0
    if node_cap:
        assert (got.ccl_overflow[:-1] > 0).all()
    if max_props == 4:
        assert (got.num_dropped[:-1] > 0).all()
