"""Exact clustering (the reference's first-K ball query and list CCL): the
port against the JAX package, integers exactly.

  * `ball_query_single` on random labelled clouds with invalid points, on a
    dense blob where the K cap binds, and on a lattice at spacing exactly
    `radius`, where neighbour pairs lie within an ulp of r2 on both sides
    (the JAX function runs jitted, its squared distance an FMA chain);
  * `connected_components_single` on ball-query graphs and on two long
    chains, with the iteration bound cut short and at its default 64;
  * the plain loop on the graphs the card test holds the CCL kernel to,
    the same inputs;
  * `cluster_single(impl="exact")`;
  * SMALL_CFG with `clustering_impl="exact"`: an eval forward (integers
    exactly, floats 1e-4) and one train step (losses and gradients as
    tests/test_torch_port_train.py holds them).

JAX is imported inside the CPU tests only: the card test at the end runs on
a machine without it (`pytest --noconftest -m cuda`).
"""

import functools

import numpy as np
import pytest
import torch

from gapartnet_tpu_torch.models import grouping as tg
from gapartnet_tpu_torch.ops.ball_query import ball_query_single, fma_sq_dist
from gapartnet_tpu_torch.ops.ccl import connected_components_single

RADIUS = 0.04
TOL = 1e-4


def _cloud(seed, n, extent=0.3, classes=3):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(n, 3) * extent).astype(np.float32)
    sem = rng.randint(0, classes + 1, n).astype(np.int32)
    valid = (sem > 0) & (rng.rand(n) > 0.1)
    return xyz, sem, valid


def _blob(seed, n):
    """Every point within RADIUS / 2 of one centre, one label: each query
    hits all n points, so any K < n binds."""
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3)
    d *= (rng.rand(n, 1) * RADIUS / 2) / np.linalg.norm(d, axis=1, keepdims=True)
    return (0.2 + d).astype(np.float32), np.ones(n, np.int32), np.ones(n, bool)


def _lattice(n, radius=RADIUS, rotate=True):
    """A cubic lattice at spacing exactly `radius`, one label, cut to n
    points: 0.1 + i * radius, turned (in float64) about the axis (1, 2, 3)
    so that neighbours differ in all three coordinates, then rounded to
    float32."""
    m = int(np.ceil(n ** (1 / 3)))
    i = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), -1).reshape(-1, 3)[:n]
    xyz = i * radius
    if rotate:
        a = np.array([1.0, 2.0, 3.0]) / np.sqrt(14.0)
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        xyz = xyz @ (np.eye(3) + np.sin(0.7) * k + (1 - np.cos(0.7)) * k @ k).T
    return (0.1 + xyz).astype(np.float32), np.ones(n, np.int32), np.ones(n, bool)


CASES = {
    "cloud": _cloud,
    "blob": _blob,
    "lattice": lambda seed, n: _lattice(n),
    "axis_lattice": lambda seed, n: _lattice(n, rotate=False),
}


def _jax_ball_query(xyz, sem, valid, radius, k):
    import jax.numpy as jnp

    from gapartnet_tpu.ops.ball_query import ball_query_single as jax_bq

    nbr, cnt = jax_bq(jnp.asarray(xyz), jnp.asarray(sem), jnp.asarray(valid), radius, k)
    return np.asarray(nbr), np.asarray(cnt)


@pytest.mark.parametrize("case,n,k", [
    ("cloud", 512, 8), ("cloud", 2000, 50), ("blob", 512, 50), ("blob", 2000, 300),
    ("lattice", 512, 8), ("lattice", 1024, 8), ("lattice", 1025, 8), ("lattice", 2000, 50),
    ("axis_lattice", 512, 8),
])
def test_ball_query_matches(case, n, k):
    xyz, sem, valid = CASES[case](n, n)
    want_idx, want_cnt = _jax_ball_query(xyz, sem, valid, RADIUS, k)
    got_idx, got_cnt = ball_query_single(torch.from_numpy(xyz), torch.from_numpy(sem),
                                         torch.from_numpy(valid), RADIUS, k)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    np.testing.assert_array_equal(got_cnt.numpy(), want_cnt)
    assert got_idx.dtype == torch.int32 and got_cnt.dtype == torch.int32
    if case == "blob":
        assert (want_cnt == k).all()                      # the cap binds everywhere
    if case == "cloud":
        assert (want_cnt[~valid] == 0).all() and (want_cnt[valid] > 1).any()


def test_lattice_pairs_straddle_r2():
    """The lattice test is a boundary test: neighbours at spacing `radius`
    fall on both sides of r2, and the FMA chain decides some of them
    differently from squares and sums each rounded on their own."""
    xyz, _, _ = _lattice(2000)
    t = torch.from_numpy(xyz)
    d2 = fma_sq_dist(t, t)
    r2 = np.float32(RADIUS * RADIUS)
    axis = np.isclose(np.sqrt((((xyz[:, None] - xyz[None]).astype(np.float64)) ** 2).sum(-1)),
                      RADIUS, rtol=1e-5)
    inside = (d2.numpy() <= r2) & axis
    assert inside.any() and (~inside & axis).any()
    d = t[:, None, :] - t[None, :, :]
    plain = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]).numpy()
    assert ((plain <= r2) != (d2.numpy() <= r2)).any()
    # the band decides exactly what the whole chain decides
    from gapartnet_tpu_torch.ops.ball_query import within_radius

    np.testing.assert_array_equal(within_radius(t, t, torch.tensor(r2), False).numpy(),
                                  d2.numpy() <= r2)


def test_fma_f32_is_one_rounding():
    """fma_f32 against exact rational arithmetic on random and
    near-cancelling float32 triples."""
    from fractions import Fraction

    from gapartnet_tpu_torch.ops.ball_query import fma_f32

    rng = np.random.RandomState(3)
    a = rng.randn(4000).astype(np.float32)
    b = rng.randn(4000).astype(np.float32)
    c = np.where(np.arange(4000) % 2 == 0, -(a * b), rng.randn(4000)).astype(np.float32)
    c[::3] *= np.float32(1e-9)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(0, 4000, 7):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))          # float() rounds the rational once to double
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32)) & 1))
        assert got[i] == best, (i, a[i], b[i], c[i])


def _chains(n=600, k=4, seed=0):
    """Two interleaved chains over a random permutation of the points,
    each node listing its successor only (a directed path), plus invalid
    nodes: min labels must travel the whole chain, which takes 144
    iterations, so the default bound of 64 binds."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    nbr = np.full((n, k), -1, np.int32)
    for chain in (order[: n // 2], order[n // 2:]):
        nbr[chain[:-1], 0] = chain[1:]
    valid = rng.rand(n) > 0.05
    return nbr, valid


@pytest.mark.parametrize("graph,max_iters", [
    ("chains", 1), ("chains", 64), ("chains", 200), ("ball_query", 2), ("ball_query", 64),
])
def test_ccl_matches(graph, max_iters):
    import jax.numpy as jnp

    from gapartnet_tpu.ops.ccl import connected_components_single as jax_ccl

    if graph == "chains":
        nbr, valid = _chains()
    else:
        xyz, sem, valid = _cloud(4, 2000)
        nbr, _ = _jax_ball_query(xyz, sem, valid, RADIUS, 50)
    want = np.asarray(jax_ccl(jnp.asarray(nbr), jnp.asarray(valid), max_iters=max_iters))
    got = connected_components_single(torch.from_numpy(nbr), torch.from_numpy(valid),
                                      max_iters=max_iters)[0].numpy()
    np.testing.assert_array_equal(got, want)
    if graph == "chains":
        # converged within 200: two components, each labelled by its
        # minimum point; cut short by 1 or 64 iterations: more labels
        labels = len(np.unique(got[valid & (nbr[:, 0] >= 0)]))
        assert labels == 2 if max_iters == 200 else labels > 2


@pytest.mark.parametrize("max_props", [64, 4])
def test_cluster_single_exact_matches(max_props):
    import jax.numpy as jnp

    from gapartnet_tpu.models import grouping as jg

    xyz, sem, valid = _cloud(5, 1000, extent=0.25)
    off = (np.random.RandomState(6).randn(1000, 3) * 0.01).astype(np.float32)
    jp = jg.cluster_single(jnp.asarray(xyz), jnp.asarray(off), jnp.asarray(sem),
                           jnp.asarray(valid), RADIUS, 16, 64, 3, max_props, impl="exact")
    tp = tg.cluster_single(torch.from_numpy(xyz), torch.from_numpy(off), torch.from_numpy(sem),
                           torch.from_numpy(valid), RADIUS, 3, max_props, impl="exact",
                           max_num_points_per_query=16, max_num_points_per_query_shift=64)
    for f in jp._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                      err_msg=f)
    assert int(jp.num_proposals) > 1
    if max_props == 4:
        assert int(jp.num_dropped) > 0


@pytest.mark.parametrize("max_iters", [2, 64])
def test_cluster_single_exact_counts_capped_sets(monkeypatch, max_iters):
    """A line of points, each within the radius of its two neighbours only:
    both sets are one chain, which 2 CCL iterations do not settle.
    `ccl_unconverged` is the sum of the two sets' flags, a () int32 tensor."""
    from gapartnet_tpu_torch.ops import ccl

    n = 200
    xyz = torch.zeros((n, 3))
    xyz[:, 0] = torch.arange(n) * (0.75 * RADIUS)
    ones = torch.ones(n, dtype=torch.bool)
    monkeypatch.setattr(tg, "connected_components_single",
                        lambda nbr, valid: ccl.connected_components_single(nbr, valid, max_iters))
    got = tg.cluster_single(xyz, torch.zeros_like(xyz), torch.ones(n, dtype=torch.int32), ones,
                            RADIUS, 3, 8, impl="exact", max_num_points_per_query=4,
                            max_num_points_per_query_shift=4)
    nbr, _ = ball_query_single(xyz, torch.ones(n, dtype=torch.int32), ones, RADIUS, 4)
    cut = int(ccl.connected_components_reference(nbr, ones, max_iters)[1])
    assert got.ccl_unconverged.shape == () and got.ccl_unconverged.dtype == torch.int32
    assert int(got.ccl_unconverged) == 2 * cut == (2 if max_iters == 2 else 0)


@pytest.fixture(scope="module")
def model_setup():
    from tests.test_torch_port_train import small_setup

    return small_setup(clustering_impl="exact")


def _port_model(variables):
    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.models.gapartnet import GAPartNet
    from gapartnet_tpu_torch.weights import params_from_jax
    from tests.test_torch_port_train import SMALL

    tm = GAPartNet(GAPartNetConfig(**SMALL, clustering_impl="exact"))
    tm.load_state_dict(params_from_jax(variables), strict=True)
    return tm


def test_exact_model_eval_forward_matches(model_setup):
    import jax
    import jax.numpy as jnp

    jm, variables, jbatch, tbatch, sem, off = model_setup
    unlabelled = type(jbatch)(points=jbatch.points, point_mask=jbatch.point_mask)
    jo = jax.jit(lambda v, b, cs, co: jm.apply(
        v, b, train=False, do_cluster=True, do_score=True, do_npcs=True,
        cluster_sem_override=cs, cluster_offset_override=co))(
            variables, unlabelled, jnp.asarray(sem), jnp.asarray(off))
    tm = _port_model(variables).eval()
    with torch.no_grad():
        to = tm(type(tbatch)(points=tbatch.points, point_mask=tbatch.point_mask),
                do_cluster=True, do_score=True, do_npcs=True,
                cluster_sem_override=torch.from_numpy(sem),
                cluster_offset_override=torch.from_numpy(off))
    for f in jo.proposals._fields:
        np.testing.assert_array_equal(getattr(to.proposals, f).numpy(),
                                      np.asarray(getattr(jo.proposals, f)), err_msg=f)
    np.testing.assert_array_equal(to.sem_preds.numpy(), np.asarray(jo.sem_preds))
    np.testing.assert_array_equal(to.proposal_sem.numpy(), np.asarray(jo.proposal_sem))
    # the port counts exact-CCL sets cut off by the iteration cap besides
    assert set(to.counters) == set(jo.counters) | {"ccl_exact_unconverged"}
    assert not to.counters["ccl_exact_unconverged"].any()
    for k, v in jo.counters.items():
        np.testing.assert_array_equal(to.counters[k].numpy(), np.asarray(v), err_msg=k)
    assert (np.asarray(jo.proposals.num_proposals) > 0).all()
    for name in ("sem_logits", "offset_preds", "score_logits", "score_preds", "npcs_preds"):
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_exact_model_train_step_matches(model_setup):
    import jax

    from tests.test_torch_port_train import (
        LOSSES,
        LOSS_TOL,
        check_grads,
        check_stats,
        jax_jitter,
        jax_step,
        port_step,
    )

    jm, variables, jbatch, tbatch, sem, off = model_setup
    flags = dict(do_cluster=True, do_score=True, do_npcs=True)
    key = jax.random.PRNGKey(3)
    jitter = jax_jitter(jm, variables, jbatch, key)
    jo, grads, new_bs = jax_step(jm, variables, jbatch, key, flags, sem, off)
    tm = _port_model(variables)
    to = port_step(tm, tbatch, jitter, flags, sem, off)
    for f in jo.proposals._fields:
        np.testing.assert_array_equal(getattr(to.proposals, f).numpy(),
                                      np.asarray(getattr(jo.proposals, f)), err_msg=f)
    np.testing.assert_array_equal(to.npcs_valid.numpy(), np.asarray(jo.npcs_valid))
    np.testing.assert_allclose(to.ious.numpy(), np.asarray(jo.ious), rtol=0, atol=0)
    for k in LOSSES:
        np.testing.assert_allclose(float(getattr(to, k).detach()), float(getattr(jo, k)),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    assert float(jo.loss_prop_npcs) > 0 and float(jo.loss_prop_score) > 0
    check_grads(tm, grads)
    check_stats(tm, new_bs)


@pytest.mark.parametrize("bad", ["nbr_dtype", "valid_dtype", "shape", "cpu"])
def test_ccl_kernel_wrapper_rejects_bad_inputs(bad):
    """The kernel's wrapper checks types, shapes and the device before any
    build or launch."""
    from gapartnet_tpu_torch.ops import ccl

    nbr, valid = torch.full((8, 4), -1, dtype=torch.int32), torch.ones(8, dtype=torch.bool)
    args = {"nbr_dtype": (nbr.long(), valid), "valid_dtype": (nbr, valid.int()),
            "shape": (nbr, valid[:5]), "cpu": (nbr, valid)}[bad]
    with pytest.raises(TypeError if bad.endswith("dtype") else ValueError):
        ccl.connected_components_kernel(*args)


# the 40-node directed chain: fixpoint after 3 iterations, found by a 4th
CHAIN_ITERS = ((1, 1), (2, 2), (4, 4), (64, 4))
CARD_CCL_GRAPHS = (["cloud_k50", "cloud_k300", "no_valid", "chains_3001_64", "chains_3001_200",
                    "big_chains", "big_clouds"]
                   + [f"chain40_{m}" for m, _ in CHAIN_ITERS])
# above the 28,928 nodes whose two label buffers fit an H100 block's 227 KB
# of shared memory: the kernel keeps them in device scratch
BIG_N = 30000


@functools.lru_cache(maxsize=None)
def _card_ball_query(k):
    """The card test's labelled cloud at the bench's density, N = 20000:
    (xyz, sem, valid) and its CPU neighbour lists and counts at K = k."""
    rng = np.random.RandomState(0)
    n = 20000
    xyz = (rng.rand(n, 3) * 0.5).astype(np.float32)
    sem = rng.randint(0, 4, n).astype(np.int32)
    args = tuple(torch.from_numpy(a) for a in (xyz, sem, sem > 0))
    return args, ball_query_single(*args, RADIUS, k)


def _card_ccl_graph(name):
    """One graph of CARD_CCL_GRAPHS, built on the CPU: (nbr, valid,
    max_iters, the iterations it takes or None)."""
    if name.startswith("cloud_k"):
        args, (nbr, _) = _card_ball_query(int(name[len("cloud_k"):]))
        return nbr, args[2], 64, None
    if name == "no_valid":
        # every row empty, every node its own label
        (xyz, sem, _), _ = _card_ball_query(50)
        none = torch.zeros(len(sem), dtype=torch.bool)
        return ball_query_single(xyz, sem, none, RADIUS, 50)[0], none, 64, 1
    if name.startswith("chains_3001_"):
        # N no multiple of the block's 1024 threads; the cap binds at 64
        nbr, ok = _chains(n=3001)
        return torch.from_numpy(nbr), torch.from_numpy(ok), int(name.rsplit("_", 1)[1]), None
    if name == "big_chains":
        nbr, ok = _chains(n=BIG_N)
        return torch.from_numpy(nbr), torch.from_numpy(ok), 64, None
    if name == "big_clouds":
        # the K = 50 cloud twice over, its second copy's indices moved by N
        args, (nbr, _) = _card_ball_query(50)
        n = nbr.shape[0]
        return (torch.cat([nbr, torch.where(nbr >= 0, nbr + n, nbr)]),
                torch.cat([args[2], args[2]]), 64, None)
    max_iters = int(name[len("chain40_"):])
    chain = torch.full((40, 2), -1, dtype=torch.int32)
    chain[:-1, 0] = torch.arange(1, 40, dtype=torch.int32)
    return chain, torch.ones(40, dtype=torch.bool), max_iters, dict(CHAIN_ITERS)[max_iters]


@pytest.mark.parametrize("name", CARD_CCL_GRAPHS)
def test_ccl_card_graphs_match_jax(name):
    """The graphs the card test holds the kernel to (against the plain
    loop) are held here, on the same inputs, to the JAX CCL: the plain
    loop's labels equal JAX's.  Each row lists its neighbours first, then
    only -1, which is what the kernel relies on (ops/ccl.py)."""
    import jax.numpy as jnp

    from gapartnet_tpu.ops.ccl import connected_components_single as jax_ccl
    from gapartnet_tpu_torch.ops import ccl
    from gapartnet_tpu_torch.utils import profiling

    nbr, valid, max_iters, iterations = _card_ccl_graph(name)
    listed = nbr >= 0
    assert bool((listed[:, 1:] <= listed[:, :-1]).all()), "a -1 before a listed neighbour"
    want = np.asarray(jax_ccl(jnp.asarray(nbr.numpy()), jnp.asarray(valid.numpy()),
                              max_iters=max_iters))
    with profiling.record() as rec:
        got, _ = ccl.connected_components_reference(nbr, valid, max_iters)
    np.testing.assert_array_equal(got.numpy(), want)
    if iterations is not None:
        assert rec.counts["ccl_exact_iterations"] == iterations


def _card_ccl_matches(nbr, valid, max_iters=64):
    """The CCL of CPU tensors `nbr`, `valid` on the card (one kernel launch,
    no host sync) against the plain loop on the CPU: labels, the flag, and
    the counters of iterations and flags, exactly.  Returns the iterations."""
    from gapartnet_tpu_torch.ops import ccl
    from gapartnet_tpu_torch.utils import profiling

    with profiling.record() as want_rec:
        want, want_flag = ccl.connected_components_reference(nbr, valid, max_iters)
    with profiling.record() as rec:
        got, flag = connected_components_single(nbr.cuda(), valid.cuda(), max_iters)
        torch.cuda.synchronize()
    assert rec.counts["ccl_exact_launches"] == 1
    assert "sync:ccl_exact_converged" not in rec.summary()
    assert flag.shape == () and flag.dtype == torch.int32 and flag.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert int(flag) == int(want_flag) == want_rec.counts["ccl_exact_unconverged"]
    for name in ("ccl_exact_iterations", "ccl_exact_unconverged"):
        assert rec.counts[name] == want_rec.counts[name], name
    return rec.counts["ccl_exact_iterations"]


@pytest.mark.cuda
def test_card_ball_query_and_ccl_match_cpu():
    """At N = 20000 on a labelled cloud at the bench's density (both K
    caps): the card's neighbour lists and counts equal the CPU's, and the
    CCL kernel (one launch a call, no host sync) gives the plain loop's
    labels, iteration count and flag; so it does on every graph of
    CARD_CCL_GRAPHS: a directed chain cut off at 1, 2, 4 and 64
    iterations, a graph with no valid node, chains whose N is no multiple
    of the block, and graphs too large for the shared-memory plan.
    test_ccl_card_graphs_match_jax holds the plain loop to JAX on the same
    graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for k in (50, 300):
        args, (want_idx, want_cnt) = _card_ball_query(k)
        got_idx, got_cnt = ball_query_single(*[a.cuda() for a in args], RADIUS, k)
        np.testing.assert_array_equal(got_idx.cpu().numpy(), want_idx.numpy())
        np.testing.assert_array_equal(got_cnt.cpu().numpy(), want_cnt.numpy())
    for name in CARD_CCL_GRAPHS:
        nbr, valid, max_iters, iterations = _card_ccl_graph(name)
        got = _card_ccl_matches(nbr, valid, max_iters)
        if name.startswith("cloud") or name == "big_clouds":
            assert got > 2, name
        if iterations is not None:
            assert got == iterations, name
