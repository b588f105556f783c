"""The whole slice: the port's eval forward against the JAX GAPartNet.

SMALL_CFG of tests/test_model_forward.py, B = 2, the JAX weights carried
over by params_from_jax with random (non-trivial) batch statistics.  Under
the clustering overrides (ground-truth labels and offsets to instance
centres, as bench.py drives it) the integer outputs must match exactly and
the float outputs within 1e-4 (float32 through every layer, sums in
another order).  A run without overrides is compared on the head outputs.
The JAX side is jitted, as it is deployed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapartnet_tpu.data.synthetic import synthetic_batch
from gapartnet_tpu.models.gapartnet import GAPartNet as JaxModel
from gapartnet_tpu.models.gapartnet import GAPartNetConfig as JaxConfig
from gapartnet_tpu.structures import PointCloudBatch as JaxBatch
from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.models.gapartnet import GAPartNet
from gapartnet_tpu_torch.structures import PointCloudBatch
from gapartnet_tpu_torch.weights import params_from_jax

TOL = 1e-4
SMALL = dict(
    channels=(8, 16, 24), block_repeat=2, max_points=512, max_proposals=32,
    max_instances=8, level_capacity_divisors=(1, 2, 4),
    min_num_points_per_proposal=3, ball_query_radius=0.1,
    max_num_points_per_query=16, max_num_points_per_query_shift=32,
)


def _random_stats(tree, rng):
    if set(tree) == {"mean", "var"}:
        c = np.asarray(tree["mean"]).shape[0]
        return {"mean": (rng.randn(c) * 0.1).astype(np.float32),
                "var": (rng.rand(c) + 0.5).astype(np.float32)}
    return {k: _random_stats(v, rng) for k, v in tree.items()}


@pytest.fixture(scope="module")
def setup():
    d = synthetic_batch(np.random.RandomState(0), batch_size=2, num_points=512,
                        num_parts=4, max_instances=8)
    jbatch = JaxBatch(points=jnp.asarray(d["points"]), point_mask=jnp.asarray(d["point_mask"]))
    jm = JaxModel(JaxConfig(**SMALL))
    variables = jax.jit(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0), "proposal_jitter": jax.random.PRNGKey(1)},
        b, train=False, do_cluster=True, do_score=True, do_npcs=True))(jbatch)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {"params": variables["params"],
                 "batch_stats": _random_stats(variables["batch_stats"], np.random.RandomState(5))}
    tm = GAPartNet(GAPartNetConfig(**SMALL))
    tm.load_state_dict(params_from_jax(variables), strict=True)
    tm.eval()
    tbatch = PointCloudBatch(points=torch.from_numpy(d["points"]),
                             point_mask=torch.from_numpy(d["point_mask"]))
    inst = d["instance_labels"]
    off = np.where((inst >= 0)[..., None],
                   d["instance_regions"][..., :3] - d["points"][..., :3], 0).astype(np.float32)
    return jm, variables, jbatch, tm, tbatch, d["sem_labels"].astype(np.int32), off


def test_forward_matches_under_overrides(setup):
    jm, variables, jbatch, tm, tbatch, sem, off = setup

    def jf(v, b, cs, co):
        return jm.apply(v, b, train=False, do_cluster=True, do_score=True, do_npcs=True,
                        cluster_sem_override=cs, cluster_offset_override=co)

    jo = jax.jit(jf)(variables, jbatch, jnp.asarray(sem), jnp.asarray(off))
    with torch.no_grad():
        to = tm(tbatch, do_cluster=True, do_score=True, do_npcs=True,
                cluster_sem_override=torch.from_numpy(sem),
                cluster_offset_override=torch.from_numpy(off))

    # integer outputs: exactly
    for f in jo.proposals._fields:
        np.testing.assert_array_equal(getattr(to.proposals, f).numpy(),
                                      np.asarray(getattr(jo.proposals, f)), err_msg=f)
    np.testing.assert_array_equal(to.sem_preds.numpy(), np.asarray(jo.sem_preds))
    np.testing.assert_array_equal(to.proposal_sem.numpy(), np.asarray(jo.proposal_sem))
    assert set(to.counters) == set(jo.counters)
    for k, v in jo.counters.items():
        np.testing.assert_array_equal(to.counters[k].numpy(), np.asarray(v), err_msg=k)
    assert (np.asarray(jo.proposals.num_proposals) > 0).all()

    # float outputs
    for name in ("sem_logits", "offset_preds", "pc_features", "score_logits",
                 "score_preds", "npcs_preds"):
        want = np.asarray(getattr(jo, name))
        got = getattr(to, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)
        assert np.abs(want).max() > 0, name
    # outputs the slice does not produce
    assert to.ious is None and to.npcs_valid is None and to.loss_sem_seg is None


def test_forward_matches_without_overrides(setup):
    jm, variables, jbatch, tm, tbatch, _, _ = setup
    jo = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables, jbatch)
    with torch.no_grad():
        to = tm(tbatch)
    np.testing.assert_allclose(to.sem_logits.numpy(), np.asarray(jo.sem_logits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to.offset_preds.numpy(), np.asarray(jo.offset_preds), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(to.sem_preds.numpy(), np.asarray(jo.sem_preds))
    assert to.proposals is None
    np.testing.assert_array_equal(to.counters["backbone_voxels_dropped"].numpy(),
                                  np.asarray(jo.counters["backbone_voxels_dropped"]))


def test_state_dict_names_cover_the_flax_tree(setup):
    _, variables, _, tm, _, _, _ = setup
    sd = params_from_jax(variables)
    assert set(sd) == set(tm.state_dict())
    # flax Dense kernels are (in, out); nn.Linear weights are (out, in)
    np.testing.assert_array_equal(sd["sem_seg_head.weight"].numpy(),
                                  variables["params"]["sem_seg_head"]["kernel"].T)


def test_eval_only(setup):
    """The train forward returns finite losses (and moves the BN running
    statistics), and `.eval()` afterwards still gives the eval outputs of
    the same weights and statistics."""
    _, variables, _, tm, tbatch, sem, off = setup
    d = synthetic_batch(np.random.RandomState(0), batch_size=2, num_points=512,
                        num_parts=4, max_instances=8)
    labelled = PointCloudBatch.from_numpy(d, "cpu")
    with torch.no_grad():
        before = tm(tbatch, do_cluster=True, do_score=True, do_npcs=True,
                    cluster_sem_override=torch.from_numpy(sem),
                    cluster_offset_override=torch.from_numpy(off))
    model = GAPartNet(GAPartNetConfig(**SMALL))
    model.load_state_dict(params_from_jax(variables), strict=True)
    model.train()
    out = model(labelled, do_cluster=True, do_score=True, do_npcs=True,
                cluster_sem_override=torch.from_numpy(sem),
                cluster_offset_override=torch.from_numpy(off),
                jitter=torch.full((2, 3), 0.25))
    for k in ("loss_sem_seg", "loss_offset_dist", "loss_offset_dir", "loss_prop_score",
              "loss_prop_npcs"):
        assert bool(torch.isfinite(getattr(out, k))), k
    assert float(out.loss_prop_npcs.detach()) > 0 and float(out.loss_prop_score.detach()) > 0
    out.total_loss.backward()
    assert model.backbone.stem_conv.kernel.grad is not None
    moved = model.state_dict()["backbone.stem_bn.running_mean"]
    assert not torch.equal(moved, tm.state_dict()["backbone.stem_bn.running_mean"])

    # eval with the loaded statistics gives the eval outputs again
    model.load_state_dict(params_from_jax(variables), strict=True)
    model.eval()
    with torch.no_grad():
        again = model(tbatch, do_cluster=True, do_score=True, do_npcs=True,
                      cluster_sem_override=torch.from_numpy(sem),
                      cluster_offset_override=torch.from_numpy(off))
    for name in ("sem_logits", "offset_preds", "score_logits", "npcs_preds"):
        torch.testing.assert_close(getattr(again, name), getattr(before, name), rtol=0, atol=0)


@pytest.mark.slow
def test_flagship_bench_cloud_matches():
    """The flagship forward on assets/bench_cloud.npz (float32 convs)."""
    import bench
    from gapartnet_tpu_torch.entry import bench_cloud_setup, make_model

    jcfg, jbatch, jsem, joff = bench.real_cloud_setup(JaxConfig(), "assets/bench_cloud.npz", 1)
    tcfg, tbatch, tsem, toff = bench_cloud_setup(GAPartNetConfig(), device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tm = make_model(tcfg, "cpu", seed=0)
    jm = JaxModel(jcfg)
    # carry the port's seeded weights into the JAX model through the flax tree
    template = jax.jit(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0), "proposal_jitter": jax.random.PRNGKey(1)},
        b, train=False, do_cluster=True, do_score=True, do_npcs=True))(jbatch)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}

    def fill(tree, prefix, coll):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = fill(v, path, coll)
            elif coll == "batch_stats":
                out[k] = sd[f"{prefix}.running_{k}"]
            elif k == "kernel" and np.ndim(v) == 2:
                out[k] = sd[f"{prefix}.weight"].T
            elif k == "scale":
                out[k] = sd[f"{prefix}.weight"]
            else:
                out[k] = sd[path]
        return out

    variables = {c: fill(jax.tree_util.tree_map(np.asarray, template[c]), "", c)
                 for c in ("params", "batch_stats")}
    jo = jax.jit(lambda v, b, cs, co: jm.apply(
        v, b, train=False, do_cluster=True, do_score=True, do_npcs=True,
        cluster_sem_override=cs, cluster_offset_override=co))(variables, jbatch, jsem, joff)
    with torch.no_grad():
        to = tm(tbatch, do_cluster=True, do_score=True, do_npcs=True,
                cluster_sem_override=tsem, cluster_offset_override=toff)
    for f in jo.proposals._fields:
        np.testing.assert_array_equal(getattr(to.proposals, f).numpy(),
                                      np.asarray(getattr(jo.proposals, f)), err_msg=f)
    for k, v in jo.counters.items():
        assert int(to.counters[k].sum()) == int(np.asarray(v).sum()) == 0, k
    for name in ("sem_logits", "offset_preds", "score_preds", "npcs_preds"):
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_sparse_proposal_path_matches_in_eval(setup):
    """proposal_conv_impl="sparse" at eval: the proposal UNets run sparse
    through the submanifold convs over the proposal voxels (cube centre
    placement); the JAX model's outputs on the same path."""
    jm, variables, jbatch, _, tbatch, sem, off = setup
    jm_sparse = JaxModel(dataclasses.replace(jm.cfg, proposal_conv_impl="sparse"))
    jo = jax.jit(lambda v, b, cs, co: jm_sparse.apply(
        v, b, train=False, do_cluster=True, do_score=True, do_npcs=True,
        cluster_sem_override=cs, cluster_offset_override=co))(
            variables, jbatch, jnp.asarray(sem), jnp.asarray(off))
    tm = GAPartNet(GAPartNetConfig(**SMALL, proposal_conv_impl="sparse"))
    tm.load_state_dict(params_from_jax(variables), strict=True)
    tm.eval()
    with torch.no_grad():
        to = tm(tbatch, do_cluster=True, do_score=True, do_npcs=True,
                cluster_sem_override=torch.from_numpy(sem),
                cluster_offset_override=torch.from_numpy(off))
    assert to.entry_site is None and to.proposal_grid is not None
    assert set(to.counters) == set(jo.counters)
    for name in ("score_logits", "npcs_preds"):
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)
