"""The training slice: one train step of the port against the JAX package.

SMALL_CFG of tests/test_model_forward.py, B = 2, labelled synthetic clouds,
the JAX weights carried over by params_from_jax with random (non-trivial)
batch statistics, all three stages on, under the clustering overrides.
The cube jitter is the JAX model's own draw, recovered from the bound
module's first `make_rng("proposal_jitter")`; the proposal-grid keys then
match exactly, which shows the draw was the same.  Compared:

  * integer outputs: exactly;
  * the five losses: rtol = atol = 1e-4 (float32 through every layer, sums
    in another order);
  * every parameter's gradient against `jax.value_and_grad` of the loss of
    `make_train_step` (train/loop.py:108-120): max|d| <= 1e-4 * max|ref|
    per tensor, max|ref| floored at 1e-4 of the model's largest gradient
    (a gradient that is zero up to rounding has no scale of its own);
  * the updated batch statistics: rtol = atol = 1e-5;
  * Adam against optax.adam on shared numpy gradients, 3 steps: 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gapartnet_tpu.data.synthetic import synthetic_batch
from gapartnet_tpu.models.gapartnet import GAPartNet as JaxModel
from gapartnet_tpu.models.gapartnet import GAPartNetConfig as JaxConfig
from gapartnet_tpu.structures import PointCloudBatch as JaxBatch
from gapartnet_tpu.train import loop as jloop
from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.models.gapartnet import GAPartNet
from gapartnet_tpu_torch.structures import PointCloudBatch
from gapartnet_tpu_torch.train import loop as tloop
from gapartnet_tpu_torch.weights import params_from_jax

LOSS_TOL = 1e-4
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-4
FLAGSHIP_GRAD_RTOL = 1e-3
STATS_TOL = 1e-5
ADAM_TOL = 1e-6
SMALL = dict(
    channels=(8, 16, 24), block_repeat=2, max_points=512, max_proposals=32,
    max_instances=8, level_capacity_divisors=(1, 2, 4),
    min_num_points_per_proposal=3, ball_query_radius=0.1,
    max_num_points_per_query=16, max_num_points_per_query_shift=32,
)
LOSSES = ("loss_sem_seg", "loss_offset_dist", "loss_offset_dir", "loss_prop_score",
          "loss_prop_npcs")


def _random_stats(tree, rng):
    if set(tree) == {"mean", "var"}:
        c = np.asarray(tree["mean"]).shape[0]
        return {"mean": (rng.randn(c) * 0.1).astype(np.float32),
                "var": (rng.rand(c) + 0.5).astype(np.float32)}
    return {k: _random_stats(v, rng) for k, v in tree.items()}


def jax_jitter(jm, variables, batch, key) -> np.ndarray:
    """The (2, 3) jitter the JAX model draws under rngs={"proposal_jitter": key}."""
    bound = jm.bind(variables, rngs={"proposal_jitter": key})
    return np.asarray(jax.random.uniform(bound.make_rng("proposal_jitter"), (2, 3)))


def carry(jm, jcfg, jbatch, variables, tm):
    """{"params", "batch_stats"} of the JAX model filled from the port's
    state_dict (the inverse of params_from_jax)."""
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

    return {c: fill(jax.tree_util.tree_map(np.asarray, template[c]), "", c)
            for c in ("params", "batch_stats")}


def jax_step(jm, variables, jbatch, key, flags, sem, off):
    """value_and_grad of make_train_step's loss: (out, grads, new batch_stats)."""
    def loss_fn(params, batch_stats, b, k, cs, co):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": batch_stats}, b, train=True, **flags,
            rngs={"proposal_jitter": k}, mutable=["batch_stats"],
            cluster_sem_override=cs, cluster_offset_override=co)
        return out.total_loss, (out, mutated["batch_stats"])

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (out, new_bs)), grads = fn(variables["params"], variables["batch_stats"], jbatch, key,
                                   jnp.asarray(sem), jnp.asarray(off))
    return out, jax.tree_util.tree_map(np.asarray, grads), jax.tree_util.tree_map(np.asarray, new_bs)


def port_step(tm, tbatch, jitter, flags, sem, off):
    tm.train()
    tm.zero_grad(set_to_none=True)
    out = tm(tbatch, **flags, cluster_sem_override=torch.from_numpy(sem),
             cluster_offset_override=torch.from_numpy(off), jitter=torch.tensor(jitter))
    out.total_loss.backward()
    return out


def check_grads(tm, grads, rtol=GRAD_RTOL):
    """Per tensor: max|d| <= GRAD_RTOL * max|ref|, with max|ref| floored at
    GRAD_FLOOR of the largest gradient in the model: a gradient that is
    zero up to rounding (the bias of a Linear that a BatchNorm follows) has
    no scale of its own."""
    want = params_from_jax({"params": grads})
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    top = max(float(w.abs().max()) for w in want.values())
    bad = []
    for name, w in want.items():
        g = got[name].grad
        g = torch.zeros_like(got[name]) if g is None else g
        scale = max(float(w.abs().max()), GRAD_FLOOR * top)
        err = float((g - w).abs().max())
        if not err <= rtol * scale:
            bad.append((err / scale, f"{name}: max|d| {err:.3e} > {rtol} * {scale:.3e}"))
    assert not bad, [m for _, m in sorted(bad, reverse=True)]


def check_stats(tm, new_bs):
    want = params_from_jax({"params": {}, "batch_stats": new_bs})
    sd = tm.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=STATS_TOL, atol=STATS_TOL,
                                   err_msg=name)


def small_setup(batch_size=2, **over):
    """(JAX model, its variables with random batch statistics, JAX batch,
    port batch, cluster_sem, cluster_off) at SMALL with `over` applied."""
    d = synthetic_batch(np.random.RandomState(0), batch_size=batch_size, num_points=512,
                        num_parts=4, max_instances=8)
    ids = d.pop("pc_ids")
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in d.items()}, pc_ids=ids)
    tbatch = PointCloudBatch.from_numpy(d, "cpu")
    jm = JaxModel(JaxConfig(**SMALL, **over))
    variables = jax.jit(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0), "proposal_jitter": jax.random.PRNGKey(1)},
        b, train=False, do_cluster=True, do_score=True, do_npcs=True))(jbatch)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {"params": variables["params"],
                 "batch_stats": _random_stats(variables["batch_stats"], np.random.RandomState(5))}
    inst = d["instance_labels"]
    off = np.where((inst >= 0)[..., None],
                   d["instance_regions"][..., :3] - d["points"][..., :3], 0).astype(np.float32)
    return jm, variables, jbatch, tbatch, d["sem_labels"].astype(np.int32), off


@pytest.fixture(scope="module")
def setup():
    return small_setup()


def _port_model(variables):
    tm = GAPartNet(GAPartNetConfig(**SMALL))
    tm.load_state_dict(params_from_jax(variables), strict=True)
    return tm


def test_train_step_matches(setup):
    jm, variables, jbatch, tbatch, sem, off = setup
    flags = dict(do_cluster=True, do_score=True, do_npcs=True)
    key = jax.random.PRNGKey(3)
    jitter = jax_jitter(jm, variables, jbatch, key)
    jo, grads, new_bs = jax_step(jm, variables, jbatch, key, flags, sem, off)
    tm = _port_model(variables)
    to = port_step(tm, tbatch, jitter, flags, sem, off)

    # integer outputs: exactly
    for f in jo.proposals._fields:
        np.testing.assert_array_equal(getattr(to.proposals, f).numpy(),
                                      np.asarray(getattr(jo.proposals, f)), err_msg=f)
    np.testing.assert_array_equal(to.sem_preds.numpy(), np.asarray(jo.sem_preds))
    np.testing.assert_array_equal(to.proposal_sem.numpy(), np.asarray(jo.proposal_sem))
    np.testing.assert_array_equal(to.npcs_valid.numpy(), np.asarray(jo.npcs_valid))
    assert set(to.counters) == set(jo.counters)
    for k, v in jo.counters.items():
        np.testing.assert_array_equal(to.counters[k].numpy(), np.asarray(v), err_msg=k)
    assert (np.asarray(jo.proposals.num_proposals) > 0).all()
    np.testing.assert_allclose(to.ious.numpy(), np.asarray(jo.ious), rtol=0, atol=0)
    # the proposal grid: same jitter draw, same cells, same rulebooks
    tgrid = to.proposal_grid
    pgrid = _jax_proposal_grid(jm, variables, jbatch, jitter, sem, off)
    np.testing.assert_array_equal(tgrid.levels[0].keys.numpy(), pgrid["keys"])
    np.testing.assert_array_equal(to.entry_voxel_id.numpy(), pgrid["entry_voxel_id"])
    for li, lv in enumerate(tgrid.levels):
        np.testing.assert_array_equal(lv.subm_nbr.numpy(), pgrid["nbr"][li], err_msg=f"level {li}")

    # losses and accuracies
    for k in LOSSES + ("all_accu", "pixel_accu"):
        np.testing.assert_allclose(float(getattr(to, k).detach()), float(getattr(jo, k)),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
        assert np.isfinite(float(getattr(jo, k)))
    assert float(jo.loss_prop_npcs) > 0 and float(jo.loss_prop_score) > 0

    check_grads(tm, grads)
    check_stats(tm, new_bs)


def _jax_proposal_grid(jm, variables, jbatch, jitter, sem, off):
    """The JAX sparse proposal grid under the same clustering and jitter."""
    from gapartnet_tpu.models.grouping import segmented_voxelize_single
    from gapartnet_tpu.ops.sparse_conv import build_hierarchy

    cfg = jm.cfg
    out = jax.jit(lambda v, b, cs, co: jm.apply(
        v, b, train=False, do_cluster=True, cluster_sem_override=cs,
        cluster_offset_override=co))(variables, jbatch, jnp.asarray(sem), jnp.asarray(off))
    prop = out.proposals
    ra, rb = jnp.asarray(jitter[0]), jnp.asarray(jitter[1])
    grid = jax.vmap(lambda xyz, pr: segmented_voxelize_single(
        xyz, pr, ra, rb, cfg.max_proposals, cfg.score_fullscale, cfg.score_scale
    ))(jbatch.points[..., :3], prop)
    vcap = cfg.proposal_capacities()[0]
    p = cfg.max_proposals
    pext = (1024, 32 * min(-(-p // 32), 32), 32 * (-(-p // 1024)))
    hier = build_hierarchy(grid.keys[:, :vcap], jnp.minimum(grid.num_voxels, vcap),
                           list(cfg.proposal_capacities()), extent=pext)
    evid = jnp.where(grid.entry_voxel_id < vcap, grid.entry_voxel_id, -1)
    return {"keys": np.asarray(grid.keys[:, :vcap]), "entry_voxel_id": np.asarray(evid),
            "nbr": [np.asarray(lv.subm_nbr) for lv in hier.levels]}


def test_backbone_only_gradients_match(setup):
    """do_cluster off: the backbone and the two point heads only."""
    jm, variables, jbatch, tbatch, sem, off = setup
    flags = dict(do_cluster=False, do_score=False, do_npcs=False)
    key = jax.random.PRNGKey(4)
    jo, grads, new_bs = jax_step(jm, variables, jbatch, key, flags, sem, off)
    tm = _port_model(variables)
    to = port_step(tm, tbatch, np.zeros((2, 3), np.float32), flags, sem, off)
    for k in LOSSES:
        np.testing.assert_allclose(float(getattr(to, k).detach()), float(getattr(jo, k)),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    check_grads(tm, grads, rtol=FLAGSHIP_GRAD_RTOL)
    check_stats(tm, new_bs)


def test_adam_matches_optax():
    rng = np.random.RandomState(0)
    shapes = {"a": (27, 4, 3), "b": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    tx = jloop.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = tloop.adam(tp.items(), 1e-3)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=ADAM_TOL, atol=ADAM_TOL, err_msg=k)


@pytest.mark.parametrize("epoch", [0, 5, 7, 10, 12])
def test_stage_flags_match(epoch):
    assert tloop.stage_flags(epoch, (5, 10)) == jloop.stage_flags(epoch, (5, 10))


def test_train_step_metrics(setup):
    """train_step: the metric names of the JAX loop, finite values, one
    optimizer step taken, running statistics moved."""
    jm, variables, _, tbatch, sem, off = setup
    tm = _port_model(variables)
    opt = tloop.adam(tm.named_parameters(), 1e-3)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    metrics = tloop.train_step(tm, opt, tbatch, torch.Generator().manual_seed(0), True, True,
                               True, torch.from_numpy(sem), torch.from_numpy(off))
    names = {"loss/total_loss", "all_accu", "pixel_accu"} | {f"loss/{k}" for k in LOSSES}
    assert names <= set(metrics)
    assert {k for k in metrics if k.startswith("counters/")} == {
        "counters/backbone_voxels_dropped", "counters/proposal_voxels_dropped",
        "counters/dropped_proposals", "counters/ccl_node_overflow",
        "counters/ccl_cand_truncated"}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    after = tm.state_dict()
    assert not torch.equal(after["sem_seg_head.weight"], before["sem_seg_head.weight"])
    assert not torch.equal(after["score_unet.stem_bn.running_var"],
                           before["score_unet.stem_bn.running_var"])


@pytest.mark.slow
def test_flagship_train_step_matches():
    """One train step of the flagship model on train_setup(batch_size=1).

    Seven levels over 20000 points: gradients are held to 1e-3 of max|ref|
    per tensor (the deepest backbone kernels deviate by up to 6e-4 from
    float32 reductions over 20000 rows taken in another order)."""
    from gapartnet_tpu_torch.entry import make_model, train_setup

    tcfg, tbatch, tsem, toff = train_setup(GAPartNetConfig(), batch_size=1, device="cpu")
    jcfg = JaxConfig(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)})
    jm = JaxModel(jcfg)
    jbatch = JaxBatch(**{f.name: jnp.asarray(getattr(tbatch, f.name).numpy())
                         for f in dataclasses.fields(tbatch)
                         if isinstance(getattr(tbatch, f.name), torch.Tensor)})
    tm = make_model(tcfg, "cpu", seed=0)
    variables = carry(jm, jcfg, jbatch, None, tm)
    flags = dict(do_cluster=True, do_score=True, do_npcs=True)
    key = jax.random.PRNGKey(3)
    jitter = jax_jitter(jm, variables, jbatch, key)
    sem, off = tsem.numpy(), toff.numpy()
    jo, grads, new_bs = jax_step(jm, variables, jbatch, key, flags, sem, off)
    to = port_step(tm, tbatch, jitter, flags, sem, off)
    for f in jo.proposals._fields:
        np.testing.assert_array_equal(getattr(to.proposals, f).numpy(),
                                      np.asarray(getattr(jo.proposals, f)), err_msg=f)
    for k, v in jo.counters.items():
        assert int(to.counters[k].sum()) == int(np.asarray(v).sum()) == 0, k
    for k in LOSSES:
        np.testing.assert_allclose(float(getattr(to, k).detach()), float(getattr(jo, k)),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    check_grads(tm, grads, rtol=FLAGSHIP_GRAD_RTOL)
    check_stats(tm, new_bs)
