"""The PointNet backbone and the PointNet++ library: the port against the
JAX package, JAX weights carried across by params_from_jax.

  * PointNetSegBackbone in eval (random running statistics) and in train
    (outputs and updated statistics), 1e-4: at B = 1, where the
    transformers' fc BatchNorms see one row, exactly that; at B = 2 plus
    twice what parameter probes of +-1e-6 move them (chip_smoke.py's
    allowance: the fc BatchNorms' E[x^2] - mean^2 over two rows amplifies
    rounding); padded points change nothing and come out zero;
  * SMALL_CFG with `backbone_type="PointNet"`: an eval forward (integers
    exactly, floats 1e-4) and one train step (integers exactly; losses,
    gradients and statistics as tests/test_torch_port_train.py holds them
    plus the probes' allowance), and the trainer's metric names for it
    against the JAX trainer's;
  * every function of ops/pointnet2.py (knn with tied distances, first-hit
    padding), and SetAbstraction / FeaturePropagation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapartnet_tpu.models import pointnet as jpn
from gapartnet_tpu.models import pointnet2_modules as jp2m
from gapartnet_tpu.ops import pointnet2 as jp2
from gapartnet_tpu_torch.models import pointnet as tpn
from gapartnet_tpu_torch.models import pointnet2_modules as tp2m
from gapartnet_tpu_torch.ops import pointnet2 as tp2
from gapartnet_tpu_torch.weights import init_weights, params_from_jax
from tests.test_torch_port_train import (
    LOSS_TOL,
    LOSSES,
    _random_stats,
    jax_jitter,
    jax_step,
    port_step,
    small_setup,
)

TOL = 1e-4
# the probes of chip_smoke.py: every parameter moved by +-PERTURB (relative,
# seeded normal noise); a rounding-sensitive output may differ from the JAX
# package's by KINK_FACTOR times their largest move on top of TOL
PERTURB = 1e-6
PROBES = ((11, 1.0), (11, -1.0), (12, 1.0), (12, -1.0))
KINK_FACTOR = 2.0


def _points(seed, b, n, valid):
    rng = np.random.RandomState(seed)
    pts = rng.rand(b, n, 6).astype(np.float32)
    mask = np.zeros((b, n), bool)
    mask[:, :valid] = True
    return pts, mask


def _carry(module, variables):
    module.load_state_dict(params_from_jax(variables), strict=True)
    return module


def _backbone_pair(fea=16, seed=0):
    pts, mask = _points(seed, 2, 96, 80)
    jm = jpn.PointNetSegBackbone(fea)
    v = jax.jit(lambda p, m: jm.init(jax.random.PRNGKey(seed), p, m, train=False))(
        jnp.asarray(pts), jnp.asarray(mask))
    v = jax.tree_util.tree_map(np.asarray, v)
    # random fc3 weights too (the init's zeros would hide the transforms)
    rng = np.random.RandomState(seed + 1)
    for stn in ("stn", "fstn"):
        fc3 = v["params"]["feat"][stn]["fc3"]
        fc3["kernel"] = (rng.randn(*fc3["kernel"].shape) * 0.01).astype(np.float32)
    v = {"params": v["params"], "batch_stats": _random_stats(v["batch_stats"], rng)}
    return jm, v, _carry(tpn.PointNetSegBackbone(fea), v)


def test_backbone_eval_matches_and_respects_mask():
    jm, v, tm = _backbone_pair()
    pts, mask = _points(0, 2, 96, 80)
    want = np.asarray(jax.jit(lambda v, p, m: jm.apply(v, p, m, train=False))(
        v, jnp.asarray(pts), jnp.asarray(mask)))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
        garbage = pts.copy()
        garbage[:, 80:] = 99.0
        again = tm(torch.from_numpy(garbage), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got[:, 80:] == 0).all() and np.abs(got[:, :80]).max() > 0
    np.testing.assert_array_equal(again, got)


def _perturbed(module, seed, sign):
    """`module` with every parameter p moved to p * (1 + sign * PERTURB *
    N(0, 1)), the noise drawn from `seed` (chip_smoke.py's probes)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.mul_(1 + sign * PERTURB * torch.randn(p.shape, generator=gen))
    return module


def _within(name, got, want, moves):
    """max|got - want| <= TOL * max|want| + KINK_FACTOR * the probes'
    largest move of the same tensor."""
    err = float(np.abs(got - want).max())
    allow = TOL * max(float(np.abs(want).max()), 1e-30) + KINK_FACTOR * max(moves, default=0.0)
    assert err <= allow, f"{name}: max|d| {err:.3e} > {allow:.3e}"


@pytest.mark.parametrize("b", [2, 1])
def test_backbone_train_matches(b):
    """B = 1: the fc BatchNorms' one row has variance exactly zero, and the
    outputs and statistics hold to 1e-4.  B = 2: their one-pass E[x^2] -
    mean^2 over two rows cancels most digits of the float32 inputs, which
    already differ by an ulp (sums in another order), so the outputs are
    held to 1e-4 plus twice what the probes move them."""
    pts, mask = _points(b, b, 96, 70)

    def jf(params, stats, p, m):
        out, mut = jm.apply({"params": params, "batch_stats": stats}, p, m, train=True,
                            mutable=["batch_stats"])
        return out, mut["batch_stats"]

    jm, v, tm = _backbone_pair(seed=b)
    want, new_bs = jax.jit(jf)(v["params"], v["batch_stats"], jnp.asarray(pts), jnp.asarray(mask))
    want = np.asarray(want)
    want_sd = params_from_jax({"params": {}, "batch_stats": jax.tree_util.tree_map(
        np.asarray, new_bs)})

    def run(module):
        module.train()
        with torch.no_grad():
            out = module(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
        return out, {k: t.numpy() for k, t in module.state_dict().items()}

    got, sd = run(tm)
    probes = [] if b == 1 else [run(_perturbed(_backbone_pair(seed=b)[2], seed, sign))
                                for seed, sign in PROBES]
    _within("output", got, want, [float(np.abs(o - got).max()) for o, _ in probes])
    assert (got[:, 70:] == 0).all()
    for name, w in want_sd.items():
        _within(name, sd[name], w.numpy(), [float(np.abs(p[name] - sd[name]).max())
                                            for _, p in probes])


def test_init_weights_starts_from_identity_transforms():
    tm = init_weights(tpn.PointNetSegBackbone(8), torch.Generator().manual_seed(0))
    for stn in (tm.feat.stn, tm.feat.fstn):
        assert (stn.fc3.weight == 0).all() and (stn.fc3.bias == 0).all()
    pts, mask = _points(0, 1, 32, 32)
    tm.eval()
    with torch.no_grad():
        trans = tm.feat.stn(torch.from_numpy(pts), torch.from_numpy(mask))
    torch.testing.assert_close(trans[0], torch.eye(3), rtol=0, atol=0)


@pytest.fixture(scope="module")
def model_setup():
    return small_setup(backbone_type="PointNet")


def _port_model(variables):
    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.models.gapartnet import GAPartNet
    from tests.test_torch_port_train import SMALL

    return _carry(GAPartNet(GAPartNetConfig(**SMALL, backbone_type="PointNet")), variables)


def test_pointnet_model_eval_forward_matches(model_setup):
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
    assert set(to.counters) == set(jo.counters) and "backbone_voxels_dropped" not in to.counters
    for k, v in jo.counters.items():
        np.testing.assert_array_equal(to.counters[k].numpy(), np.asarray(v), err_msg=k)
    for name in ("sem_logits", "offset_preds", "pc_features", "score_logits", "npcs_preds"):
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_pointnet_model_train_step_matches(model_setup):
    """Integers exactly; losses and gradients as test_torch_port_train.py
    holds them plus twice what the probes move them.  The probes' term
    covers two places where rounding alone moves the step: the transformers'
    fc BatchNorms (two rows, see test_backbone_train_matches), and the
    branch that feeds only the global feature, whose gradient the masked
    BatchNorm after it all but cancels (exactly, at B = 1)."""
    jm, variables, jbatch, tbatch, sem, off = model_setup
    flags = dict(do_cluster=True, do_score=True, do_npcs=True)
    key = jax.random.PRNGKey(3)
    jitter = jax_jitter(jm, variables, jbatch, key)
    jo, grads, new_bs = jax_step(jm, variables, jbatch, key, flags, sem, off)
    tm = _port_model(variables)
    to = port_step(tm, tbatch, jitter, flags, sem, off)
    probes = []
    for seed, sign in PROBES:
        tp = _perturbed(_port_model(variables), seed, sign)
        probes.append((tp, port_step(tp, tbatch, jitter, flags, sem, off)))
    for f in jo.proposals._fields:
        np.testing.assert_array_equal(getattr(to.proposals, f).numpy(),
                                      np.asarray(getattr(jo.proposals, f)), err_msg=f)
    np.testing.assert_array_equal(to.npcs_valid.numpy(), np.asarray(jo.npcs_valid))
    for k in LOSSES:
        got = float(getattr(to, k).detach())
        moves = [abs(float(getattr(po, k).detach()) - got) for _, po in probes]
        want = float(getattr(jo, k))
        assert abs(got - want) <= LOSS_TOL * max(abs(want), 1.0) + KINK_FACTOR * max(moves), k
    assert float(jo.loss_prop_npcs) > 0 and float(jo.loss_prop_score) > 0
    want_g = params_from_jax({"params": grads})
    got_g = dict(tm.named_parameters())
    top = max(float(w.abs().max()) for w in want_g.values())
    for name, w in want_g.items():
        g = got_g[name].grad
        own = max(float((dict(tp.named_parameters())[name].grad - g).abs().max())
                  for tp, _ in probes)
        scale = max(float(w.abs().max()), 1e-4 * top)
        err = float((g - w).abs().max())
        assert err <= 1e-4 * scale + KINK_FACTOR * own, (
            f"{name}: max|d| {err:.3e} > 1e-4 * {scale:.3e} + {KINK_FACTOR} * {own:.3e}")
    want_sd = params_from_jax({"params": {}, "batch_stats": new_bs})
    sd = tm.state_dict()
    for name, w in want_sd.items():
        own = max(float((tp.state_dict()[name] - sd[name]).abs().max()) for tp, _ in probes)
        _within(name, sd[name].numpy(), w.numpy(), [own])


@pytest.mark.parametrize("do_instance", [False, True])
def test_pointnet_metric_names_equal_jax(do_instance):
    """The trainer's names for a PointNet model: no backbone counter, as
    the JAX trainer logs them."""
    from gapartnet_tpu.data.synthetic import synthetic_batch
    from gapartnet_tpu.models.gapartnet import GAPartNet as JaxModel
    from gapartnet_tpu.models.gapartnet import GAPartNetConfig as JaxConfig
    from gapartnet_tpu.structures import PointCloudBatch as JaxBatch
    from gapartnet_tpu.train import config as jconfig
    from gapartnet_tpu.train import loop as jloop
    from gapartnet_tpu.train import trainer as jtrainer
    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.train import config as tconfig
    from gapartnet_tpu_torch.train import trainer as ttrainer

    tiny = dict(channels=(8, 16), max_points=128, max_proposals=8, max_instances=8,
                level_capacity_divisors=(1, 2), backbone_type="PointNet")
    jm = JaxModel(JaxConfig(**tiny))
    cfg_j = jconfig.Config(model=jm.cfg, data=jconfig.DataConfig(),
                           trainer=jconfig.TrainerConfig())
    d = synthetic_batch(np.random.RandomState(0), batch_size=2, num_points=128, max_instances=8)
    ids = d.pop("pc_ids")
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in d.items()}, pc_ids=ids)
    variables = jax.eval_shape(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0), "proposal_jitter": jax.random.PRNGKey(1)},
        b, train=False, do_cluster=True, do_score=True, do_npcs=True), jbatch)
    state = jloop.TrainState(variables["params"], variables["batch_stats"], None, 0)
    want = jtrainer._expected_eval_keys(
        jtrainer.make_reduced_eval_step(jm, cfg_j, do_instance), state, cfg_j, do_instance)
    cfg_t = tconfig.Config(model=GAPartNetConfig(**tiny), data=tconfig.DataConfig(),
                           trainer=tconfig.TrainerConfig())
    assert ttrainer.eval_metric_names(cfg_t, do_instance) == want
    names = ttrainer.train_metric_names(do_instance, "PointNet")
    assert not any("backbone_voxels_dropped" in k for k in names)
    assert "train_counters/dropped_proposals" in names if do_instance else True


def test_gather_and_group():
    rng = np.random.RandomState(0)
    pts = rng.rand(2, 50, 3).astype(np.float32)
    idx = rng.randint(0, 50, (2, 10)).astype(np.int32)
    np.testing.assert_array_equal(tp2.gather_points(torch.from_numpy(pts), torch.from_numpy(idx)),
                                  np.asarray(jp2.gather_points(jnp.asarray(pts), jnp.asarray(idx))))
    gidx = rng.randint(0, 50, (7, 4)).astype(np.int32)
    np.testing.assert_array_equal(tp2.group_points(torch.from_numpy(pts[0]), torch.from_numpy(gidx)),
                                  np.asarray(jp2.group_points(jnp.asarray(pts[0]), jnp.asarray(gidx))))


@pytest.mark.parametrize("k,ties", [(4, False), (3, True), (16, True)])
def test_knn_matches(k, ties):
    """Tied distances (duplicated points and a lattice) come lowest index
    first, as lax.top_k returns them."""
    rng = np.random.RandomState(k)
    if ties:
        base = (np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3)
                * 0.1).astype(np.float32)
        pts = np.concatenate([base, base[::-1], base[:9]])            # every point twice or more
        q = base[rng.randint(0, len(base), 20)] + np.float32(0.05)
    else:
        pts = rng.rand(100, 3).astype(np.float32)
        q = rng.rand(20, 3).astype(np.float32)
    wd, wi = jp2.knn(jnp.asarray(q), jnp.asarray(pts), k)
    gd, gi = tp2.knn(torch.from_numpy(q), torch.from_numpy(pts), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6, atol=1e-7)
    if ties:
        d = np.asarray(wd)
        assert (d[:, 1:] == d[:, :-1]).any()                           # ties were there
    wd3, wi3 = jp2.three_nn(jnp.asarray(q), jnp.asarray(pts))
    gd3, gi3 = tp2.three_nn(torch.from_numpy(q), torch.from_numpy(pts))
    np.testing.assert_array_equal(gi3.numpy(), np.asarray(wi3))


def test_three_interpolate_and_weights():
    rng = np.random.RandomState(1)
    feats = rng.rand(30, 8).astype(np.float32)
    idx = rng.randint(0, 30, (10, 3)).astype(np.int32)
    dists = (rng.rand(10, 3) * 0.1).astype(np.float32)
    dists[0, 0] = 0.0
    ww = np.asarray(jp2.interpolation_weights(jnp.asarray(dists)))
    tw = tp2.interpolation_weights(torch.from_numpy(dists)).numpy()
    np.testing.assert_allclose(tw, ww, rtol=1e-6, atol=1e-7)
    want = np.asarray(jp2.three_interpolate(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(ww)))
    got = tp2.three_interpolate(torch.from_numpy(feats), torch.from_numpy(idx),
                                torch.from_numpy(ww)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,nsample", [(3, 4), (200, 8), (200, 64)])
def test_ball_query_simple_matches(n, nsample):
    """First-hit padding; no hit gives 0; fewer points than slots."""
    rng = np.random.RandomState(n + nsample)
    if n == 3:
        pts = np.array([[0, 0, 0], [0.01, 0, 0], [5, 5, 5]], np.float32)
        q = np.array([[0, 0, 0], [9, 9, 9]], np.float32)
    else:
        pts = rng.rand(n, 3).astype(np.float32)
        q = rng.rand(30, 3).astype(np.float32)
    want = np.asarray(jp2.ball_query_simple(jnp.asarray(q), jnp.asarray(pts), 0.2, nsample))
    got = tp2.ball_query_simple(torch.from_numpy(q), torch.from_numpy(pts), 0.2, nsample)
    np.testing.assert_array_equal(got.numpy(), want)
    if n == 3:
        np.testing.assert_array_equal(want, [[0, 1, 0, 0], [0, 0, 0, 0]])


def test_set_abstraction_and_feature_propagation_match():
    rng = np.random.RandomState(2)
    xyz = rng.rand(2, 64, 3).astype(np.float32)
    feats = rng.rand(2, 64, 8).astype(np.float32)
    sa = jp2m.SetAbstraction(npoint=16, radius=0.3, nsample=8, mlp=(16, 32))
    v = sa.init(jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(feats), train=False)
    v = {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
         "batch_stats": _random_stats(jax.tree_util.tree_map(np.asarray, v["batch_stats"]), rng)}
    tsa = _carry(tp2m.SetAbstraction(16, 0.3, 8, (16, 32), in_channels=8), v)
    for train in (False, True):
        (wx, wf), _ = sa.apply(v, jnp.asarray(xyz), jnp.asarray(feats), train=train,
                               mutable=["batch_stats"])
        tsa.train(train)
        with torch.no_grad():
            gx, gf = tsa(torch.from_numpy(xyz), torch.from_numpy(feats))
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=TOL, atol=TOL)

    fp = jp2m.FeaturePropagation(mlp=(24,))
    v2 = fp.init(jax.random.PRNGKey(1), jnp.asarray(xyz), wx, jnp.asarray(feats), wf, train=False)
    v2 = {"params": jax.tree_util.tree_map(np.asarray, v2["params"]),
          "batch_stats": _random_stats(jax.tree_util.tree_map(np.asarray, v2["batch_stats"]), rng)}
    tfp = _carry(tp2m.FeaturePropagation((24,), in_channels=32 + 8), v2).eval()
    want = np.asarray(fp.apply(v2, jnp.asarray(xyz), wx, jnp.asarray(feats), wf, train=False))
    with torch.no_grad():
        got = tfp(torch.from_numpy(xyz), gx, torch.from_numpy(feats), gf).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert got.shape == (2, 64, 24)
