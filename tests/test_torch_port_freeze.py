"""Frozen modules and Adam against the JAX package.

  * The frozen-trunk train step (`train_step(freeze_prefixes=...)`) against
    `make_train_step(freeze_prefixes=...)` from shared weights and the JAX
    model's own jitter draw, clustering on the predicted labels: metrics
    within 1e-4, updated parameters within 1e-4, batch statistics within
    1e-5, and every frozen parameter and running statistic bitwise
    unchanged.  (The trunk is frozen in both cases: a trainable Linear bias
    that a BatchNorm follows has a gradient of rounding size, whose sign,
    and so its first Adam step of +-lr, is arbitrary.)  Freezing
    `score_unet` too checks that its BatchNorms keep
    normalizing with batch statistics (JAX's frozen_bn reaches only the
    backbone and offset_bn) while its running statistics are restored.
  * Adam over three steps where a head gets no gradient in the third,
    against optax (which sees a zero gradient there): 1e-6.
"""

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
from tests.test_torch_port_train import SMALL, _random_stats, jax_jitter

TRUNK = ("backbone", "sem_seg_head", "offset_mlp0", "offset_bn", "offset_mlp1")
PARAM_TOL = 1e-4
METRIC_TOL = 1e-4
STATS_TOL = 1e-5
ADAM_TOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    d = synthetic_batch(np.random.RandomState(0), batch_size=2, num_points=512,
                        num_parts=4, max_instances=8)
    ids = d.pop("pc_ids")
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in d.items()}, pc_ids=ids)
    tbatch = PointCloudBatch.from_numpy(d, "cpu")
    jm = JaxModel(JaxConfig(**SMALL))
    variables = jax.jit(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0), "proposal_jitter": jax.random.PRNGKey(1)},
        b, train=False, do_cluster=True, do_score=True, do_npcs=True))(jbatch)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {"params": variables["params"],
                 "batch_stats": _random_stats(variables["batch_stats"], np.random.RandomState(5))}
    return jm, variables, jbatch, tbatch


@pytest.mark.parametrize("freeze", [TRUNK, TRUNK + ("score_unet",)])
def test_frozen_train_step_matches_jax(setup, freeze, monkeypatch):
    jm, variables, jbatch, tbatch = setup
    key = jax.random.PRNGKey(3)
    jitter = jax_jitter(jm, variables, jbatch, key)
    tx = jloop.adam(1e-3, freeze)
    state = jloop.TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                             opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    step = jloop.make_train_step(jm, tx, True, True, True, donate=False, freeze_prefixes=freeze)
    new_state, jmetrics = step(state, jbatch, key)

    tm = GAPartNet(GAPartNetConfig(**SMALL))
    tm.load_state_dict(params_from_jax(variables), strict=True)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt = tloop.adam(tm.named_parameters(), 1e-3, freeze)
    monkeypatch.setattr(tloop, "draw_jitter", lambda generator: torch.from_numpy(jitter.copy()))
    metrics = tloop.train_step(tm, opt, tbatch, torch.Generator(), True, True, True,
                               freeze_prefixes=freeze)

    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=METRIC_TOL, atol=METRIC_TOL,
                                   err_msg=k)
    assert float(jmetrics["loss/loss_prop_score"]) > 0
    want = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, new_state.params),
                            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                  new_state.batch_stats)})
    after = tm.state_dict()
    assert set(want) == set(after)
    moved = 0
    for name, w in want.items():
        frozen = tloop.top_module(name) in freeze
        if frozen:
            assert torch.equal(after[name], before[name]), f"{name} moved"
            assert torch.equal(w, before[name]), f"{name} moved in JAX"
        tol = STATS_TOL if "running_" in name else PARAM_TOL
        np.testing.assert_allclose(after[name].numpy(), w.numpy(), rtol=tol, atol=tol, err_msg=name)
        moved += not frozen and not torch.equal(after[name], before[name])
    assert moved > 0
    assert all(p.requires_grad == (tloop.top_module(n) not in freeze)
               for n, p in tm.named_parameters())
    assert len(opt.state) == sum(tloop.top_module(n) not in freeze for n, _ in tm.named_parameters())


def test_adam_with_unused_head_matches_optax():
    """Step 3 leaves the head without a gradient: optax decays its moments
    and moves it on its momentum; so must the port."""
    rng = np.random.RandomState(0)
    shapes = {"backbone": {"w": (27, 4, 3)}, "score_head": {"kernel": (5, 2), "bias": (2,)},
              "sem_seg_head": {"kernel": (3,)}}
    params = {m: {k: rng.randn(*s).astype(np.float32) for k, s in t.items()}
              for m, t in shapes.items()}
    for freeze in ((), ("sem_seg_head",)):
        tx = jloop.adam(1e-3, freeze)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        state = tx.init(jp)
        tp = {f"{m}.{k}": torch.nn.Parameter(torch.from_numpy(v.copy()))
              for m, t in params.items() for k, v in t.items()}
        opt = tloop.adam(tp.items(), 1e-3, freeze)
        for it in range(3):
            grads = {m: {k: rng.randn(*s).astype(np.float32) for k, s in t.items()}
                     for m, t in shapes.items()}
            if it == 2:
                grads["score_head"] = {k: np.zeros(s, np.float32)
                                       for k, s in shapes["score_head"].items()}
            updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
            jp = optax.apply_updates(jp, updates)
            opt.zero_grad(set_to_none=True)
            for name, p in tp.items():
                m, k = name.split(".")
                if not (it == 2 and m == "score_head"):
                    p.grad = torch.from_numpy(grads[m][k])
            tloop.optimizer_step(opt)
        for name, p in tp.items():
            m, k = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[m][k]), rtol=ADAM_TOL,
                                       atol=ADAM_TOL, err_msg=f"{name} (freeze {freeze})")
            if m in freeze:
                assert np.array_equal(p.detach().numpy(), params[m][k])
        # the unused head moved in step 3
        assert not np.allclose(np.asarray(jp["score_head"]["kernel"]), params["score_head"]["kernel"])


def test_unused_heads_keep_moving_in_train_step(setup):
    """Three train steps, the third without the proposal stages: the score
    and NPCS heads get no gradient there, yet move on their momentum, and
    every parameter's Adam step count stays at 3."""
    _, variables, _, tbatch = setup
    tm = GAPartNet(GAPartNetConfig(**SMALL))
    tm.load_state_dict(params_from_jax(variables), strict=True)
    opt = tloop.adam(tm.named_parameters(), 1e-3)
    gen = torch.Generator().manual_seed(0)
    inst = tbatch.instance_labels.numpy()
    off = torch.from_numpy(np.where((inst >= 0)[..., None], (tbatch.instance_regions[..., :3]
                                                             - tbatch.points[..., :3]).numpy(),
                                    0).astype(np.float32))
    sem = tbatch.sem_labels
    for _ in range(2):
        tloop.train_step(tm, opt, tbatch, gen, True, True, True, sem, off)
    heads = {k: v.clone() for k, v in tm.state_dict().items()
             if k.startswith(("score_head", "npcs_head"))}
    metrics = tloop.train_step(tm, opt, tbatch, gen, False, False, False)
    assert float(metrics["loss/loss_prop_score"]) == 0.0
    for k, v in heads.items():
        assert not torch.equal(tm.state_dict()[k], v), f"{k} did not move"
    assert {float(s["step"]) for s in opt.state.values()} == {3.0}
