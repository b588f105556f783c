"""eval/ap.py of the port against the JAX package's: the eval selection on
SMALL_CFG outputs (keep masks equal), batch_to_records and the AP
evaluator (equal)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapartnet_tpu.data.synthetic import synthetic_batch
from gapartnet_tpu.eval import ap as jap
from gapartnet_tpu.models.gapartnet import GAPartNetConfig as JaxConfig
from gapartnet_tpu.models.grouping import SampleProposals as JaxProposals
from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.eval import ap as tap
from gapartnet_tpu_torch.models.gapartnet import GAPartNet
from gapartnet_tpu_torch.structures import PointCloudBatch
from gapartnet_tpu_torch.weights import init_weights
from tests.test_torch_port_forward import SMALL


@pytest.fixture(scope="module")
def outputs():
    """The port's eval forward at SMALL_CFG on a labelled B = 2 batch (so
    the outputs carry IoUs against the ground truth), clustering driven by
    the sem head and, second, by the ground-truth labels."""
    d = synthetic_batch(np.random.RandomState(1), batch_size=2, num_points=512, num_parts=4,
                        max_instances=8)
    batch = PointCloudBatch.from_numpy(d, "cpu")
    model = GAPartNet(GAPartNetConfig(**SMALL))
    init_weights(model, torch.Generator().manual_seed(0)).eval()
    outs = []
    with torch.no_grad():
        for sem in (None, batch.sem_labels):
            outs.append(model(batch, do_cluster=True, do_score=True, do_npcs=True,
                              cluster_sem_override=sem))
    return outs, d["instance_sem_labels"]


def _jax_view(out):
    """The same outputs as the JAX functions read them (numpy arrays)."""
    prop = JaxProposals(*[jnp.asarray(t.numpy()) for t in out.proposals])
    return types.SimpleNamespace(
        proposals=prop, score_preds=jnp.asarray(out.score_preds.numpy()),
        sem_preds=jnp.asarray(out.sem_preds.numpy()), ious=jnp.asarray(out.ious.numpy()))


@pytest.mark.parametrize("which", [0, 1])
def test_select_and_records_match(outputs, which):
    outs, isl = outputs
    out = outs[which]
    keep = tap.select_eval_proposals(out, GAPartNetConfig(**SMALL), SMALL["max_points"])
    want = np.asarray(jap.select_eval_proposals(_jax_view(out), JaxConfig(**SMALL), SMALL["max_points"]))
    np.testing.assert_array_equal(keep.numpy(), want)
    assert keep.sum() > 0
    got = tap.batch_to_records(out, keep, torch.from_numpy(isl))
    ref = jap.batch_to_records(_jax_view(out), want, isl)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g, w)


def _records(rng, batches=4, b=2, inst=6):
    recs = []
    for _ in range(batches):
        p = rng.randint(0, 12)
        isl = np.where(rng.rand(b, inst) > 0.3, rng.randint(1, 10, (b, inst)), -1)
        recs.append((rng.rand(p).round(2), rng.randint(1, 10, p), rng.randint(0, b, p),
                     rng.rand(p, inst), isl))
    return recs


@pytest.mark.parametrize("seed", range(3))
def test_ap_evaluator_matches(seed):
    recs = _records(np.random.RandomState(seed))
    t, j = tap.APEvaluator(), jap.APEvaluator()
    for r in recs:
        t.add(*r)
        j.add(*r)
    assert t.compute_map() == j.compute_map()
    assert t.compute_map([0.25, 0.5]) == j.compute_map([0.25, 0.5])
    assert tap.APEvaluator().compute(0.5) == jap.APEvaluator().compute(0.5)
