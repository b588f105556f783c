"""Entry points and the capacity helpers of the port.

The port's copies of the capacity helpers and of bench.py's cloud setup
must give exactly what the JAX package's give; `entry(device="cpu")` runs
the flagship forward end to end on the CPU (plain versions)."""

import dataclasses

import numpy as np
import pytest
import torch

import bench
from gapartnet_tpu.data import capacity as jcap
from gapartnet_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from gapartnet_tpu.models.gapartnet import GAPartNetConfig as JaxConfig
from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.data import capacity as tcap
from gapartnet_tpu_torch.data.synthetic import synthetic_batch
from gapartnet_tpu_torch.entry import BENCH_CLOUD, bench_cloud_setup, entry


@pytest.fixture(scope="module")
def cloud():
    d = np.load(BENCH_CLOUD)
    fg = d["sem_labels"] > 0
    return d["xyz"].astype(np.float64), d["sem_labels"].astype(np.int64), fg


@pytest.mark.parametrize("fn", ["_hash_occupancy", "_hash_connected_degree", "_hash_components"])
def test_capacity_helpers_match(cloud, fn):
    xyz, sem, fg = cloud
    assert getattr(tcap, fn)(xyz[fg], sem[fg], 0.04) == getattr(jcap, fn)(xyz[fg], sem[fg], 0.04)


def test_counts_and_span_match(cloud):
    xyz, _, _ = cloud
    tc, ts = tcap._counts_and_span(xyz, (0.01,) * 3, 7)
    jc, js = jcap._counts_and_span(xyz, (0.01,) * 3, 7)
    assert list(tc) == list(jc)
    np.testing.assert_array_equal(ts, js)


def test_bench_cloud_setup_matches_bench():
    jcfg, jbatch, jsem, joff = bench.real_cloud_setup(JaxConfig(), str(BENCH_CLOUD), 2)
    tcfg, tbatch, tsem, toff = bench_cloud_setup(GAPartNetConfig(), device="cpu", batch_size=2)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(tbatch.points.numpy(), np.asarray(jbatch.points))
    np.testing.assert_array_equal(tbatch.point_mask.numpy(), np.asarray(jbatch.point_mask))
    np.testing.assert_array_equal(tsem.numpy(), np.asarray(jsem))
    np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))


def test_synthetic_batch_matches():
    t = synthetic_batch(np.random.RandomState(3), batch_size=2, num_points=256, num_parts=3)
    j = jax_synthetic_batch(np.random.RandomState(3), batch_size=2, num_points=256, num_parts=3)
    assert t.keys() == j.keys()
    for k in t:
        if k != "pc_ids":
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_entry_runs_on_cpu():
    fn, (batch,) = entry(device="cpu")
    assert batch.points.device.type == "cpu" and tuple(batch.points.shape) == (1, 20000, 6)
    sem_preds, score_preds, npcs_preds = fn(batch)
    assert tuple(sem_preds.shape) == (1, 20000)
    assert tuple(score_preds.shape) == (1, 128)
    assert tuple(npcs_preds.shape) == (1, 40000, 3)
    assert bool(torch.isfinite(score_preds).all()) and bool(torch.isfinite(npcs_preds).all())
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
