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


def test_train_setup_fits_every_cloud():
    """B distinct rotated clouds; every capacity is the maximum of the
    per-cloud rules; the labels, regions and overrides follow each cloud."""
    from gapartnet_tpu.data.loader import generate_instance_info as jax_instance_info
    from gapartnet_tpu_torch.entry import _fitted_capacities, train_setup

    cfg, batch, sem, off = train_setup(GAPartNetConfig(), batch_size=3, seed=1, device="cpu")
    pts = batch.points.numpy()
    assert pts.shape == (3, 20000, 6)
    assert not np.array_equal(pts[0], pts[1]) and not np.array_equal(pts[1], pts[2])
    d = np.load(BENCH_CLOUD)
    # rotations about z keep z and the xy radius
    np.testing.assert_allclose(pts[:, :, 2], np.tile(d["xyz"][None, :, 2], (3, 1)), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(pts[:, :, :2], axis=-1),
                               np.tile(np.linalg.norm(d["xyz"][:, :2], axis=-1)[None], (3, 1)),
                               atol=1e-5)
    fitted = [_fitted_capacities(GAPartNetConfig(), pts[i, :, :3], d["sem_labels"],
                                 d["instance_labels"])[0] for i in range(3)]
    assert cfg.level_capacities == tuple(np.max([f["level_capacities"] for f in fitted], 0))
    assert cfg.input_grid_extent == tuple(np.max([f["input_grid_extent"] for f in fitted], 0))
    for k in ("hash_node_capacity", "hash_cand_cap", "hash_max_degree", "dense_grid_capacity"):
        assert getattr(cfg, k) == max(f[k] for f in fitted), k
    for i in range(3):
        reg, nppi, isl, k = jax_instance_info(pts[i], d["sem_labels"], d["instance_labels"])
        np.testing.assert_array_equal(batch.instance_regions[i].numpy(), reg)
        np.testing.assert_array_equal(batch.num_points_per_instance[i, :k].numpy(), nppi)
        assert (batch.num_points_per_instance[i, k:].numpy() == 0).all()
        ins = d["instance_labels"]
        want_off = np.where((ins >= 0)[:, None], reg[:, :3] - pts[i, :, :3], 0.0)
        np.testing.assert_allclose(off[i].numpy(), want_off, atol=1e-6)
    np.testing.assert_array_equal(batch.gt_npcs[2].numpy(), d["gt_npcs"])
    np.testing.assert_array_equal(sem.numpy(), batch.sem_labels.numpy())


def test_train_entry_runs_on_cpu():
    """train_entry's step on the CPU (B = 1): finite losses, zero counters,
    the loss moves between steps."""
    from gapartnet_tpu_torch.entry import train_entry

    fn, (batch,) = train_entry(device="cpu", batch_size=1)
    first = fn(batch)
    second = fn(batch)
    assert all(bool(torch.isfinite(v)) for v in first.values())
    assert all(float(v) == 0 for k, v in first.items() if k.startswith("counters/"))
    assert float(first["loss/loss_prop_npcs"]) > 0 and float(first["loss/loss_prop_score"]) > 0
    assert float(second["loss/total_loss"]) != float(first["loss/total_loss"])
