"""The port's dataset pipeline against the JAX package's: dataset items
(augmented and not), collate, the trainer's batch order (shuffled, with
worker threads), trailing-batch padding, and the capacity scans.

Items must be equal exactly, except `instance_regions` (within 1e-6: the
JAX package computes them in float32 C++ when its native library is
built, the port in NumPy)."""

import numpy as np
import pytest

from gapartnet_tpu.data import capacity as jcap
from gapartnet_tpu.data import loader as jloader
from gapartnet_tpu.data.synthetic import synthetic_cloud
from gapartnet_tpu.train import trainer as jtrainer
from gapartnet_tpu_torch.data import capacity as tcap
from gapartnet_tpu_torch.data import loader as tloader
from gapartnet_tpu_torch.train import trainer as ttrainer

REGIONS_TOL = 1e-6
AUG = dict(pos_jitter=0.1, color_jitter=0.3, flip_prob=0.3, rotate_prob=0.3)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clouds") / "pth"
    d.mkdir()
    rng = np.random.RandomState(3)
    names = ["Box_1_00_000", "Door_2_00_000", "Remote_3_00_000", "Oven_4_00_000",
             "Laptop_5_00_000"]
    for i, name in enumerate(names):
        c = synthetic_cloud(rng, num_points=200 + 20 * i, num_parts=3 + i % 2)
        ins = c["instance_labels"].copy()
        ins[ins >= 0] = ins[ins >= 0] * 3 + 5          # non-compact ids
        np.savez(d / f"{name}.npz", xyz=c["points"][:, :3], rgb=c["points"][:, 3:],
                 sem_labels=c["sem_labels"], instance_labels=ins, gt_npcs=c["gt_npcs"])
    (d.parent / "nopart.txt").write_text(f"{d}/Oven_4_00_000.npz {d}/none.npz")
    return d


def _pair(data_dir, **kw):
    kw = {"max_points": 300, "max_instances": 4, **kw}
    return jloader.GAPartNetDataset(data_dir, **kw), tloader.GAPartNetDataset(data_dir, **kw)


def _assert_item_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "pc_id":
            assert got[k] == v
        elif k == "instance_regions":
            np.testing.assert_allclose(got[k], v, rtol=0, atol=REGIONS_TOL)
        else:
            assert got[k].dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("kw", [
    {},
    dict(augmentation=True, seed=5, **AUG),
    dict(shuffle=True, seed=2),
    dict(few_shot=True, few_shot_num=3),
    dict(max_instances=2),
])
def test_dataset_items_equal(data_dir, kw, monkeypatch):
    """Against the NumPy branch of the JAX package's instance statistics
    (native_loader.py:108-119), which the port copies: the native library,
    when built, leaves the regions of instances past max_instances at 0."""
    from gapartnet_tpu.data import native_loader

    monkeypatch.setattr(native_loader, "get_lib", lambda: None)
    jd, td = _pair(data_dir, **kw)
    assert td.paths == jd.paths
    for epoch in (0, 3):
        jd.epoch = td.epoch = epoch
        for i in range(len(jd)):
            _assert_item_equal(td[i], jd[i])


def test_nopart_filter_and_from_folder(data_dir, tmp_path):
    nopart = str(data_dir.parent / "nopart.txt")
    jd, td = _pair(data_dir, nopart_path=nopart)
    assert td.paths == jd.paths and len(td) == 4
    (tmp_path / "split.json").write_text(
        '["%s/Box_1_00_000.npz", "%s/Door_2_00_000.npz", "%s/gone.npz"]' % ((data_dir,) * 3))
    for idx, count in ((0, 2), (1, 2)):
        jf = jloader.from_folder(tmp_path, "split", idx, count, max_points=300)
        tf = tloader.from_folder(tmp_path, "split", idx, count, max_points=300)
        assert tf.paths == jf.paths
    assert tloader.shard_files(list("abcde"), 1, 2) == jloader.shard_files(list("abcde"), 1, 2)


def test_compact_labels_and_augmentations():
    ins = np.array([-100, 7, 7, 3, -100, 12], np.int32)
    np.testing.assert_array_equal(tloader.compact_instance_labels(ins),
                                  jloader.compact_instance_labels(ins))
    pts = np.random.RandomState(0).rand(50, 6).astype(np.float32)
    for seed in range(4):
        np.testing.assert_array_equal(
            tloader.apply_augmentations(pts, np.random.RandomState(seed), **AUG),
            jloader.apply_augmentations(pts, np.random.RandomState(seed), **AUG))


def _assert_batch_equal(got, want):
    assert got["pc_ids"] == want["pc_ids"]
    assert set(got) == set(want)
    for k in want:
        if k == "pc_ids":
            continue
        if k == "instance_regions":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=REGIONS_TOL)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("batch_size,drop_last,shuffle_seed,workers", [
    (2, True, 23334, 0), (2, True, 23334, 3), (2, False, None, 0), (3, False, None, 4),
    (4, False, 7, 2),
])
def test_iter_batches_equal(data_dir, batch_size, drop_last, shuffle_seed, workers):
    """Order, augmentation epoch, padding of the trailing batch."""
    jd, td = _pair(data_dir, augmentation=True, shuffle=True, seed=1, **AUG)
    want = list(jtrainer._iter_batches(jd, batch_size, drop_last, shuffle_seed, workers))
    got = list(ttrainer._iter_batches(td, batch_size, drop_last, shuffle_seed, workers))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_batch_equal(g, w)
    assert td.epoch == jd.epoch
    # the stream does not depend on the worker count
    again = list(ttrainer._iter_batches(td, batch_size, drop_last, shuffle_seed, 0))
    for g, w in zip(again, want):
        _assert_batch_equal(g, w)


def test_pad_trailing_equal(data_dir):
    jd, td = _pair(data_dir)
    want = jtrainer._pad_trailing([jd[0], jd[1]], 4)
    got = ttrainer._pad_trailing([td[0], td[1]], 4)
    _assert_batch_equal(tloader.collate(got), jloader.collate(want))
    pad = got[-1]
    assert pad["pc_id"] == "__pad__" and not pad["point_mask"].any()
    assert (pad["instance_sem_labels"] == -1).all() and (pad["num_points_per_instance"] == 0).all()


@pytest.mark.parametrize("aug", [False, True])
def test_scan_dataset_shapes_equal(data_dir, aug):
    kw = dict(augmentation=True, seed=4, **AUG) if aug else {}
    jd, td = _pair(data_dir, **kw)
    args = ((0.01, 0.01, 0.01), 4, 300)
    assert tcap.scan_dataset_shapes([td, None], *args) == jcap.scan_dataset_shapes([jd, None], *args)
    assert tcap.scan_level_capacities([td], *args, max_samples=2) == jcap.scan_level_capacities(
        [jd], *args, max_samples=2)
    assert td.epoch == jd.epoch == 0


@pytest.mark.parametrize("radius", [0.04, 0.1])
def test_scan_hash_capacities_equal(data_dir, radius):
    jd, td = _pair(data_dir)
    jd2, td2 = _pair(data_dir, augmentation=True, seed=9, **AUG)
    assert tcap.scan_hash_capacities([td, td2], radius, max_points=300) == \
        jcap.scan_hash_capacities([jd, jd2], radius, max_points=300)
