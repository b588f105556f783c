"""The dataset pipeline (the port's copy of data/loader.py).

The host loads a sample, augments it and pads it to fixed shapes; the model
voxelizes on the device.  Two file formats: the reference's `.pth` tuples
(xyz, rgb, sem, ins, npcs, ...) written by torch.save
(convert_rendered_into_input.py:156-158), and `.npz` archives with the
fields xyz, rgb, sem_labels, instance_labels, gt_npcs.
"""

import json
import os
import random
from glob import glob
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from gapartnet_tpu_torch.constants import OBJECT_NAME2ID
from gapartnet_tpu_torch.data import native_loader


def load_cloud_file(path: str) -> dict:
    """One sample -> dict(points (N, 6) float32, sem_labels int32,
    instance_labels int32, gt_npcs float32, pc_id, obj_cat).

    A `.pth` file is unpickled (torch.load with weights_only=False): load
    only files this project or its dataset converter wrote."""
    path = str(path)
    pc_id = os.path.basename(path).split(".")[0]
    obj_cat = OBJECT_NAME2ID.get(pc_id.split("_")[0], -1)
    if path.endswith(".npz"):
        d = np.load(path)
        xyz, rgb = d["xyz"], d["rgb"]
        sem, ins, npcs = d["sem_labels"], d["instance_labels"], d["gt_npcs"]
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
        xyz, rgb, sem, ins, npcs = (np.asarray(data[i]) for i in range(5))
    points = np.concatenate([xyz, rgb], axis=-1).astype(np.float32)
    return dict(
        pc_id=pc_id,
        obj_cat=obj_cat,
        points=points,
        sem_labels=sem.astype(np.int32),
        instance_labels=ins.astype(np.int32),
        gt_npcs=npcs.astype(np.float32),
    )


def compact_instance_labels(instance_labels: np.ndarray) -> np.ndarray:
    """Renumber instances 0..K-1, keeping -100 (gapartnet.py:134-142)."""
    out = instance_labels.copy()
    valid = out >= 0
    _, inv = np.unique(out[valid], return_inverse=True)
    out[valid] = inv
    return out


def apply_augmentations(
    points: np.ndarray,
    rng: np.random.RandomState,
    pos_jitter: float = 0.0,
    color_jitter: float = 0.0,
    flip_prob: float = 0.0,
    rotate_prob: float = 0.0,
) -> np.ndarray:
    """The reference augmentations (gapartnet.py:85-120): a random 3x3
    position jitter matrix, an x-flip, a z-rotation and a colour jitter.
    The rotation is gated on rotate_prob (the reference gates its draw on
    flip_prob, gapartnet.py:104; both are 0.3 in the shipped config)."""
    points = points.copy()
    m = np.eye(3)
    if pos_jitter > 0:
        m += rng.randn(3, 3) * pos_jitter
    if flip_prob > 0 and rng.rand() < flip_prob:
        m[0, 0] = -m[0, 0]
    if rotate_prob > 0 and rng.rand() < rotate_prob:
        theta = rng.rand() * np.pi * 2
        m = m @ np.asarray([
            [np.cos(theta), np.sin(theta), 0],
            [-np.sin(theta), np.cos(theta), 0],
            [0, 0, 1],
        ])
    points[:, :3] = points[:, :3] @ m
    if color_jitter > 0:
        points[:, 3:] += rng.randn(1, points.shape[1] - 3) * color_jitter
    return points


def _cloud_files(root) -> List[str]:
    return sorted(glob(str(root) + "/*.pth")) + sorted(glob(str(root) + "/*.npz"))


class GAPartNetDataset:
    """File-list dataset (reference GAPartNetDataset, gapartnet.py:22-82)
    producing fixed-shape padded samples for `collate`.

    Augmentation draws come from a RandomState seeded by (seed, epoch,
    index), so they do not depend on which thread loads a sample; the
    trainer sets `epoch` per epoch.  Instance statistics come from the
    native library (data/native_loader.py), as the JAX loader takes them
    (loader.py:215-220); `native=False` takes them from the plain NumPy
    version, which differs only past `max_instances`."""

    def __init__(
        self,
        root_dir: Union[str, Path, List],
        shuffle: bool = False,
        max_points: int = 20000,
        augmentation: bool = False,
        max_instances: int = 64,
        few_shot: bool = False,
        few_shot_num: int = 512,
        pos_jitter: float = 0.0,
        color_jitter: float = 0.0,
        flip_prob: float = 0.0,
        rotate_prob: float = 0.0,
        nopart_path: Optional[str] = None,
        seed: int = 0,
        native: bool = True,
    ):
        roots = root_dir if isinstance(root_dir, (list, tuple)) else [root_dir]
        paths = [p for rt in roots for p in _cloud_files(rt)]
        if nopart_path and os.path.exists(nopart_path):
            with open(nopart_path) as f:
                nopart = f.readlines()[0].split(" ")
            nopart_names = {p.split("/")[-1].split(".")[0] for p in nopart}
            paths = [p for p in paths if os.path.basename(p).split(".")[0] not in nopart_names]
        self.seed = seed
        self.epoch = 0
        if shuffle:
            paths = list(paths)
            random.Random(seed).shuffle(paths)
        if few_shot:
            paths = paths[:few_shot_num]
        self.paths = paths
        self.max_points = max_points
        self.max_instances = max_instances
        self.augmentation = augmentation
        self.pos_jitter = pos_jitter
        self.color_jitter = color_jitter
        self.flip_prob = flip_prob
        self.rotate_prob = rotate_prob
        self.native = native

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        d = load_cloud_file(self.paths[idx])
        n = d["points"].shape[0]
        assert n <= self.max_points, (n, self.max_points)  # gapartnet.py:123-131
        d["instance_labels"] = compact_instance_labels(d["instance_labels"])
        if self.augmentation:
            rng = np.random.RandomState(
                (self.seed * 1000003 + self.epoch * 7919 + idx) % (2**31 - 1)
            )
            d["points"] = apply_augmentations(
                d["points"], rng, self.pos_jitter, self.color_jitter,
                self.flip_prob, self.rotate_prob,
            )
        regions, nppi, isl, k = native_loader.instance_info(
            d["points"], d["sem_labels"], d["instance_labels"], self.max_instances, self.native
        )
        pad = self.max_points - n

        def pad_pts(x, fill=0):
            widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, widths, constant_values=fill) if pad else x

        return dict(
            pc_id=d["pc_id"],
            points=pad_pts(d["points"]),
            point_mask=np.arange(self.max_points) < n,
            sem_labels=pad_pts(d["sem_labels"], fill=-100),
            instance_labels=pad_pts(d["instance_labels"], fill=-100),
            gt_npcs=pad_pts(d["gt_npcs"]),
            instance_regions=pad_pts(regions),
            num_points_per_instance=nppi,
            instance_sem_labels=isl,
            num_instances=np.int32(k),
        )


BATCH_FIELDS = (
    "points", "point_mask", "sem_labels", "instance_labels", "gt_npcs",
    "instance_regions", "num_points_per_instance", "instance_sem_labels", "num_instances",
)


def collate(samples: Sequence[dict]) -> dict:
    """Stack padded samples into the arrays of a PointCloudBatch, with the
    sample ids under `pc_ids`."""
    out = {k: np.stack([s[k] for s in samples]) for k in BATCH_FIELDS}
    out["pc_ids"] = [s["pc_id"] for s in samples]
    return out


def from_folder(
    root_dir: Union[str, Path],
    split: str = "train_new",
    process_index: int = 0,
    process_count: int = 1,
    **dataset_kwargs,
) -> GAPartNetDataset:
    """JSON-split variant (reference from_folder, dataset/gapartnet.py:231-285):
    the file list is {root}/{split}.json, sharded per process."""
    root = Path(root_dir)
    with open(root / f"{split}.json") as f:
        names = json.load(f)
    paths = shard_files([str(root / n) for n in names], process_index, process_count)
    ds = GAPartNetDataset(root_dir=[], **dataset_kwargs)
    ds.paths = [p for p in paths if os.path.exists(p)]
    return ds


def shard_files(paths: List[str], process_index: int, process_count: int):
    """Per-process file sharding (the reference's DistributedShardingFilter,
    dataset/data_utils.py:15-37): process i takes every process_count-th
    file."""
    return paths[process_index::process_count]
