"""Loading one point-cloud sample (the port's copy of data/loader.py's
`load_cloud_file`).

Two formats: the reference's `.pth` tuples (xyz, rgb, sem, ins, npcs, ...)
written by torch.save (convert_rendered_into_input.py:156-158), and `.npz`
archives with the fields xyz, rgb, sem_labels, instance_labels, gt_npcs.
"""

import os

import numpy as np
import torch

from gapartnet_tpu_torch.constants import OBJECT_NAME2ID


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
