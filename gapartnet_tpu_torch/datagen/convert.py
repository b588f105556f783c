"""Convert rendered RGB-D + annotation maps into network input files (the
port's copy of datagen/convert.py).

Re-implements dataset/process_tools/convert_rendered_into_input.py:41-175
with vectorized back-projection and the port's FPS (ops/fps.py) on the
caller's device:

  back-project (skip background) -> FPS to N points -> ball-space normalize ->
  label shift (sem -1..8 -> 0..9, ins -1 -> -100) -> re-compact instance ids ->
  save .npz (+ .pth) + meta scale + gt encoding
  (sem * 1000 + ins).
"""

import os
from os.path import join as pjoin
from typing import Optional

import numpy as np
import torch

from gapartnet_tpu_torch.datagen.config import MAX_INSTANCE_NUM
from gapartnet_tpu_torch.ops.fps import furthest_point_sampling_single


def backproject_labeled(
    rgb_image: np.ndarray,
    depth_map: np.ndarray,
    sem_seg_map: np.ndarray,
    ins_seg_map: np.ndarray,
    npcs_map: np.ndarray,
    K: np.ndarray,
):
    """Vectorized get_point_cloud (convert_rendered_into_input.py:41-68):

    drop -2 (empty background) pixels, back-project the rest."""
    h, w = depth_map.shape
    keep = (sem_seg_map != -2) & (ins_seg_map != -2)
    ys, xs = np.nonzero(keep)
    z = depth_map[ys, xs].astype(np.float64)
    x = (xs - K[0, 2]) * z / K[0, 0]
    y = (ys - K[1, 2]) * z / K[1, 1]
    pcs = np.stack([x, y, z], axis=-1)
    return (
        pcs,
        rgb_image[ys, xs] / 255.0,
        sem_seg_map[ys, xs],
        ins_seg_map[ys, xs],
        npcs_map[ys, xs],
        np.stack([ys, xs], axis=-1),
    )


def world_space_to_ball_space(pointcloud: np.ndarray):
    """Bounding-box-center ball normalization (FindMaxDis /

    WorldSpaceToBallSpace, convert_rendered_into_input.py:71-89)."""
    max_xyz = pointcloud.max(0)
    min_xyz = pointcloud.min(0)
    center = (max_xyz + min_xyz) / 2
    max_radius = np.sqrt(((pointcloud - center) ** 2).sum(1)).max()
    return (pointcloud - center) / max_radius, max_radius, center


def fps_indices(points: np.ndarray, num_points: int, device="cuda") -> Optional[np.ndarray]:
    """FPS of the back-projected points on `device` (replaces pointnet_lib
    CUDA FPS, sample_utils.py:27-46).  None when there are fewer than
    num_points points.

    The JAX package pads the points to a power-of-two bucket (masked
    invalid) so that XLA compiles one graph per bucket; padded points never
    win the argmax, so the indices are those of the unpadded cloud.  The
    default device is the card: on a machine without one, pass "cpu"."""
    n = points.shape[0]
    if n < num_points:
        return None
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('fps_indices: no CUDA device; pass device="cpu" to sample on the CPU')
    pts = torch.from_numpy(np.ascontiguousarray(points[:, :3], dtype=np.float32)).to(device)
    return furthest_point_sampling_single(pts, num_points).cpu().numpy()


def recompact_instance_labels(ins: np.ndarray) -> np.ndarray:
    """Fill holes left by FPS sampling (convert_rendered_into_input.py:141-147

    semantics: move the max label into each empty slot)."""
    ins = ins.copy()
    j = 0
    while j < ins.max():
        if (ins == j).sum() == 0:
            ins[ins == ins.max()] = j
        j += 1
    return ins


def sample_and_save(
    filename: str,
    rgb_image: np.ndarray,
    depth_map: np.ndarray,
    sem_seg_map: np.ndarray,
    ins_seg_map: np.ndarray,
    npcs_map: np.ndarray,
    K: np.ndarray,
    save_path: str,
    num_points: int = 20000,
    save_pth: bool = True,
    device="cuda",
) -> int:
    """Full conversion for one render (sample_and_save,

    convert_rendered_into_input.py:90-175), FPS on `device`.  Returns 0 on
    success, -1 if the cloud has fewer than num_points points."""
    pth_dir = pjoin(save_path, "pth")
    meta_dir = pjoin(save_path, "meta")
    gt_dir = pjoin(save_path, "gt")
    for d in (pth_dir, meta_dir, gt_dir):
        os.makedirs(d, exist_ok=True)

    pcs, rgb, sem, ins, npcs, idx = backproject_labeled(
        rgb_image, depth_map, sem_seg_map, ins_seg_map, npcs_map, K
    )
    assert ((sem == -1) == (ins == -1)).all(), "sem/ins labels do not match"

    fps_idx = fps_indices(pcs, num_points, device)
    if fps_idx is None:
        return -1
    pcs, rgb, sem, ins, npcs, idx = (
        a[fps_idx] for a in (pcs, rgb, sem, ins, npcs, idx)
    )

    pcs_norm, max_radius, center = world_space_to_ball_space(pcs)
    scale_param = np.array([max_radius, *center])

    sem_out = (sem + 1).astype(np.int32)          # -1..8 -> 0..9
    ins_out = ins.astype(np.int32).copy()
    ins_out[ins_out == -1] = -100
    ins_out = recompact_instance_labels(ins_out)

    base = pjoin(pth_dir, filename)
    np.savez(
        base + ".npz",
        xyz=pcs_norm.astype(np.float32),
        rgb=rgb.astype(np.float32),
        sem_labels=sem_out,
        instance_labels=ins_out,
        gt_npcs=npcs.astype(np.float32),
        pixel_idx=idx.astype(np.int32),
    )
    if save_pth:
        torch.save(
            (
                pcs_norm.astype(np.float32),
                rgb.astype(np.float32),
                sem_out,
                ins_out,
                npcs.astype(np.float32),
                idx.astype(np.int32),
            ),
            base + ".pth",
        )
    np.savetxt(pjoin(meta_dir, filename + ".txt"), scale_param, delimiter=",")

    # gt encoding: sem * 1000 + inst per point (convert_rendered_into_input.py:160-173)
    label_sem_ins = np.full(ins_out.shape, -100, np.int32)
    for inst_id in range(int(ins_out.max()) + 1):
        m = ins_out == inst_id
        if not m.any():
            raise ValueError(f"{filename}: instance label not continuous")
        s = int(sem_out[np.nonzero(m)[0][0]])
        if s == 0:
            raise ValueError(f"{filename}: part with semantic label [others]")
        label_sem_ins[m] = s * MAX_INSTANCE_NUM + inst_id
    np.savetxt(pjoin(gt_dir, filename + ".txt"), label_sem_ins, fmt="%d")
    return 0
