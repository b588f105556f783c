"""Part-pose forward kinematics and NPCS map generation (pure NumPy; the
port's copy of datagen/pose.py).

Re-implements the reference render-time math
(dataset/render_tools/utils/pose_utils.py:10-152) without SAPIEN/transforms3d
dependencies: FK of annotated part bounding boxes through the joint chain
(prismatic translate / revolute rotate about the joint axis), the NPCS
rotation-translation-scale from an oriented box, and a fully vectorized
per-pixel NPCS map (the reference loops over pixels in Python).
"""

from typing import Dict, List

import numpy as np


def axangle2mat(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rotation matrix for rotation of `angle` about `axis` (column-vector

    convention, as transforms3d.axangles.axangle2mat)."""
    x, y, z = axis / np.linalg.norm(axis)
    c, s = np.cos(angle), np.sin(angle)
    C = 1 - c
    return np.array(
        [
            [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
        ]
    )


def fk_part_bboxes(
    target_links: Dict[str, dict],
    joints_dict: Dict[str, dict],
    joint_states: Dict[str, dict],
    joint_qpos: Dict[str, float],
    base_link_name: str,
) -> Dict[str, dict]:
    """FK each annotated part bbox from rest pose to the posed articulation

    (pose_utils.py:10-72 semantics).

    target_links[link] = {category_id, bbox (8,3)}
    joints_dict[joint] = {type, parent, child}
    joint_states[joint] = {origin (3,), axis (3,)} in world frame
    """
    child_to_joint = {jd["child"]: jn for jn, jd in joints_dict.items()}
    result = {}
    for link_name, link in target_links.items():
        chain: List[str] = []
        cur = link_name
        while cur in child_to_joint:
            jn = child_to_joint[cur]
            chain.append(jn)
            cur = joints_dict[jn]["parent"]
        assert cur == base_link_name, f"{link_name} not connected to {base_link_name}"
        chain = chain[:-1]  # the root joint is dropped (pose_utils.py:52)

        bbox = np.asarray(link["bbox"], np.float64).reshape(-1, 3)
        for jn in chain[::-1]:
            jtype = joints_dict[jn]["type"]
            if jtype == "fixed":
                continue
            origin = np.asarray(joint_states[jn]["origin"], np.float64)
            axis = np.asarray(joint_states[jn]["axis"], np.float64)
            axis = axis / np.linalg.norm(axis)
            q = joint_qpos[jn]
            if jtype == "prismatic":
                bbox = bbox + axis * q
            elif jtype in ("revolute", "continuous"):
                rot = axangle2mat(axis, q).T
                bbox = (bbox - origin) @ rot + origin
        result[link_name] = {"category_id": link["category_id"], "bbox": bbox}
    return result


def rotation_from_corresponding_boxes(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """Kabsch rotation between corresponding corner sets (pose_utils.py:90-101)."""
    c1, c2 = b1.mean(0), b2.mean(0)
    H = (b1 - c1).T @ (b2 - c2)
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        R[0, :] *= -1
    return R.T


def npcs_rts_from_bbox(bbox: np.ndarray) -> dict:
    """NPCS rotation/translation/scale from an oriented 8-corner box

    (pose_utils.py:110-137): T = corner mean, S = edge lengths, R aligns the
    canonical axis-aligned box to the scaled world box."""
    bbox = np.asarray(bbox, np.float64).reshape(8, 3)
    T = bbox.mean(0)
    s_x = np.linalg.norm(bbox[1] - bbox[0])
    s_y = np.linalg.norm(bbox[1] - bbox[2])
    s_z = np.linalg.norm(bbox[0] - bbox[4])
    S = np.array([s_x, s_y, s_z])
    scaler = np.linalg.norm(S)
    bbox_scaled = (bbox - T) / scaler
    bbox_canon = (
        np.array(
            [
                [-s_x / 2, s_y / 2, s_z / 2],
                [s_x / 2, s_y / 2, s_z / 2],
                [s_x / 2, -s_y / 2, s_z / 2],
                [-s_x / 2, -s_y / 2, s_z / 2],
                [-s_x / 2, s_y / 2, -s_z / 2],
                [s_x / 2, s_y / 2, -s_z / 2],
                [s_x / 2, -s_y / 2, -s_z / 2],
                [-s_x / 2, -s_y / 2, -s_z / 2],
            ]
        )
        / scaler
    )
    R = rotation_from_corresponding_boxes(bbox_canon, bbox_scaled)
    return {"R": R, "T": T, "S": S, "scaler": scaler}


def npcs_map_from_bboxes(
    depth_map: np.ndarray,
    inst_seg_map: np.ndarray,
    inst_to_link: Dict[int, str],
    link_pose_dict: Dict[str, dict],
    K: np.ndarray,
    world2camera_rotation: np.ndarray,
    camera2world_translation: np.ndarray,
):
    """Vectorized per-pixel NPCS map (pose_utils.py:110-152; the reference

    loops over pixels).  Pixels with inst_seg < 0 stay zero.
    Returns (NPCS_RTS_dict, canon_position_map (H,W,3))."""
    rts = {
        link: npcs_rts_from_bbox(link_pose_dict[link]["bbox"])
        for link in inst_to_link.values()
    }
    h, w = depth_map.shape
    ys, xs = np.mgrid[0:h, 0:w]
    z = depth_map.astype(np.float64)
    xc = (xs - K[0, 2]) * z / K[0, 0]
    yc = (ys - K[1, 2]) * z / K[1, 1]
    cam = np.stack([xc, yc, z], axis=-1)
    # pixel_world = pixel_camera @ world2camera_rotation.T + translation
    # (pose_utils.py:144-147)
    world = cam @ np.asarray(world2camera_rotation).T + camera2world_translation

    out = np.zeros((h, w, 3), np.float32)
    for inst_id, link in inst_to_link.items():
        m = inst_seg_map == inst_id
        p = rts[link]
        out[m] = (((world[m] - p["T"]) / p["scaler"]) @ p["R"].T).astype(np.float32)
    return rts, out
