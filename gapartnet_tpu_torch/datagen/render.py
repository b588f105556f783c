"""Rendering for offline dataset generation (the port's copy of
datagen/render.py).

Re-architecture of dataset/render_tools/render.py:15-147 +
render_utils.py:10-230 + read_utils.py:10-108: per (model_id, camera_idx,
render_idx) sample a random joint configuration and camera position, render
RGB / depth / segmentation with a SAPIEN kinematic articulation, FK the
annotated part boxes, compute the NPCS map (vectorized,
datagen/pose.npcs_map_from_bboxes), and save everything in the layout
datagen/convert.sample_and_save consumes.

SAPIEN is an optional host-side dependency: URDF parsing, qpos/camera
sampling, FK, NPCS math, and the save format all run without it; the SAPIEN
path (`set_all_scene`, `render_one_image`, `render_all`) raises ImportError
naming sapien when it is not installed.  Batch loops
run in-process rather than via os.system per image (render_all_partnet.py:33-47
spawned a subprocess per render; that script also carried a latent
HEIGHT/WIDTH import bug noted in SURVEY.md).
"""

import json
import os
import xml.etree.ElementTree as ET
from os.path import join as pjoin
from typing import Dict, Optional

import numpy as np

from gapartnet_tpu_torch.datagen.config import (
    AKB48_CAMERA_POSITION_RANGE,
    BACKGROUND_RGB,
    HEIGHT,
    PARTNET_CAMERA_POSITION_RANGE,
    TARGET_GAPARTS,
    WIDTH,
)
from gapartnet_tpu_torch.datagen.pose import fk_part_bboxes, npcs_map_from_bboxes

try:
    import sapien.core as sapien

    HAVE_SAPIEN = True
except ImportError:
    sapien = None
    HAVE_SAPIEN = False


# ---------------------------------------------------------------------------
# SAPIEN-free pieces (parsing, sampling, annotations, saving)
# ---------------------------------------------------------------------------

def get_id_category(target_id, id_list_path: str) -> Optional[str]:
    """Look up an object id's category in the meta id list (read_utils.py:10-19)."""
    with open(id_list_path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) >= 2 and str(parts[1]) == str(target_id):
                return parts[0]
    return None


def read_joints_from_urdf_file(data_path: str, urdf_name: str) -> Dict[str, dict]:
    """Parse joint kinematics from a URDF (read_utils.py:22-66 semantics)."""
    tree = ET.parse(pjoin(data_path, urdf_name))
    joint_dict = {}
    for joint in tree.getroot().iter("joint"):
        jtype = joint.attrib["type"]
        child = parent = None
        xyz, rpy = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
        axis, limit = None, None
        for c in joint.iter("child"):
            child = c.attrib["link"]
        for p in joint.iter("parent"):
            parent = p.attrib["link"]
        for o in joint.iter("origin"):
            if "xyz" in o.attrib:
                xyz = [float(x) for x in o.attrib["xyz"].split()]
            if "rpy" in o.attrib:
                rpy = [float(x) for x in o.attrib["rpy"].split()]
        if jtype in ("prismatic", "revolute", "continuous"):
            for a in joint.iter("axis"):
                axis = [float(x) for x in a.attrib["xyz"].split()]
        if jtype in ("prismatic", "revolute"):
            for l in joint.iter("limit"):
                limit = [float(l.attrib["lower"]), float(l.attrib["upper"])]
        joint_dict[joint.attrib["name"]] = dict(
            type=jtype, parent=parent, child=child,
            xyz=xyz, rpy=rpy, axis=axis, limit=limit,
        )
    return joint_dict


def sample_joint_qpos(joints_dict: Dict[str, dict], rng: np.random.RandomState):
    """Random qpos in joint limits (render.py:41-52 semantics; continuous

    joints get a huge uniform range, fixed joints 0)."""
    qpos = {}
    for name, jd in joints_dict.items():
        if jd["type"] in ("prismatic", "revolute"):
            lo, hi = jd["limit"]
            qpos[name] = float(rng.uniform(lo, hi))
        elif jd["type"] == "continuous":
            qpos[name] = float(rng.uniform(-10000.0, 10000.0))
        elif jd["type"] == "fixed":
            qpos[name] = 0.0
        else:
            raise ValueError(f"unknown joint type {jd['type']}")
    return qpos


def get_cam_pos(theta_min, theta_max, phi_min, phi_max, dis_min, dis_max,
                rng: Optional[np.random.RandomState] = None):
    """Random camera on a spherical shell (render_utils.py:10-17 semantics:

    theta measured from the xy-plane)."""
    rng = rng or np.random
    theta = np.deg2rad(rng.uniform(theta_min, theta_max))
    phi = np.deg2rad(rng.uniform(phi_min, phi_max))
    dis = rng.uniform(dis_min, dis_max)
    return np.array(
        [
            dis * np.cos(theta) * np.cos(phi),
            dis * np.cos(theta) * np.sin(phi),
            dis * np.sin(theta),
        ]
    )


def load_target_links(data_path: str, anno_file: str) -> Dict[str, dict]:
    """Annotated GAPart links + rest-pose bboxes (pose_utils.py:12-24)."""
    with open(pjoin(data_path, anno_file)) as f:
        anno_list = json.load(f)
    out = {}
    for link in anno_list:
        if link["is_gapart"] and link["category"] in TARGET_GAPARTS:
            out[link["link_name"]] = dict(
                category_id=TARGET_GAPARTS.index(link["category"]),
                bbox=np.array(link["bbox"], np.float32).reshape(-1, 3),
            )
    return out


def seg_maps_from_visual_ids(
    seg_by_visual_id: np.ndarray,
    vis_id_to_link: Dict[int, str],
    link_pose_dict: Dict[str, dict],
    depth_map: np.ndarray,
    eps: float = 1e-6,
):
    """Semantic / instance maps (render_utils.py:165-202 semantics): -2 empty

    background, -1 others, categories/instances for annotated parts visible in
    the frame.  Vectorized over pixels."""
    h, w = seg_by_visual_id.shape
    sem = np.full((h, w), -1, np.int32)
    ins = np.full((h, w), -1, np.int32)
    link_to_inst: Dict[str, int] = {}
    cnt = 0
    for link_name in link_pose_dict:
        mask = np.zeros((h, w), bool)
        for vid, ln in vis_id_to_link.items():
            if ln == link_name:
                mask |= seg_by_visual_id == vid
        if not mask.any():
            continue
        sem[mask] = link_pose_dict[link_name]["category_id"]
        ins[mask] = cnt
        link_to_inst[link_name] = cnt
        cnt += 1
    empty = np.abs(depth_map) < eps
    sem[empty] = -2
    ins[empty] = -2
    return sem, ins, link_to_inst


def add_background_color(rgb_image, depth_map, background_rgb=BACKGROUND_RGB,
                         eps: float = 1e-6):
    rgb_image = rgb_image.copy()
    rgb_image[np.abs(depth_map) < eps] = background_rgb
    return rgb_image


def save_render(save_path: str, save_name: str, rgb, depth, sem, ins, npcs,
                bbox_pose_dict, metafile):
    """Converter-compatible save layout: rgb/, depth/, segmentation/,

    bbox/, npcs/, metafile/ (read_utils.py:68-108 semantics, npz instead of
    pickled .npz dicts for portability)."""
    for sub in ("rgb", "depth", "segmentation", "bbox", "npcs", "metafile"):
        os.makedirs(pjoin(save_path, sub), exist_ok=True)
    try:
        import cv2

        cv2.imwrite(pjoin(save_path, "rgb", save_name + ".png"), rgb[..., ::-1])
    except ImportError:
        np.save(pjoin(save_path, "rgb", save_name + ".npy"), rgb)
    np.savez_compressed(pjoin(save_path, "depth", save_name + ".npz"), depth_map=depth)
    np.savez_compressed(
        pjoin(save_path, "segmentation", save_name + ".npz"),
        semantic_segmentation=sem, instance_segmentation=ins,
    )
    np.savez_compressed(pjoin(save_path, "npcs", save_name + ".npz"), npcs_map=npcs)
    with open(pjoin(save_path, "bbox", save_name + ".json"), "w") as f:
        json.dump(
            {
                k: dict(
                    bbox=np.asarray(v["bbox"]).tolist(),
                    category_id=int(v["category_id"]),
                    instance_id=int(v["instance_id"]),
                )
                for k, v in bbox_pose_dict.items()
            },
            f,
        )
    with open(pjoin(save_path, "metafile", save_name + ".json"), "w") as f:
        json.dump(metafile, f)


# ---------------------------------------------------------------------------
# SAPIEN scene assembly + the full render loop
# ---------------------------------------------------------------------------

def _require_sapien(what: str) -> None:
    if not HAVE_SAPIEN:
        raise ImportError(
            f"{what} renders with sapien (sapien.core), which is not installed; "
            "datagen/assets.py renders without it"
        )


def set_all_scene(data_path, urdf_file, cam_pos, width, height,
                  joint_qpos_dict, engine=None, use_raytracing=False):
    """SAPIEN scene with lights + mounted camera (render_utils.py:28-113)."""
    _require_sapien("set_all_scene")
    if engine is None:
        engine = sapien.Engine()
        renderer = sapien.VulkanRenderer(offscreen_only=True)
        engine.set_renderer(renderer)
    scene = engine.create_scene()
    scene.set_timestep(1 / 100.0)

    loader = scene.create_urdf_loader()
    loader.fix_root_link = True
    robot = loader.load_kinematic(os.path.join(data_path, urdf_file))
    assert robot, "URDF not loaded"

    qpos = []
    for joint in robot.get_joints():
        if joint.get_parent_link() is None:
            continue
        if joint.type in ("revolute", "prismatic", "continuous"):
            qpos.append(joint_qpos_dict[joint.get_name()])
    robot.set_qpos(qpos=np.array(qpos))

    scene.set_ambient_light([0.5, 0.5, 0.5])
    scene.add_directional_light([0, 1, -1], [0.5, 0.5, 0.5], shadow=True)
    scene.add_point_light([1, 2, 2], [1, 1, 1], shadow=True)
    scene.add_point_light([1, -2, 2], [1, 1, 1], shadow=True)
    scene.add_point_light([-1, 0, 1], [1, 1, 1], shadow=True)

    mount = scene.create_actor_builder().build_kinematic()
    camera = scene.add_mounted_camera(
        name="camera", actor=mount, pose=sapien.Pose(),
        width=width, height=height,
        fovx=np.deg2rad(35.0), fovy=np.deg2rad(35.0), near=0.1, far=100.0,
    )
    forward = -cam_pos / np.linalg.norm(cam_pos)
    left = np.cross([0, 0, 1], forward)
    left = left / np.linalg.norm(left)
    up = np.cross(forward, left)
    mat44 = np.eye(4)
    mat44[:3, :3] = np.stack([forward, left, up], axis=1)
    mat44[:3, 3] = cam_pos
    mount.set_pose(sapien.Pose.from_transformation_matrix(mat44))

    scene.step()
    scene.update_render()
    camera.take_picture()
    return scene, camera, engine, robot


def _collect_joint_states(robot) -> Dict[str, dict]:
    """World-frame joint origin/axis from the posed articulation

    (pose_utils.py:26-35)."""
    states = {}
    for joint in robot.get_joints():
        if joint.get_parent_link() is None:
            continue
        pose = joint.get_parent_link().pose * joint.get_pose_in_parent()
        states[joint.get_name()] = dict(
            origin=np.asarray(pose.p),
            axis=pose.to_transformation_matrix()[:3, :3] @ np.array([1.0, 0, 0]),
        )
    return states


def render_one_image(
    dataset_name: str,
    model_id,
    camera_idx: int,
    render_idx: int,
    dataset_path: str,
    id_list_path: str,
    save_path: str,
    height: int = HEIGHT,
    width: int = WIDTH,
    replace_texture: bool = False,
    seed: Optional[int] = None,
):
    """One full render (render.py:15-147).  Requires SAPIEN."""
    _require_sapien("render_one_image")
    rng = np.random.RandomState(seed)
    category = get_id_category(model_id, id_list_path)
    if category is None:
        raise ValueError(f"cannot find category of model {model_id}")
    if dataset_name == "partnet":
        data_path = pjoin(dataset_path, str(model_id))
        cam_ranges = PARTNET_CAMERA_POSITION_RANGE
        base_link_name = "base"
    elif dataset_name == "akb48":
        data_path = pjoin(dataset_path, category, str(model_id))
        cam_ranges = AKB48_CAMERA_POSITION_RANGE
        base_link_name = "root"
    else:
        raise ValueError(dataset_name)

    joints_dict = read_joints_from_urdf_file(
        data_path, "mobility_annotation_gapartnet.urdf"
    )
    joint_qpos = sample_joint_qpos(joints_dict, rng)
    cr = cam_ranges[category][camera_idx]
    cam_pos = get_cam_pos(
        cr["theta_min"], cr["theta_max"], cr["phi_min"], cr["phi_max"],
        cr["distance_min"], cr["distance_max"], rng,
    )

    scene, camera, engine, robot = set_all_scene(
        data_path, "mobility_annotation_gapartnet.urdf", cam_pos,
        width, height, joint_qpos,
    )

    target_links = load_target_links(data_path, "link_annotation_gapartnet.json")
    joint_states = _collect_joint_states(robot)
    link_pose_dict = fk_part_bboxes(
        target_links, joints_dict, joint_states, joint_qpos, base_link_name
    )

    rgb = (camera.get_float_texture("Color")[:, :, :3] * 255).clip(0, 255).astype(
        np.uint8
    )
    depth = -camera.get_float_texture("Position")[..., 2]

    vis_id_to_link = {}
    for articulation in scene.get_all_articulations():
        for link in articulation.get_links():
            if link.get_name() not in link_pose_dict:
                continue
            for visual in link.get_visual_bodies():
                vis_id_to_link[visual.get_visual_id()] = link.get_name()
    seg_by_vid = camera.get_uint32_texture("Segmentation")[..., 0].astype(np.uint16)
    sem, ins, link_to_inst = seg_maps_from_visual_ids(
        seg_by_vid, vis_id_to_link, link_pose_dict, depth
    )
    valid_links = {k: link_pose_dict[k] for k in link_to_inst}

    K = camera.get_camera_matrix()[:3, :3]
    model_mat = camera.get_model_matrix()
    w2c_rot = model_mat[:3, :3] @ np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]])
    c2w_trl = model_mat[:3, 3]

    rts, npcs = npcs_map_from_bboxes(
        depth, ins, {v: k for k, v in link_to_inst.items()}, valid_links,
        K, w2c_rot, c2w_trl,
    )

    if replace_texture:
        assert dataset_name == "partnet"
        tex_joints = read_joints_from_urdf_file(
            data_path, "mobility_texture_gapartnet.urdf"
        )
        tex_qpos = {
            n: joint_qpos[n] for n in joints_dict if n in tex_joints
        }
        scene, camera, engine, robot = set_all_scene(
            data_path, "mobility_texture_gapartnet.urdf", cam_pos,
            width, height, tex_qpos, engine=engine,
        )
        rgb = (camera.get_float_texture("Color")[:, :, :3] * 255).clip(
            0, 255
        ).astype(np.uint8)

    rgb = add_background_color(rgb, depth)

    save_name = f"{category}_{model_id}_{camera_idx}_{render_idx}"
    bbox_pose_dict = {
        k: dict(bbox=v["bbox"], category_id=v["category_id"],
                instance_id=link_to_inst[k])
        for k, v in valid_links.items()
    }
    metafile = dict(
        model_id=model_id, category=category, camera_idx=camera_idx,
        render_idx=render_idx, width=width, height=height,
        joint_qpos=joint_qpos, camera_pos=cam_pos.reshape(-1).tolist(),
        camera_intrinsic=K.reshape(-1).tolist(),
        world2camera_rotation=w2c_rot.reshape(-1).tolist(),
        camera2world_translation=c2w_trl.reshape(-1).tolist(),
        target_gaparts=TARGET_GAPARTS, replace_texture=replace_texture,
    )
    save_render(save_path, save_name, rgb, depth, sem, ins, npcs,
                bbox_pose_dict, metafile)
    return save_name


def render_all(
    dataset_name: str,
    dataset_path: str,
    id_list_path: str,
    save_path: str,
    num_renders: int = 1,
    seed: int = 0,
):
    """Batch loop over (model, camera range, render idx) — in-process,

    replacing render_all_partnet.py:33-47's os.system per image.  Requires
    SAPIEN."""
    _require_sapien("render_all")
    ranges = (
        PARTNET_CAMERA_POSITION_RANGE
        if dataset_name == "partnet"
        else AKB48_CAMERA_POSITION_RANGE
    )
    with open(id_list_path) as f:
        entries = [l.strip().split(" ") for l in f if l.strip()]
    results = []
    for cat, model_id in entries:
        for cam_idx in range(len(ranges[cat])):
            for ridx in range(num_renders):
                results.append(
                    render_one_image(
                        dataset_name, model_id, cam_idx, ridx,
                        dataset_path, id_list_path, save_path,
                        seed=seed + len(results),
                    )
                )
    return results
