"""SAPIEN-free ingestion of raw GAPartNet / PartNet-Mobility assets (the
port's copy of datagen/assets.py; the host NumPy is unchanged, so a seed
gives the same maps, and the converter's FPS runs on the caller's device).

Turns an asset directory (as shipped in the reference's `example_assets/`:
`mobility_annotation_gapartnet.urdf`, `link_annotation_gapartnet.json`,
`textured_objs/*.obj`, `result.json`, optional `point_sample/`) into network
inputs WITHOUT SAPIEN: a plain-XML URDF parse drives forward kinematics
(datagen/pose.py), OBJ meshes are surface-sampled per link, a point-splat
z-buffer replaces the rasterizer, and the existing converter
(datagen/convert.sample_and_save) emits the `.npz` files the data pipeline
consumes.

Replaces, for environments without SAPIEN/Vulkan:
  - scene assembly + rasterization  (reference render_tools/render.py:15-147,
    render_utils.py:28-202) -> `render_asset_view` (z-buffer point splats)
  - SAPIEN link/joint world poses   (pose_utils.py:26-35) ->
    `link_rest_poses` / `joint_world_states` (URDF chain FK at rest)
  - demo asset loading              (demo.ipynb cells 0-4,
    structure/gapartnet.py:466-673) -> `ingest_asset` / `canonical_cloud`

Two label sources, cross-validated in tests:
  (a) mesh provenance: every sampled surface point inherits the link of the
      mesh it was drawn from (exact, works at any qpos);
  (b) PartNet `point_sample/` clouds: `pts-10000.pts` + `label-10000.txt`
      carry result.json leaf ids; leaves map to URDF links through the OBJ
      filenames each references (`leaf_to_link`).  These points live in the
      PartNet y-up frame; the URDF's base joint rpy (pi/2, 0, -pi/2) maps
      them into the annotation (z-up world) frame.
"""

import json
import os
import xml.etree.ElementTree as ET
from os.path import join as pjoin
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gapartnet_tpu_torch.datagen.config import (
    FOV_X_DEG,
    HEIGHT,
    NEAR,
    PARTNET_CAMERA_POSITION_RANGE,
    TARGET_GAPARTS,
    WIDTH,
)
from gapartnet_tpu_torch.datagen.convert import sample_and_save
from gapartnet_tpu_torch.datagen.pose import axangle2mat, fk_part_bboxes, npcs_map_from_bboxes
from gapartnet_tpu_torch.datagen.render import (
    add_background_color,
    get_cam_pos,
    load_target_links,
    read_joints_from_urdf_file,
    sample_joint_qpos,
    save_render,
    seg_maps_from_visual_ids,
)

ANNOTATION_URDF = "mobility_annotation_gapartnet.urdf"


# ---------------------------------------------------------------------------
# URDF parsing + forward kinematics (SAPIEN-free)
# ---------------------------------------------------------------------------

def rpy_to_mat(rpy) -> np.ndarray:
    """URDF fixed-axis roll/pitch/yaw -> rotation matrix (R = Rz Ry Rx)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def parse_link_visuals(urdf_path: str) -> Dict[str, List[dict]]:
    """link name -> list of visuals {name, xyz, rpy, mesh (relative path)}."""
    tree = ET.parse(urdf_path)
    out: Dict[str, List[dict]] = {}
    for link in tree.getroot().findall("link"):
        visuals = []
        for vis in link.findall("visual"):
            xyz, rpy = [0.0] * 3, [0.0] * 3
            o = vis.find("origin")
            if o is not None:
                if o.get("xyz"):
                    xyz = [float(v) for v in o.get("xyz").split()]
                if o.get("rpy"):
                    rpy = [float(v) for v in o.get("rpy").split()]
            mesh = vis.find("geometry/mesh")
            if mesh is None:
                continue
            visuals.append(
                dict(name=vis.get("name"), xyz=np.asarray(xyz),
                     rpy=np.asarray(rpy), mesh=mesh.get("filename"))
            )
        out[link.get("name")] = visuals
    return out


def link_rest_poses(
    joints_dict: Dict[str, dict], base_link: str = "base"
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """World (R, t) of every link frame at rest (all qpos = 0).

    Composes joint <origin> transforms down the tree (joint motion is the
    identity at rest), replacing SAPIEN's articulation pose queries.
    """
    children: Dict[str, List[str]] = {}
    for jn, jd in joints_dict.items():
        children.setdefault(jd["parent"], []).append(jn)
    poses = {base_link: (np.eye(3), np.zeros(3))}
    stack = [base_link]
    while stack:
        parent = stack.pop()
        Rp, tp = poses[parent]
        for jn in children.get(parent, ()):  # child pose = parent ∘ origin
            jd = joints_dict[jn]
            R = Rp @ rpy_to_mat(jd["rpy"])
            t = Rp @ np.asarray(jd["xyz"], np.float64) + tp
            poses[jd["child"]] = (R, t)
            stack.append(jd["child"])
    return poses


def joint_world_states(
    joints_dict: Dict[str, dict],
    rest_poses: Dict[str, Tuple[np.ndarray, np.ndarray]],
) -> Dict[str, dict]:
    """World-frame joint origin/axis at rest — the SAPIEN-free equivalent of

    the reference's `joint_pose = parent_link.pose * joint.pose_in_parent`
    (pose_utils.py:26-35).  The joint frame coincides with the child link
    frame at rest; the URDF <axis> is expressed in that frame.
    """
    states = {}
    for jn, jd in joints_dict.items():
        if jd["child"] not in rest_poses:
            continue
        R, t = rest_poses[jd["child"]]
        axis = np.asarray(jd["axis"] if jd["axis"] is not None else [1.0, 0, 0])
        states[jn] = dict(origin=t.copy(), axis=R @ axis)
    return states


def link_motion_affines(
    link_names,
    joints_dict: Dict[str, dict],
    joint_states: Dict[str, dict],
    joint_qpos: Dict[str, float],
    base_link: str = "base",
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Per-link affine (A, b) mapping rest-pose WORLD coordinates to posed

    world coordinates: posed = rest @ A + b.  Identical chain semantics to
    fk_part_bboxes (pose_utils.py:40-72), factored so arbitrary point sets
    (mesh samples, point_sample clouds) transform like the annotation boxes.
    """
    child_to_joint = {jd["child"]: jn for jn, jd in joints_dict.items()}
    out = {}
    for link_name in link_names:
        chain: List[str] = []
        cur = link_name
        while cur in child_to_joint:
            jn = child_to_joint[cur]
            chain.append(jn)
            cur = joints_dict[jn]["parent"]
        assert cur == base_link, f"{link_name} not connected to {base_link}"
        chain = chain[:-1]  # drop the root joint (pose_utils.py:52)

        A, b = np.eye(3), np.zeros(3)
        for jn in chain[::-1]:
            jtype = joints_dict[jn]["type"]
            if jtype == "fixed":
                continue
            origin = np.asarray(joint_states[jn]["origin"], np.float64)
            axis = np.asarray(joint_states[jn]["axis"], np.float64)
            axis = axis / np.linalg.norm(axis)
            q = joint_qpos[jn]
            if jtype == "prismatic":
                b = b + axis * q
            elif jtype in ("revolute", "continuous"):
                rot = axangle2mat(axis, q).T  # step: x -> (x - o) @ rot + o
                A = A @ rot
                b = (b - origin) @ rot + origin
        out[link_name] = (A, b)
    return out


# ---------------------------------------------------------------------------
# Mesh loading + surface sampling
# ---------------------------------------------------------------------------

def _mtl_color(obj_path: str) -> Optional[np.ndarray]:
    """First Kd diffuse color in the OBJ's .mtl, if present."""
    mtl = os.path.splitext(obj_path)[0] + ".mtl"
    if not os.path.exists(mtl):
        return None
    with open(mtl) as f:
        for line in f:
            if line.startswith("Kd "):
                return np.asarray([float(v) for v in line.split()[1:4]])
    return None


def load_obj_mesh(obj_path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Minimal OBJ reader: vertices, fan-triangulated faces, diffuse color.

    (PartNet-Mobility OBJs are plain v/f with mtl; normals/uv are skipped.)
    Falls back to a deterministic per-file pseudo-color when no .mtl Kd.
    """
    verts, faces = [], []
    with open(obj_path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(v) for v in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    color = _mtl_color(obj_path)
    if color is None:
        h = abs(hash(os.path.basename(obj_path)))
        color = np.asarray(
            [(h % 97) / 96, (h // 97 % 89) / 88, (h // 8633 % 83) / 82]
        ) * 0.6 + 0.2
    return (
        np.asarray(verts, np.float64),
        np.asarray(faces, np.int64).reshape(-1, 3),
        color,
    )


def load_link_meshes(asset_dir: str, urdf_name: str = ANNOTATION_URDF):
    """link -> list of (verts in rest-pose WORLD frame, faces, color).

    Applies each visual's origin then the link's rest FK pose, reproducing
    the rest-pose world geometry SAPIEN would assemble.
    """
    asset_dir = str(asset_dir)
    visuals = parse_link_visuals(pjoin(asset_dir, urdf_name))
    joints = read_joints_from_urdf_file(asset_dir, urdf_name)
    rest = link_rest_poses(joints)
    out: Dict[str, list] = {}
    for link, vlist in visuals.items():
        if link not in rest:
            if vlist:
                raise ValueError(f"link {link} with visuals but no FK pose")
            continue
        R, t = rest[link]
        meshes = []
        for vis in vlist:
            verts, faces, color = load_obj_mesh(pjoin(asset_dir, vis["mesh"]))
            verts = verts @ rpy_to_mat(vis["rpy"]).T + vis["xyz"]
            verts = verts @ R.T + t
            meshes.append((verts, faces, color))
        if meshes:
            out[link] = meshes
    return out


def sample_surface_points(link_meshes: Dict[str, list], n: int, rng):
    """Area-weighted surface sampling across all links at once.

    Returns (xyz (n,3) rest world, rgb (n,3) in [0,1], link_idx (n,) into
    sorted(link_meshes)).
    """
    links = sorted(link_meshes)
    tri_a, tri_b, tri_c, tri_link, tri_color = [], [], [], [], []
    for li, link in enumerate(links):
        for verts, faces, color in link_meshes[link]:
            if len(faces) == 0:
                continue
            tri_a.append(verts[faces[:, 0]])
            tri_b.append(verts[faces[:, 1]])
            tri_c.append(verts[faces[:, 2]])
            tri_link.append(np.full(len(faces), li, np.int32))
            tri_color.append(np.tile(color, (len(faces), 1)))
    a = np.concatenate(tri_a)
    b = np.concatenate(tri_b)
    c = np.concatenate(tri_c)
    tl = np.concatenate(tri_link)
    tc = np.concatenate(tri_color)
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    p = area / area.sum()
    pick = rng.choice(len(area), size=n, p=p)
    # uniform barycentric draw
    u, v = rng.rand(n, 1), rng.rand(n, 1)
    flip = (u + v) > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    xyz = a[pick] + u * (b[pick] - a[pick]) + v * (c[pick] - a[pick])
    return xyz, tc[pick], tl[pick], links


# ---------------------------------------------------------------------------
# point_sample ingestion (leaf-id labels -> links)
# ---------------------------------------------------------------------------

# PartNet point_sample clouds are y-up; the annotation URDF's base joint rpy
# (pi/2, 0, -pi/2) rotates them into the z-up annotation/world frame:
# world = (-y_up.z, -y_up.x, y_up.y)
YUP_TO_WORLD = np.array([[0, -1, 0], [0, 0, 1], [-1, 0, 0]], np.float64).T


def leaf_to_link(asset_dir: str, urdf_name: str = ANNOTATION_URDF) -> Dict[int, str]:
    """result.json leaf id -> URDF link, via the OBJ files both reference.

    (URDF visual names like 'handle-1' are NOT unique across links — the OBJ
    filename sets are.)
    """
    asset_dir = str(asset_dir)
    visuals = parse_link_visuals(pjoin(asset_dir, urdf_name))
    link2objs = {
        link: {os.path.splitext(os.path.basename(v["mesh"]))[0] for v in vlist}
        for link, vlist in visuals.items()
    }
    with open(pjoin(asset_dir, "result.json")) as f:
        result = json.load(f)
    leaf2objs: Dict[int, set] = {}

    def walk(node):
        ch = node.get("children") or []
        if not ch:
            leaf2objs[int(node["id"])] = set(node.get("objs") or [])
        for c in ch:
            walk(c)

    for node in result:
        walk(node)

    mapping: Dict[int, str] = {}
    for leaf, objs in leaf2objs.items():
        for link, lobjs in link2objs.items():
            if objs & lobjs:
                if not objs <= lobjs:
                    raise ValueError(
                        f"leaf {leaf} objs split across links: {objs - lobjs}"
                    )
                if leaf in mapping:
                    raise ValueError(f"leaf {leaf} in two links")
                mapping[leaf] = link
    return mapping


def load_point_sample(asset_dir: str):
    """Rest-pose labeled cloud from PartNet's pre-sampled points.

    Returns (xyz (N,3) world frame, rgb (N,3), link_names list of N) or None
    when the asset ships no point_sample directory.
    """
    asset_dir = str(asset_dir)
    pts_path = pjoin(asset_dir, "point_sample", "pts-10000.pts")
    lab_path = pjoin(asset_dir, "point_sample", "label-10000.txt")
    if not (os.path.exists(pts_path) and os.path.exists(lab_path)):
        return None
    raw = np.loadtxt(pts_path)
    labels = np.loadtxt(lab_path).astype(int)
    xyz = raw[:, :3] @ YUP_TO_WORLD.T
    rgb = raw[:, 3:6] if raw.shape[1] >= 6 else np.full_like(xyz, 0.5)
    l2l = leaf_to_link(asset_dir)
    link_names = [l2l.get(int(l), "") for l in labels]
    return xyz, rgb, link_names


def canonical_cloud(asset_dir: str) -> dict:
    """Fully labeled rest-pose cloud: points + sem/ins/NPCS labels.

    Label semantics match the converter output (convert.sample_and_save):
    sem 0 = others, 1..9 = TARGET_GAPARTS index + 1; ins -100 = no part,
    else compact instance id; NPCS from the rest-pose annotation boxes
    (pose_utils.py:110-152 math via datagen/pose.npcs_rts_from_bbox).
    """
    from gapartnet_tpu_torch.datagen.pose import npcs_rts_from_bbox

    asset_dir = str(asset_dir)
    sample = load_point_sample(asset_dir)
    if sample is None:
        raise FileNotFoundError(f"{asset_dir} has no point_sample/")
    xyz, rgb, link_names = sample
    target = load_target_links(asset_dir, "link_annotation_gapartnet.json")
    inst_links = sorted(target)
    sem = np.zeros(len(xyz), np.int32)
    ins = np.full(len(xyz), -100, np.int32)
    npcs = np.zeros((len(xyz), 3), np.float32)
    ln_arr = np.asarray(link_names)
    for ii, link in enumerate(inst_links):
        m = ln_arr == link
        if not m.any():
            continue
        sem[m] = target[link]["category_id"] + 1
        ins[m] = ii
        rts = npcs_rts_from_bbox(target[link]["bbox"])
        npcs[m] = (((xyz[m] - rts["T"]) / rts["scaler"]) @ rts["R"].T).astype(
            np.float32
        )
    # re-compact instance ids over the links actually present
    present = np.unique(ins[ins >= 0])
    remap = {int(o): i for i, o in enumerate(present)}
    ins = np.asarray([remap.get(int(v), -100) for v in ins], np.int32)
    return dict(
        xyz=xyz.astype(np.float32), rgb=rgb.astype(np.float32),
        sem_labels=sem, instance_labels=ins, gt_npcs=npcs,
    )


# ---------------------------------------------------------------------------
# SAPIEN-free single-view rendering (point-splat z-buffer)
# ---------------------------------------------------------------------------

def camera_intrinsics(width: int = WIDTH, height: int = HEIGHT,
                      fov_x_deg: float = FOV_X_DEG) -> np.ndarray:
    """K for the reference camera (render_utils.py:95-101: fovx=fovy=35deg at

    800x800 gives the f=1268.64 intrinsic hardcoded in misc/visu_util.py)."""
    f = (width / 2.0) / np.tan(np.deg2rad(fov_x_deg) / 2.0)
    return np.array(
        [[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1.0]]
    )


def camera_extrinsics(cam_pos: np.ndarray):
    """CV-convention camera at `cam_pos` looking at the origin, world z-up.

    Returns (R_c2w, t): world = cam @ R_c2w.T + t — the exact contract
    npcs_map_from_bboxes/backproject use (pose_utils.py:144-147 convention,
    derived the same way render.py's mount pose is: forward toward origin,
    left = z x forward, up = forward x left).
    """
    cam_pos = np.asarray(cam_pos, np.float64)
    forward = -cam_pos / np.linalg.norm(cam_pos)
    left = np.cross([0.0, 0, 1], forward)
    left /= np.linalg.norm(left)
    up = np.cross(forward, left)
    # CV axes: x right, y down, z forward
    R_c2w = np.stack([-left, -up, forward], axis=1)
    return R_c2w, cam_pos


def splat_zbuffer(
    xyz_world: np.ndarray,
    cam_pos: np.ndarray,
    K: np.ndarray,
    width: int,
    height: int,
    near: float = NEAR,
):
    """Project points and keep the nearest per pixel.

    Returns (depth_map (H,W) f32 with 0 = empty, winner (H,W) int64 point
    index with -1 = empty).  This point-splat z-buffer is the SAPIEN-free
    visibility test: with the surface sampled densely enough that visible
    surfels cover their pixel footprint, it converges to the rasterized
    depth map the reference captures (render_utils.py:116-126).
    """
    R_c2w, t = camera_extrinsics(cam_pos)
    cam = (xyz_world - t) @ R_c2w  # == R_c2w.T @ (p - t) per point
    z = cam[:, 2]
    ok = z > near
    u = np.round(cam[:, 0] / z * K[0, 0] + K[0, 2]).astype(np.int64)
    v = np.round(cam[:, 1] / z * K[1, 1] + K[1, 2]).astype(np.int64)
    ok &= (u >= 0) & (u < width) & (v >= 0) & (v < height)
    flat = np.where(ok, v * width + u, width * height)
    order = np.lexsort((z, flat))  # by pixel, nearest first
    flat_s = flat[order]
    first = np.ones(len(flat_s), bool)
    first[1:] = flat_s[1:] != flat_s[:-1]
    win = order[first & (flat_s < width * height)]
    depth = np.zeros(height * width, np.float32)
    winner = np.full(height * width, -1, np.int64)
    fw = flat[win]
    depth[fw] = z[win]
    winner[fw] = win
    return depth.reshape(height, width), winner.reshape(height, width)


def render_view_maps(
    asset_dir: str,
    camera_idx: int = 0,
    seed: Optional[int] = 0,
    width: int = WIDTH,
    height: int = HEIGHT,
    num_surface_samples: int = 1_000_000,
    base_link_name: str = "base",
    focus_category_ids: Optional[Sequence[int]] = None,
    distance_scale: float = 1.0,
) -> dict:
    """Labeled view maps of a raw asset, SAPIEN-free:

    random qpos + camera (render.py:41-52 semantics) -> FK posed surface
    samples -> z-buffer maps.  Returns dict(rgb, depth, sem, ins, npcs, K,
    cam_pos, R_c2w, qpos, category, model_id, valid_links, link_to_inst).
    """
    asset_dir = str(asset_dir)
    rng = np.random.RandomState(seed)
    with open(pjoin(asset_dir, "meta.json")) as f:
        meta = json.load(f)
    category = meta["model_cat"]
    model_id = meta.get("anno_id", os.path.basename(asset_dir))

    joints = read_joints_from_urdf_file(asset_dir, ANNOTATION_URDF)
    qpos = sample_joint_qpos(joints, rng)
    ranges = PARTNET_CAMERA_POSITION_RANGE[category][camera_idx]
    cam_pos = get_cam_pos(
        ranges["theta_min"], ranges["theta_max"],
        ranges["phi_min"], ranges["phi_max"],
        ranges["distance_min"] * distance_scale,
        ranges["distance_max"] * distance_scale, rng,
    )

    rest = link_rest_poses(joints, base_link_name)
    jstates = joint_world_states(joints, rest)
    target = load_target_links(asset_dir, "link_annotation_gapartnet.json")
    link_pose = fk_part_bboxes(target, joints, jstates, qpos, base_link_name)

    meshes = load_link_meshes(asset_dir)
    xyz, rgb, link_idx, links = sample_surface_points(
        meshes, num_surface_samples, rng
    )
    focus_link = None
    if focus_category_ids is not None:
        cands = [k for k, v in link_pose.items()
                 if v["category_id"] in tuple(focus_category_ids)
                 and k in meshes]
        if not cands:
            return dict(rgb=None, depth=None, sem=None, ins=None, npcs=None,
                        K=None, cam_pos=None, R_c2w=None, qpos=qpos,
                        category=category, model_id=model_id,
                        valid_links={}, link_to_inst={})
        focus_link = cands[rng.randint(len(cands))]
        # importance-sample the focus part: thin parts (a line_fixed_handle
        # is ~0.6% of the object's surface area) are surfel-starved in a
        # close-up — the z-buffer lets the surface BEHIND bleed through
        # between its sparse surfels.  Extra samples drawn on the focus
        # link alone make its pixel coverage dense at close range.
        fx, fr, _, _ = sample_surface_points(
            {focus_link: meshes[focus_link]}, num_surface_samples // 2, rng
        )
        xyz = np.concatenate([xyz, fx])
        rgb = np.concatenate([rgb, fr])
        link_idx = np.concatenate([
            link_idx,
            np.full(len(fx), links.index(focus_link), link_idx.dtype),
        ])
    affines = link_motion_affines(links, joints, jstates, qpos, base_link_name)
    posed = np.empty_like(xyz)
    for li, link in enumerate(links):
        A, b2 = affines[link]
        m = link_idx == li
        posed[m] = xyz[m] @ A + b2

    # part-focused close-up: recenter the WORLD on a random annotated part
    # of one of the requested categories, so the origin-orbiting camera
    # (distance already scaled by `distance_scale`) frames that part up
    # close.  A pure rigid world translation — FK, NPCS bboxes, and the
    # camera contract all live in the same shifted frame, so every
    # downstream map stays consistent.  This is the dataset-balance lever
    # the reference gets from its 26k-view scale and diversity: tiny part
    # classes (line_fixed_handle is 0.43% of points in distant views)
    # occupy a useful fraction of close-up frames.
    if focus_link is not None:
        center = np.asarray(
            link_pose[focus_link]["bbox"], np.float64
        ).mean(axis=0)
        posed = posed - center
        link_pose = {
            k: {"category_id": v["category_id"], "bbox": v["bbox"] - center}
            for k, v in link_pose.items()
        }

    K = camera_intrinsics(width, height)
    depth, winner = splat_zbuffer(posed, cam_pos, K, width, height)

    # seg maps through the reference's visual-id path (render_utils.py:165-202):
    # visual id := link index; -1 = others, -2 = empty background
    seg_by_vid = np.where(winner >= 0, link_idx[winner.clip(0)], -1).astype(
        np.int32
    )
    vis_id_to_link = {li: link for li, link in enumerate(links)}
    sem, ins, link_to_inst = seg_maps_from_visual_ids(
        seg_by_vid, {k: v for k, v in vis_id_to_link.items() if v in link_pose},
        link_pose, depth,
    )
    valid_links = {k: link_pose[k] for k in link_to_inst}

    rgb_img = np.zeros((height, width, 3), np.uint8)
    lit = winner >= 0
    rgb_img[lit] = (rgb[winner[lit]] * 255).clip(0, 255).astype(np.uint8)
    rgb_img = add_background_color(rgb_img, depth)

    R_c2w, t = camera_extrinsics(cam_pos)
    _, npcs = npcs_map_from_bboxes(
        depth, ins, {v: k for k, v in link_to_inst.items()}, valid_links,
        K, R_c2w, t,
    )
    return dict(
        rgb=rgb_img, depth=depth, sem=sem, ins=ins, npcs=npcs, K=K,
        cam_pos=cam_pos, R_c2w=R_c2w, qpos=qpos, category=category,
        model_id=model_id, valid_links=valid_links, link_to_inst=link_to_inst,
    )


def render_asset_view(
    asset_dir: str,
    save_path: str,
    camera_idx: int = 0,
    render_idx: int = 0,
    seed: Optional[int] = 0,
    num_points: int = 20000,
    save_maps: bool = False,
    device="cuda",
    **map_kwargs,
) -> Optional[str]:
    """One labeled view of a raw asset, end to end: render_view_maps ->

    converter (FPS on `device`) -> `{save_path}/pth/{name}.npz`.  Returns
    the sample name, or None when the view yields fewer than num_points
    foreground pixels (the converter's contract,
    convert_rendered_into_input.py:116).
    """
    m = render_view_maps(asset_dir, camera_idx=camera_idx, seed=seed,
                         **map_kwargs)
    if m["depth"] is None:  # focused render on an asset without that part
        return None
    name = f"{m['category']}_{m['model_id']}_{camera_idx:02d}_{render_idx:03d}"
    if save_maps:
        bbox_pose_dict = {
            k: dict(bbox=v["bbox"], category_id=v["category_id"],
                    instance_id=m["link_to_inst"][k])
            for k, v in m["valid_links"].items()
        }
        metafile = dict(
            model_id=m["model_id"], category=m["category"],
            camera_idx=camera_idx, render_idx=render_idx,
            width=m["depth"].shape[1], height=m["depth"].shape[0],
            joint_qpos=m["qpos"], camera_pos=m["cam_pos"].tolist(),
            camera_intrinsic=m["K"].reshape(-1).tolist(),
            world2camera_rotation=m["R_c2w"].reshape(-1).tolist(),
            camera2world_translation=m["cam_pos"].tolist(),
            target_gaparts=TARGET_GAPARTS, renderer="pointsplat",
        )
        save_render(save_path, name, m["rgb"], m["depth"], m["sem"], m["ins"],
                    m["npcs"], bbox_pose_dict, metafile)

    status = sample_and_save(
        name, m["rgb"], m["depth"], m["sem"], m["ins"], m["npcs"], m["K"],
        save_path, num_points=num_points, save_pth=False, device=device,
    )
    return name if status == 0 else None


def ingest_asset(
    asset_dir: str,
    save_path: str,
    num_views: int = 1,
    seed: int = 0,
    device="cuda",
    **view_kwargs,
) -> List[str]:
    """All-views loop for one asset directory (FPS on `device`); returns
    produced names."""
    names = []
    for ridx in range(num_views):
        n = render_asset_view(
            asset_dir, save_path, camera_idx=0, render_idx=ridx,
            seed=seed + ridx, device=device, **view_kwargs,
        )
        if n:
            names.append(n)
    return names
