"""Procedural synthetic articulated assets in the GAPartNet asset format
(the port's copy of datagen/synthetic.py: the same seed writes the same
bytes).

The environment ships exactly two real assets (reference `example_assets/`:
45780 StorageFurniture = hinge_door + line_fixed_handle, 102442 Camera =
slider_button), which cannot support the reference's two-level split
semantics (dataset/README.md:24-26: train/val/test_intra on seen categories,
test_inter on UNSEEN categories) — holding one real asset out of training
removes its part class from training entirely.

This module closes that gap: it writes procedurally generated articulated
objects (cabinets with hinged doors + line handles, button panels, microwave-
likes mixing all three classes) in the exact asset-directory format the
SAPIEN-free renderer consumes (datagen/assets.render_view_maps):

    meta.json                              {"model_cat", "anno_id"}
    mobility_annotation_gapartnet.urdf     links/joints/visual OBJ refs
    link_annotation_gapartnet.json         is_gapart + 8-corner rest bboxes
    textured_objs/*.obj (+ .mtl)           cuboid meshes

so train categories can carry every part class while a real category stays
fully held out for test_inter.  Everything downstream (URDF FK, surface
sampling, z-buffer splats, NPCS maps, the converter) is the existing tested
pipeline — synthetic assets are just more asset directories.

Bbox corner conventions are mirrored from the real annotations (verified on
45780/102442 link_annotation_gapartnet.json):

  * corners: 0..3 = top face (canon +z), 4..7 bottom; edge01 = canon x,
    edge12 = -canon y, edge04 = -canon z (datagen/pose.npcs_rts_from_bbox).
  * hinge_door:        e12 = hinge->free edge, e04 = inward face normal,
                       e01 = e12 x e04 (flips with hinge side, as the two
                       45780 doors do).
  * line_fixed_handle: e01 = long axis (+z for vertical bars), e04 = inward
                       normal, e12 = e04 x e01.
  * slider_button:     e04 = inward press direction, (e01, e12) span the
                       button face with e01 x e12 = e04.
"""

import dataclasses
import json
import os
from os.path import join as pjoin
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ANNOTATION_URDF = "mobility_annotation_gapartnet.urdf"


# ---------------------------------------------------------------------------
# cuboid OBJ writer
# ---------------------------------------------------------------------------

_CUBE_VERTS = np.array(
    [
        [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
        [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
    ],
    np.float64,
)
# 12 triangles, outward-facing (winding irrelevant to the point splatter)
_CUBE_FACES = np.array(
    [
        [0, 2, 1], [0, 3, 2],  # bottom
        [4, 5, 6], [4, 6, 7],  # top
        [0, 1, 5], [0, 5, 4],  # -y
        [2, 3, 7], [2, 7, 6],  # +y
        [0, 4, 7], [0, 7, 3],  # -x
        [1, 2, 6], [1, 6, 5],  # +x
    ],
    np.int64,
)


def write_cuboid_obj(
    path: str, center: np.ndarray, half: np.ndarray, color: np.ndarray
) -> None:
    """Axis-aligned cuboid mesh (vertices in the owning link's frame)."""
    verts = _CUBE_VERTS * np.asarray(half) + np.asarray(center)
    name = os.path.splitext(os.path.basename(path))[0]
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    with open(mtl_path, "w") as f:
        f.write(f"newmtl {name}\n")
        f.write(f"Kd {color[0]:.4f} {color[1]:.4f} {color[2]:.4f}\n")
    with open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl_path)}\nusemtl {name}\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in _CUBE_FACES + 1:
            f.write(f"f {a} {b} {c}\n")


# ---------------------------------------------------------------------------
# bbox corner conventions (derived from the real annotations — module doc)
# ---------------------------------------------------------------------------

def corners_from_edges(
    center: np.ndarray, e01: np.ndarray, e12: np.ndarray, e04: np.ndarray
) -> np.ndarray:
    """8 corners from the center + three FULL edge vectors.

    e01 = corner0->corner1, e12 = corner1->corner2, e04 = corner0->corner4;
    (e01, -e12, -e04) must be right-handed for npcs_rts_from_bbox to recover
    a proper rotation.
    """
    ex, ey, ez = np.asarray(e01), -np.asarray(e12), -np.asarray(e04)
    assert np.linalg.det(np.stack([ex, ey, ez])) > 0, "left-handed bbox frame"
    c = np.asarray(center, np.float64)
    out = np.empty((8, 3))
    for i, (sx, sy, sz) in enumerate(
        [(-1, 1, 1), (1, 1, 1), (1, -1, 1), (-1, -1, 1),
         (-1, 1, -1), (1, 1, -1), (1, -1, -1), (-1, -1, -1)]
    ):
        out[i] = c + 0.5 * (sx * ex + sy * ey + sz * ez)
    return out


def door_bbox(center, height, width_vec, normal_in) -> np.ndarray:
    """hinge_door: width_vec = FULL hinge->free edge vector, normal_in =
    FULL-thickness inward normal vector; e01 = z-height edge oriented so
    e01 = e12 x e04 (unit sense)."""
    e12 = np.asarray(width_vec, np.float64)
    e04 = np.asarray(normal_in, np.float64)
    d = np.cross(e12 / np.linalg.norm(e12), e04 / np.linalg.norm(e04))
    return corners_from_edges(center, d * height, e12, e04)


def handle_bbox(center, long_vec, normal_in, thin: float) -> np.ndarray:
    """line_fixed_handle: long_vec = FULL long-axis edge, normal_in =
    FULL protrusion-depth inward vector, thin = face width."""
    e01 = np.asarray(long_vec, np.float64)
    e04 = np.asarray(normal_in, np.float64)
    d = np.cross(e04 / np.linalg.norm(e04), e01 / np.linalg.norm(e01))
    return corners_from_edges(center, e01, d * thin, e04)


def button_bbox(center, face_a, face_b, press_in) -> np.ndarray:
    """slider_button: (face_a, face_b) span the face, press_in = FULL
    protrusion inward vector; e01 x e12 = e04 enforced by flipping face_b."""
    e01 = np.asarray(face_a, np.float64)
    e12 = np.asarray(face_b, np.float64)
    e04 = np.asarray(press_in, np.float64)
    x = np.cross(e01 / np.linalg.norm(e01), e12 / np.linalg.norm(e12))
    if np.dot(x, e04) < 0:
        e12 = -e12
    return corners_from_edges(center, e01, e12, e04)


# ---------------------------------------------------------------------------
# asset assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Link:
    name: str
    parent: str                      # parent LINK name
    joint_type: str                  # fixed | revolute | prismatic
    joint_xyz: np.ndarray            # joint origin in parent link frame
    joint_axis: Optional[np.ndarray] = None
    joint_limit: Optional[Tuple[float, float]] = None
    # visuals: (center, half_extents, color) cuboids in THIS link's frame
    visuals: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = dataclasses.field(
        default_factory=list
    )
    part_category: Optional[str] = None
    bbox: Optional[np.ndarray] = None  # (8, 3) rest-pose WORLD frame


def write_asset(
    out_dir: str, category: str, model_id: str, links: Sequence[Link]
) -> str:
    """Write the asset directory; returns out_dir.

    All joint origins are pure translations (rpy 0) — rest world position of
    link L = sum of joint_xyz down its chain, which the archetype functions
    use to express bboxes in world frame directly.
    """
    os.makedirs(pjoin(out_dir, "textured_objs"), exist_ok=True)
    with open(pjoin(out_dir, "meta.json"), "w") as f:
        json.dump({"model_cat": category, "anno_id": model_id}, f)

    lines = ['<?xml version="1.0" ?>', f'<robot name="synth_{model_id}">',
             '  <link name="base"/>']
    n_obj = 0
    anno = []
    for link in links:
        lines.append(f'  <link name="{link.name}">')
        for center, half, color in link.visuals:
            obj_rel = f"textured_objs/synth-{n_obj}.obj"
            write_cuboid_obj(pjoin(out_dir, obj_rel), center, half, color)
            n_obj += 1
            lines += [
                f'    <visual name="{link.name}_v{n_obj}">',
                "      <geometry>",
                f'        <mesh filename="{obj_rel}"/>',
                "      </geometry>",
                "    </visual>",
            ]
        lines.append("  </link>")
        x, y, z = link.joint_xyz
        lines += [
            f'  <joint name="joint_{link.name}" type="{link.joint_type}">',
            f'    <origin xyz="{x:.6f} {y:.6f} {z:.6f}"/>',
            f'    <child link="{link.name}"/>',
            f'    <parent link="{link.parent}"/>',
        ]
        if link.joint_axis is not None:
            a = link.joint_axis
            lines.append(f'    <axis xyz="{a[0]:.6f} {a[1]:.6f} {a[2]:.6f}"/>')
        if link.joint_limit is not None:
            lo, hi = link.joint_limit
            lines.append(f'    <limit lower="{lo:.6f}" upper="{hi:.6f}"/>')
        lines.append("  </joint>")
        anno.append(
            {
                "link_name": link.name,
                "is_gapart": link.part_category is not None,
                "category": link.part_category or "",
                "bbox": link.bbox.tolist() if link.bbox is not None else [],
            }
        )
    lines.append("</robot>")
    with open(pjoin(out_dir, ANNOTATION_URDF), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(pjoin(out_dir, "link_annotation_gapartnet.json"), "w") as f:
        json.dump(anno, f)
    return out_dir


def _color(rng) -> np.ndarray:
    return rng.uniform(0.15, 0.9, 3)


# ---------------------------------------------------------------------------
# archetype constructors.  World frame: z up, object front faces -x (the
# reference camera ranges for these categories put phi in [120, 240] deg,
# i.e. the camera orbits the -x side).  Objects are roughly origin-centered
# at the ~1.5 m scale of the real normalized assets.
# ---------------------------------------------------------------------------

def _add_door_with_handle(
    links: List[Link], rng, body: str, front_x: float, y_lo: float,
    y_hi: float, z_lo: float, z_hi: float, hinge_side: str, idx: int,
    with_handle: bool = True,
) -> None:
    """Hinged door panel on the -x front face spanning [y_lo, y_hi] x
    [z_lo, z_hi], plus an optional line handle near the free edge."""
    t = rng.uniform(0.02, 0.04)              # panel thickness
    width = y_hi - y_lo
    height = z_hi - z_lo
    zc = 0.5 * (z_lo + z_hi)
    hinge_y = y_lo if hinge_side == "lo" else y_hi
    sgn = 1.0 if hinge_side == "lo" else -1.0  # hinge->free edge direction
    # door link origin = hinge line; axis z (vertical hinge)
    max_open = rng.uniform(0.7, 1.5)
    # opening outward from the -x face: for a hinge at y_lo the panel swings
    # negative around +z; keep limits one-sided from the closed pose
    lim = (0.0, max_open) if hinge_side == "lo" else (-max_open, 0.0)
    door = Link(
        name=f"door_{idx}", parent=body, joint_type="revolute",
        joint_xyz=np.array([front_x, hinge_y, 0.0]),
        joint_axis=np.array([0.0, 0.0, 1.0]), joint_limit=lim,
        part_category="hinge_door",
    )
    # panel cuboid in the door-link frame (origin at hinge line, z=0 at
    # object mid-height)
    panel_c = np.array([-t / 2, sgn * width / 2, zc])
    panel_h = np.array([t / 2, width / 2, height / 2])
    door.visuals.append((panel_c, panel_h, _color(rng)))
    # rest world bbox: door frame == world frame shifted by joint origin
    world_c = panel_c + door.joint_xyz
    door.bbox = door_bbox(
        world_c, height,
        width_vec=np.array([0.0, sgn * width, 0.0]),
        normal_in=np.array([t, 0.0, 0.0]),
    )
    links.append(door)

    if not with_handle:
        return
    # vertical line handle near the free edge, protruding -x
    hl = rng.uniform(0.25, 0.55) * height
    hw = rng.uniform(0.015, 0.03)
    hd = rng.uniform(0.03, 0.06)             # protrusion depth
    hy = sgn * (width - rng.uniform(0.06, 0.12) * width)  # near free edge
    hc = np.array([-t - hd / 2, hy, zc + rng.uniform(-0.1, 0.1) * height])
    handle = Link(
        name=f"handle_{idx}", parent=door.name, joint_type="fixed",
        joint_xyz=np.zeros(3), part_category="line_fixed_handle",
    )
    handle.visuals.append((hc, np.array([hd / 2, hw, hl / 2]), _color(rng)))
    wc = hc + door.joint_xyz
    handle.bbox = handle_bbox(
        wc, long_vec=np.array([0.0, 0.0, hl]),
        normal_in=np.array([hd, 0.0, 0.0]), thin=2 * hw,
    )
    links.append(handle)


def _add_button(
    links: List[Link], rng, body: str, center: np.ndarray, half_face: float,
    face: str, idx: int,
) -> None:
    """slider_button cuboid protruding from the -x front ("front") or +z top
    ("top") face at `center` (a point ON the face), prismatic press axis."""
    h = rng.uniform(0.012, 0.025)            # protrusion height
    a = half_face * rng.uniform(0.7, 1.0)
    b = half_face * rng.uniform(0.7, 1.0)
    travel = h * rng.uniform(0.5, 0.9)
    if face == "front":
        axis = np.array([1.0, 0.0, 0.0])     # press inward = +x
        c = center + np.array([-h / 2, 0.0, 0.0])
        half = np.array([h / 2, a, b])
        face_a = np.array([0.0, -2 * a, 0.0])
        face_b = np.array([0.0, 0.0, 2 * b])
        press = np.array([h, 0.0, 0.0])
    else:                                    # top face, press inward = -z
        axis = np.array([0.0, 0.0, -1.0])
        c = center + np.array([0.0, 0.0, h / 2])
        half = np.array([a, b, h / 2])
        face_a = np.array([2 * a, 0.0, 0.0])
        face_b = np.array([0.0, -2 * b, 0.0])
        press = np.array([0.0, 0.0, -h])
    btn = Link(
        name=f"button_{idx}", parent=body, joint_type="prismatic",
        joint_xyz=np.zeros(3), joint_axis=axis, joint_limit=(0.0, travel),
        part_category="slider_button",
    )
    btn.visuals.append((c, half, _color(rng)))
    btn.bbox = button_bbox(c, face_a, face_b, press)
    links.append(btn)


def build_cabinet(out_dir: str, model_id: str, seed: int) -> str:
    """'Box' category: cuboid body + 1-2 hinged front doors with handles."""
    rng = np.random.RandomState(seed)
    dx = rng.uniform(0.6, 0.9)
    dy = rng.uniform(0.7, 1.1)
    dz = rng.uniform(0.9, 1.5)
    body = Link(
        name="body", parent="base", joint_type="fixed", joint_xyz=np.zeros(3)
    )
    body.visuals.append(
        (np.zeros(3), np.array([dx / 2, dy / 2, dz / 2]), _color(rng))
    )
    links = [body]
    n_doors = int(rng.randint(1, 3))
    margin = rng.uniform(0.03, 0.08)
    z_lo, z_hi = -dz / 2 + margin, dz / 2 - margin
    if n_doors == 1:
        _add_door_with_handle(
            links, rng, "body", -dx / 2, -dy / 2 + margin, dy / 2 - margin,
            z_lo, z_hi, hinge_side=("lo" if rng.rand() < 0.5 else "hi"), idx=0,
        )
    else:
        _add_door_with_handle(
            links, rng, "body", -dx / 2, -dy / 2 + margin, -0.01,
            z_lo, z_hi, hinge_side="lo", idx=0,
        )
        _add_door_with_handle(
            links, rng, "body", -dx / 2, 0.01, dy / 2 - margin,
            z_lo, z_hi, hinge_side="hi", idx=1,
        )
    return write_asset(out_dir, "Box", model_id, links)


def build_button_panel(out_dir: str, model_id: str, seed: int) -> str:
    """'Remote' category: standing slab + grid of slider buttons."""
    rng = np.random.RandomState(seed)
    dx = rng.uniform(0.15, 0.25)
    dy = rng.uniform(0.5, 0.8)
    dz = rng.uniform(1.1, 1.6)
    body = Link(
        name="body", parent="base", joint_type="fixed", joint_xyz=np.zeros(3)
    )
    body.visuals.append(
        (np.zeros(3), np.array([dx / 2, dy / 2, dz / 2]), _color(rng))
    )
    links = [body]
    rows = int(rng.randint(2, 5))
    cols = int(rng.randint(2, 4))
    pitch_y = dy / (cols + 1)
    pitch_z = dz * 0.7 / rows
    half_face = min(pitch_y, pitch_z) * rng.uniform(0.22, 0.3)
    idx = 0
    for r in range(rows):
        for cidx in range(cols):
            center = np.array(
                [
                    -dx / 2,
                    -dy / 2 + (cidx + 1) * pitch_y,
                    dz * 0.35 - (r + 0.5) * pitch_z,
                ]
            )
            _add_button(links, rng, "body", center, half_face, "front", idx)
            idx += 1
    return write_asset(out_dir, "Remote", model_id, links)


def build_microwave(out_dir: str, model_id: str, seed: int) -> str:
    """'Microwave' category (inter-split holdout archetype): body + one wide
    door with a handle + a column of buttons beside it — all three part
    classes on one unseen-category object."""
    rng = np.random.RandomState(seed)
    dx = rng.uniform(0.7, 1.0)
    dy = rng.uniform(1.1, 1.5)
    dz = rng.uniform(0.6, 0.9)
    body = Link(
        name="body", parent="base", joint_type="fixed", joint_xyz=np.zeros(3)
    )
    body.visuals.append(
        (np.zeros(3), np.array([dx / 2, dy / 2, dz / 2]), _color(rng))
    )
    links = [body]
    margin = rng.uniform(0.03, 0.06)
    strip = rng.uniform(0.22, 0.3) * dy      # button strip on the +y side
    _add_door_with_handle(
        links, rng, "body", -dx / 2, -dy / 2 + margin, dy / 2 - strip,
        -dz / 2 + margin, dz / 2 - margin, hinge_side="lo", idx=0,
    )
    n_btn = int(rng.randint(2, 5))
    by = dy / 2 - strip / 2
    half_face = strip * rng.uniform(0.12, 0.18)
    for i in range(n_btn):
        bz = dz * 0.35 - i * (dz * 0.7 / n_btn)
        if rng.rand() < 0.25:  # occasionally a top-face button
            _add_button(
                links, rng, "body",
                np.array([rng.uniform(-dx * 0.3, dx * 0.3), by, dz / 2]),
                half_face, "top", i + 1,
            )
        else:
            _add_button(
                links, rng, "body", np.array([-dx / 2, by, bz]),
                half_face, "front", i + 1,
            )
    return write_asset(out_dir, "Microwave", model_id, links)


ARCHETYPES = {
    "Box": build_cabinet,
    "Remote": build_button_panel,
    "Microwave": build_microwave,
}


def generate_assets(
    root: str, per_category: Dict[str, int], seed: int = 0
) -> List[str]:
    """Write `per_category[cat]` randomized instances of each archetype under
    `root/<cat>_<i>/`; returns the asset directories."""
    out = []
    k = 0
    for cat, n in per_category.items():
        build = ARCHETYPES[cat]
        for i in range(n):
            d = pjoin(root, f"{cat}_{i}")
            build(d, model_id=f"9{seed % 10}{k:04d}", seed=seed * 1000 + k)
            out.append(d)
            k += 1
    return out
