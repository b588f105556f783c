#!/usr/bin/env python
"""Offline visualizer for rendered dataset outputs, in the PyTorch port
(counterpart of tools/visualize_render.py, with its own copy of the color
tables; NumPy, with cv2 and open3d imported only where they are used).

Equivalent of dataset/render_tools/visualize.py: cv2 2D panels (depth
colormap, semantic / instance maps, NPCS map, projected part bboxes) plus,
with --view3d, the reference's 3D point-cloud-with-bboxes views
(visu_utils.py:219-262): interactive open3d windows when open3d + a display
are available, and a headless PLY export (point cloud + bbox edge line
sets) otherwise, viewable in any mesh viewer.

    python -m gapartnet_tpu_torch.tools.visualize_render \
        --render_dir example_rendered --name Box_100_0_0 --out visu_render \
        [--view3d] [--device cuda|cpu]

The tool does its work on the host; `--device` is checked as every entry
point of the port checks it (cuda without a card raises).
"""

import argparse
import json
from pathlib import Path

import numpy as np

from gapartnet_tpu_torch.utils.visu import COLOR20, OTHER_COLOR


def colorize_seg(seg: np.ndarray) -> np.ndarray:
    h, w = seg.shape
    img = np.zeros((h, w, 3), np.uint8)
    img[seg == -2] = (255, 255, 255)
    img[seg == -1] = OTHER_COLOR
    for v in np.unique(seg):
        if v >= 0:
            img[seg == v] = COLOR20[v % len(COLOR20)]
    return img


def backproject_world(depth: np.ndarray, K: np.ndarray, w2c: np.ndarray,
                      t: np.ndarray, rgb=None):
    """Depth map -> world-frame point cloud (+ colors in [0, 1]).

    Inverse of the projection used for the bbox overlay below (reference
    visu_utils.get_recovery_whole_point_cloud_camera semantics).
    """
    h, w = depth.shape
    yy, xx = np.mgrid[0:h, 0:w]
    valid = depth > 0
    z = depth[valid]
    x = (xx[valid] - K[0, 2]) * z / K[0, 0]
    y = (yy[valid] - K[1, 2]) * z / K[1, 1]
    cam = np.stack([x, y, z], -1)
    world = cam @ w2c.T + t      # cam = (world - t) @ w2c, w2c orthogonal
    colors = None
    if rgb is not None:
        colors = rgb[valid][:, ::-1].astype(np.float64) / 255.0  # BGR -> RGB
    return world, colors


_BBOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
               (0, 4), (1, 5), (2, 6), (3, 7)]


def _write_ply(path, points, colors=None, edges=None):
    """Minimal ASCII PLY writer: vertices (+colors) and optional edges."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        if edges:
            f.write(f"element edge {len(edges)}\n")
            f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for i, p in enumerate(points):
            row = f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}"
            if colors is not None:
                c = (np.clip(colors[i], 0, 1) * 255).astype(int)
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")
        for a, b in edges or ():
            f.write(f"{a} {b}\n")


def view_3d(out, name, depth, K, w2c, t, bboxes, rgb=None):
    """3D point cloud + part bboxes: open3d windows when available
    (reference visu_point_cloud_with_bbox_*), PLY files headless."""
    pts, colors = backproject_world(depth, K, w2c, t, rgb)
    corner_sets = [np.array(link["bbox"]) for link in bboxes.values()]
    try:
        import open3d as o3d

        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(pts)
        if colors is not None:
            pcd.colors = o3d.utility.Vector3dVector(colors)
        geoms = [pcd, o3d.geometry.TriangleMesh.create_coordinate_frame()]
        for corners in corner_sets:
            ls = o3d.geometry.LineSet()
            ls.points = o3d.utility.Vector3dVector(corners)
            ls.lines = o3d.utility.Vector2iVector(_BBOX_EDGES)
            ls.colors = o3d.utility.Vector3dVector(
                [[1.0, 0.0, 1.0]] * len(_BBOX_EDGES)
            )
            geoms.append(ls)
        o3d.visualization.draw_geometries(geoms)
        return "open3d"
    except Exception:
        _write_ply(out / f"{name}_pc_world.ply", pts, colors)
        box_pts, box_edges = [], []
        for corners in corner_sets:
            base = len(box_pts)
            box_pts.extend(corners.tolist())
            box_edges.extend([(base + a, base + b) for a, b in _BBOX_EDGES])
        if box_pts:
            _write_ply(out / f"{name}_bboxes.ply", np.asarray(box_pts),
                       edges=box_edges)
        return "ply"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--render_dir", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--out", default="visu_render")
    ap.add_argument("--view3d", action="store_true",
                    help="3D views (open3d if available, else PLY export)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from gapartnet_tpu_torch.tools import resolve_device

    resolve_device(args.device)
    import cv2

    rd = Path(args.render_dir)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    depth = np.load(rd / "depth" / f"{args.name}.npz")["depth_map"]
    seg = np.load(rd / "segmentation" / f"{args.name}.npz")
    npcs = np.load(rd / "npcs" / f"{args.name}.npz")["npcs_map"]
    with open(rd / "metafile" / f"{args.name}.json") as f:
        meta = json.load(f)
    K = np.array(meta["camera_intrinsic"]).reshape(3, 3)

    # depth colormap
    d = depth.copy()
    valid = d > 0
    if valid.any():
        d[valid] = (d[valid] - d[valid].min()) / max(np.ptp(d[valid]), 1e-6)
    depth_img = cv2.applyColorMap((d * 255).astype(np.uint8), cv2.COLORMAP_JET)
    depth_img[~valid] = 255
    cv2.imwrite(str(out / f"{args.name}_depth.png"), depth_img)

    cv2.imwrite(
        str(out / f"{args.name}_sem.png"),
        colorize_seg(seg["semantic_segmentation"])[..., ::-1],
    )
    cv2.imwrite(
        str(out / f"{args.name}_ins.png"),
        colorize_seg(seg["instance_segmentation"])[..., ::-1],
    )
    npcs_img = np.clip((npcs + 1) / 2 * 255, 0, 255).astype(np.uint8)
    cv2.imwrite(str(out / f"{args.name}_npcs.png"), npcs_img[..., ::-1])

    # bbox overlay: project world-frame corners through the camera
    rgb_path = rd / "rgb" / f"{args.name}.png"
    img = cv2.imread(str(rgb_path)) if rgb_path.exists() else depth_img.copy()
    with open(rd / "bbox" / f"{args.name}.json") as f:
        bboxes = json.load(f)
    w2c = np.array(meta["world2camera_rotation"]).reshape(3, 3)
    t = np.array(meta["camera2world_translation"])
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    for link in bboxes.values():
        corners = np.array(link["bbox"])
        cam = (corners - t) @ w2c  # world -> camera (inverse of pose.py map)
        z = np.maximum(cam[:, 2], 1e-6)
        px = (cam[:, 0] * K[0, 0] / z + K[0, 2]).astype(int)
        py = (cam[:, 1] * K[1, 1] / z + K[1, 2]).astype(int)
        for a, b in edges:
            cv2.line(img, (px[a], py[a]), (px[b], py[b]), (255, 0, 255), 2)
    cv2.imwrite(str(out / f"{args.name}_bbox.png"), img)
    if args.view3d:
        rgb = cv2.imread(str(rgb_path)) if rgb_path.exists() else None
        mode = view_3d(out, args.name, depth, K, w2c, t, bboxes, rgb)
        print(f"[visualize_render] 3D view via {mode}")
    print(f"[visualize_render] wrote panels for {args.name} under {out}")


if __name__ == "__main__":
    main()
