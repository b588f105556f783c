"""Qualitative visualization of predictions (counterpart of utils/visu.py,
its own copy: the port imports nothing of the JAX package).

Projects the ball-normalized cloud back into the image plane through the
fixed GAPartNet render intrinsic (f = 1268.638, 800x800), paints semantic,
instance and NPCS maps and draws oriented 9-DoF boxes, panel for panel as
the JAX package does (the reference's misc/visu.py:35-261).  Projection
and splatting are NumPy; drawing and writing use cv2, imported only inside
the functions that draw or write (`have_cv2` says whether it is there).
"""

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

WIDTH = 800
HEIGHT = 800
FOCAL = 1268.637939453125  # misc/visu_util.py:107-110

# 20-color instance palette + per-class colors (visu layer convention)
COLOR20 = np.array(
    [[0, 128, 128], [230, 190, 255], [170, 110, 40], [255, 250, 200], [128, 0, 0],
     [170, 255, 195], [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128],
     [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200], [245, 130, 48],
     [145, 30, 180], [70, 240, 240], [240, 50, 230], [210, 245, 60], [250, 190, 190]],
    np.uint8,
)
OTHER_COLOR = np.array([230, 230, 230], np.uint8)

# bbox wireframe edges for the corner order produced by
# ops/umeyama.ransac_pose_from_npcs (signs enumeration; matches
# misc/pose_fitting.py:135-144 corner order)
BBOX_EDGES = [
    (0, 1), (0, 2), (0, 3), (1, 4), (1, 5), (2, 6),
    (6, 3), (4, 7), (5, 7), (3, 5), (2, 4), (6, 7),
]


def have_cv2() -> bool:
    """Whether cv2, which draws boxes and writes the panels, is importable."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def project_points(pts: np.ndarray, trans: Optional[np.ndarray] = None):
    """(N, 3) ball-space points -> integer pixel (y, x); trans =

    [max_radius, cx, cy, cz] undoes ball normalization first."""
    p = np.asarray(pts, np.float64)
    if trans is not None:
        p = p * trans[0] + trans[1:4]
    z = p[:, 2]
    x_pix = np.rint(p[:, 0] * FOCAL / z + WIDTH / 2).astype(np.int64)
    y_pix = np.rint(p[:, 1] * FOCAL / z + HEIGHT / 2).astype(np.int64)
    return y_pix, x_pix


def map2image(pts: np.ndarray, rgb: np.ndarray, trans: Optional[np.ndarray] = None):
    """Splat colored points into an 800x800 image with a 2x2 footprint

    (misc/visu_util.py:107-141 semantics), vectorized."""
    img = np.full((HEIGHT, WIDTH, 3), 255, np.uint8)
    y, x = project_points(pts, trans)
    ok = (y >= 0) & (y + 1 < HEIGHT) & (x >= 0) & (x + 1 < WIDTH)
    y, x, c = y[ok], x[ok], np.asarray(rgb, np.uint8)[ok]
    for dy in (0, 1):
        for dx in (0, 1):
            img[y + dy, x + dx] = c
    return img


def draw_bbox(img: np.ndarray, bbox_list: Sequence[np.ndarray],
              trans: Optional[np.ndarray] = None):
    """Draw oriented boxes as wireframes with RGB-coded first-corner axes

    (misc/visu_util.py:37-71 semantics)."""
    import cv2

    for bbox in bbox_list:
        if len(bbox) == 0:
            continue
        y, x = project_points(np.asarray(bbox), trans)
        pix = list(zip(x.tolist(), y.tolist()))
        for a, b in BBOX_EDGES:
            cv2.line(img, pix[a], pix[b], color=(255, 0, 255), thickness=2)
        cv2.line(img, pix[0], pix[1], color=(0, 0, 255), thickness=3)
        cv2.line(img, pix[0], pix[3], color=(255, 0, 0), thickness=3)
        cv2.line(img, pix[0], pix[2], color=(0, 255, 0), thickness=3)
    return img


def colorize_sem(sem: np.ndarray) -> np.ndarray:
    c = np.empty((len(sem), 3), np.uint8)
    c[:] = OTHER_COLOR
    m = sem > 0
    c[m] = COLOR20[(sem[m] - 1) % len(COLOR20)]
    return c


def colorize_ins(ins: np.ndarray) -> np.ndarray:
    c = np.empty((len(ins), 3), np.uint8)
    c[:] = OTHER_COLOR
    m = ins > 0
    c[m] = COLOR20[(ins[m] - 1) % len(COLOR20)]
    return c


def colorize_npcs(npcs: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(npcs) * 255.0, 0, 255).astype(np.uint8)


# the reference's full 12-panel option list (misc/visu.py:66-251)
ALL_SAVE_OPTIONS = (
    "raw", "pc", "sem_pred", "ins_pred", "npcs_pred", "bbox_pred",
    "bbox_pred_pure", "sem_gt", "ins_gt", "npcs_gt", "bbox_gt",
    "bbox_gt_pure",
)


def montage(panels: Dict[str, np.ndarray], order: Sequence[str],
            cols: int = 4) -> np.ndarray:
    """Tile the panels into one labeled grid image (the reference's
    `final_img` composite, misc/visu.py:60-255: panels laid out row-major
    with the option name drawn above each)."""
    import cv2

    keys = [k for k in order if k in panels]
    if not keys:
        return np.full((HEIGHT, WIDTH, 3), 255, np.uint8)
    rows = (len(keys) + cols - 1) // cols
    pad = 40  # text band above each tile (reference X_START offset)
    out = np.full((rows * (HEIGHT + pad), cols * WIDTH, 3), 255, np.uint8)
    for i, k in enumerate(keys):
        r, c = divmod(i, cols)
        y0 = r * (HEIGHT + pad)
        out[y0 + pad:y0 + pad + HEIGHT, c * WIDTH:(c + 1) * WIDTH] = panels[k]
        cv2.putText(out, k, (c * WIDTH + 10, y0 + 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 1.0, (0, 0, 0), 2)
    return out


def visualize_gapartnet(
    save_root: str,
    name: str,
    split: str,
    points: np.ndarray,                 # (N, 6) xyz + rgb in [0,1]
    trans: Optional[np.ndarray] = None,
    sem_preds: Optional[np.ndarray] = None,
    ins_preds: Optional[np.ndarray] = None,
    npcs_preds: Optional[np.ndarray] = None,
    bboxes: Optional[List[np.ndarray]] = None,
    sem_gt: Optional[np.ndarray] = None,
    ins_gt: Optional[np.ndarray] = None,
    npcs_gt: Optional[np.ndarray] = None,
    gt_bboxes: Optional[List[np.ndarray]] = None,
    save_option: Sequence[str] = ALL_SAVE_OPTIONS,
    raw_img: Optional[np.ndarray] = None,
    raw_img_root: Optional[str] = None,
    write_montage: bool = True,
) -> Dict[str, np.ndarray]:
    """Multi-panel dump (misc/visu.py:35-261 semantics: one image per

    requested option under save_root/split/<option>/name.png, plus the
    labeled grid composite save_root/split/name.png).  The "raw" panel is
    the camera RGB render: pass it directly (`raw_img`, e.g. from the
    SAPIEN-free splat renderer) or let it be looked up as
    `{raw_img_root}/{name}.png` (the reference RAW_IMG_ROOT mechanism,
    misc/visu.py:66-77).  Returns the rendered images keyed by option;
    writing requires cv2."""
    import cv2

    xyz = points[:, :3]
    rgb255 = np.clip(points[:, 3:6] * 255, 0, 255).astype(np.uint8)
    panels: Dict[str, np.ndarray] = {}

    def add(option, colors, boxes=None):
        img = map2image(xyz, colors, trans)
        if boxes is not None:
            img = draw_bbox(img, boxes, trans)
        panels[option] = img

    if "raw" in save_option:
        if raw_img is None and raw_img_root is not None:
            p = Path(raw_img_root) / f"{name}.png"
            if p.exists():
                raw_img = cv2.imread(str(p))[..., ::-1]  # BGR -> RGB
        if raw_img is not None:
            img = np.asarray(raw_img, np.uint8)
            if img.shape[:2] != (HEIGHT, WIDTH):
                img = cv2.resize(img, (WIDTH, HEIGHT))
            panels["raw"] = img
    if "pc" in save_option:
        add("pc", rgb255)
    if "sem_pred" in save_option and sem_preds is not None:
        add("sem_pred", colorize_sem(sem_preds))
    if "ins_pred" in save_option and ins_preds is not None:
        add("ins_pred", colorize_ins(ins_preds))
    if "npcs_pred" in save_option and npcs_preds is not None:
        add("npcs_pred", colorize_npcs(npcs_preds))
    if "bbox_pred" in save_option and bboxes is not None:
        add("bbox_pred", rgb255, boxes=bboxes)
    if "bbox_pred_pure" in save_option and bboxes is not None:
        panels["bbox_pred_pure"] = draw_bbox(
            np.full((HEIGHT, WIDTH, 3), 255, np.uint8), bboxes, trans
        )
    if "sem_gt" in save_option and sem_gt is not None:
        add("sem_gt", colorize_sem(sem_gt))
    if "ins_gt" in save_option and ins_gt is not None:
        add("ins_gt", colorize_ins(ins_gt + 1))
    if "npcs_gt" in save_option and npcs_gt is not None:
        add("npcs_gt", colorize_npcs(npcs_gt))
    if "bbox_gt" in save_option and gt_bboxes is not None:
        add("bbox_gt", rgb255, boxes=gt_bboxes)
    if "bbox_gt_pure" in save_option and gt_bboxes is not None:
        panels["bbox_gt_pure"] = draw_bbox(
            np.full((HEIGHT, WIDTH, 3), 255, np.uint8), gt_bboxes, trans
        )

    for option, img in panels.items():
        d = Path(save_root) / split / option
        d.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(d / f"{name}.png"), img[..., ::-1])  # RGB -> BGR
    if write_montage and panels:
        grid = montage(panels, ALL_SAVE_OPTIONS)
        d = Path(save_root) / split
        d.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(d / f"{name}.png"), grid[..., ::-1])
    return panels
