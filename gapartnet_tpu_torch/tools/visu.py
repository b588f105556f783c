"""Standalone visualization tool of the PyTorch port (counterpart of
tools/visu.py): load a checkpoint of the port's trainer, run inference on a
.pth/.npz cloud (or a real-world OBJ with vertex colors, sampled to
max_points by FPS and ball-normalised), and write the panel images (sem /
ins / npcs / bbox, and the ground truth of a labelled cloud):

    python -m gapartnet_tpu_torch.tools.visu --input cloud.npz [--ckpt CKPT] \\
        [--out visu_out] [--device cuda|cpu]
    python -m gapartnet_tpu_torch.tools.visu --obj scan.obj --ckpt checkpoints/last

Without --ckpt the weights are random (seed 0).  The device's work
(loading, FPS, predict) is `run`; drawing and writing the panels is
`write_panels`, with cv2, which raises if cv2 is not installed.
"""

import argparse
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

SAVE_OPTION = ("pc", "sem_pred", "ins_pred", "npcs_pred", "bbox_pred", "bbox_pred_pure",
               "sem_gt", "ins_gt", "npcs_gt")


def load_obj_points(path: str) -> np.ndarray:
    """Read 'v x y z r g b' lines from an OBJ (misc/visu_util.OBJfile2points
    semantics)."""
    pts = []
    with open(path) as f:
        for line in f:
            s = line.split()
            if not s:
                continue
            if s[0] == "v":
                pts.append([float(x) for x in s[1:7]])
            elif s[0] == "vt":
                break
    return np.asarray(pts, np.float32)


def write_obj(path, xyz, rgb):
    """'v x y z r g b' lines, as load_obj_points reads them."""
    with open(path, "w") as f:
        f.write("# v x y z r g b\n")
        np.savetxt(f, np.concatenate([xyz, rgb], axis=1), fmt="v %.6f %.6f %.6f %.6f %.6f %.6f")


class VisuRun(NamedTuple):
    """What `run` produced: the network's input cloud, the OBJ's
    normalisation and FPS indices (None for a dataset cloud), the
    ground-truth panels' arrays and the prediction."""

    name: str
    points: np.ndarray            # (N, 6) ball-normalised xyz + rgb
    trans: Optional[np.ndarray]   # [max_radius, cx, cy, cz] of an OBJ
    index: Optional[np.ndarray]   # FPS indices into the OBJ's vertices
    gt: dict
    result: object                # infer.api.InferenceResult


def run(input: str = "", obj: str = "", ckpt: str = "", name: str = "",
        device="cuda") -> VisuRun:
    """Load the model (`GAPartNetInference(ckpt_path=ckpt or None)`) and
    the cloud, and predict, on `device`."""
    from gapartnet_tpu_torch.infer import api
    from gapartnet_tpu_torch.tools import resolve_device

    device = resolve_device(device)
    infer = api.GAPartNetInference(ckpt_path=ckpt or None, device=device)
    cfg = infer.cfg

    index = None
    if obj:
        raw = load_obj_points(obj)
        xyz, rgb = raw[:, :3], raw[:, 3:6]
        index = api.fps_downsample(xyz, cfg.max_points, device=device)
        xyz_n, trans = api.ball_space_normalize(xyz[index])
        pts = np.concatenate([xyz_n, rgb[index]], axis=1)
        name = name or Path(obj).stem
        gt = {}
    else:
        from gapartnet_tpu_torch.data.loader import load_cloud_file

        d = load_cloud_file(input)
        pts = d["points"][: cfg.max_points]
        trans = None
        name = name or d["pc_id"]
        gt = dict(
            sem_gt=d["sem_labels"][: cfg.max_points],
            ins_gt=d["instance_labels"][: cfg.max_points],
            npcs_gt=d["gt_npcs"][: cfg.max_points] + 0.5,
        )

    result = infer.predict(pts)
    print(f"[visu] {name}: {len(result.bboxes)} boxes, "
          f"classes {result.proposal_classes.tolist()}")
    return VisuRun(name, pts, trans, index, gt, result)


def write_panels(out: str, r: VisuRun) -> dict:
    """The panels of `r` under <out>/tool/ (utils/visu.visualize_gapartnet);
    raises without cv2, which draws and writes them."""
    from gapartnet_tpu_torch.utils import visu

    if not visu.have_cv2():
        raise RuntimeError("visu: the panels are drawn and written with cv2 (opencv-python), "
                           "which is not installed")
    res = r.result
    panels = visu.visualize_gapartnet(
        save_root=out, name=r.name, split="tool", points=r.points, trans=r.trans,
        sem_preds=res.sem_preds, ins_preds=res.ins_preds, npcs_preds=res.npcs_map,
        bboxes=res.bboxes, save_option=SAVE_OPTION, **r.gt,
    )
    print(f"[visu] wrote panels under {out}/tool/")
    return panels


def main(argv=None) -> VisuRun:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", default="", help=".pth/.npz cloud")
    ap.add_argument("--obj", default="", help="real-world OBJ with vertex colors")
    ap.add_argument("--ckpt", default="", help="a checkpoint of the port's trainer")
    ap.add_argument("--out", default="visu_out")
    ap.add_argument("--name", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    r = run(args.input, args.obj, args.ckpt, args.name, args.device)
    write_panels(args.out, r)
    return r


if __name__ == "__main__":
    main()
