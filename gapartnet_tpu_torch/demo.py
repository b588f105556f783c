"""Inference demo of the PyTorch port: one object's cloud in, part labels,
instances, NPCS and part boxes out.

    python -m gapartnet_tpu_torch.demo [--points cloud.npz|cloud.pth |
        --depth depth.npy --K K.npy [--rgb rgb.npy] | --asset DIR]
        [--weights model.pt | --ckpt checkpoints/last] [--seed S]
        [--device cuda|cpu] [--out demo_out]

Without an input it runs on the committed real cloud assets/bench_cloud.npz.
`--rgb` is an (H, W, 3) uint8 array in BGR order, as cv2 reads images.
`--asset` is a raw articulated asset (URDF + OBJ meshes, as
datagen/synthetic.generate_assets writes them): one labelled view of it is
rendered without SAPIEN (datagen/assets.render_view_maps, seeded by
`--seed`) and sent through predict_depth, as a camera's RGB-D frame would
be; the demo prints how often the predicted classes agree with the
render's labels.  `--weights` is a state_dict saved with torch.save,
`--ckpt` a checkpoint of the port's trainer (`train.cli fit` writes
`checkpoints/last`); without either the weights are random, drawn from
`--seed`.  Prints a one-line summary,
writes the result to <out>/demo_result.npz and, as the JAX demo does, five panels
(pc, sem_pred, ins_pred, npcs_pred, bbox_pred) and their grid under
<out>/demo/ through utils/visu.py.  Writing the panels needs cv2; without
it the demo says so in one line and writes the result only.
"""

import argparse
import os

import numpy as np

from gapartnet_tpu_torch.entry import BENCH_CLOUD


def asset_request(infer, asset_dir, seed: int) -> dict:
    """The --asset path: render one labelled view of `asset_dir` (seeded by
    `seed`), send it through `infer.predict_depth`, and measure the predicted
    classes against the render's labels.  Returns dict(maps, result, index
    (the sampled pixels), trans, points (the network's input cloud),
    agreement)."""
    from gapartnet_tpu_torch.datagen.assets import render_view_maps
    from gapartnet_tpu_torch.infer.api import backproject_depth, ball_space_normalize

    maps = render_view_maps(asset_dir, seed=seed)
    bgr = np.ascontiguousarray(maps["rgb"][..., ::-1])  # the RGB-D API takes cv2's BGR
    result, idx, trans = infer.predict_depth(maps["depth"], maps["K"], bgr)
    xyz, colors, pix = backproject_depth(maps["depth"], maps["K"], bgr)
    pts = np.concatenate([ball_space_normalize(xyz[idx])[0], colors[idx]], axis=1)
    gt_sem = maps["sem"][pix[idx, 0], pix[idx, 1]]
    agreement = float((result.sem_preds == np.clip(gt_sem + 1, 0, None)).mean())
    return dict(maps=maps, result=result, index=idx, trans=trans, points=pts,
                agreement=agreement)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", default="", help=".npz / .pth cloud (default: the bench cloud)")
    ap.add_argument("--depth", default="", help="depth map .npy (meters)")
    ap.add_argument("--K", default="", help="3x3 intrinsics .npy")
    ap.add_argument("--rgb", default="", help="(H, W, 3) BGR uint8 .npy")
    ap.add_argument("--asset", default="", help="raw asset dir (URDF + meshes) to render a view of")
    ap.add_argument("--weights", default="", help="state_dict .pt (default: random weights)")
    ap.add_argument("--ckpt", default="", help="a checkpoint of the port's trainer (e.g. "
                    "checkpoints/last of train.cli fit)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and of the asset's view")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="demo_out")
    args = ap.parse_args(argv)
    if args.weights and args.ckpt:
        ap.error("--weights and --ckpt exclude each other")

    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.data.loader import load_cloud_file
    from gapartnet_tpu_torch.infer.api import (
        GAPartNetInference,
        backproject_depth,
        ball_space_normalize,
    )
    from gapartnet_tpu_torch.utils import visu

    cfg = GAPartNetConfig()
    # real clouds overflow the divisor-schedule voxel capacities at the mid
    # levels: size them from the input
    infer = GAPartNetInference(cfg=cfg, state_dict=args.weights or None, seed=args.seed,
                               auto_capacity=True, device=args.device,
                               ckpt_path=args.ckpt or None)
    extra, trans = {}, None
    if args.depth:
        if not args.K:
            ap.error("--depth needs --K")
        depth, k = np.load(args.depth), np.load(args.K)
        rgb = np.load(args.rgb) if args.rgb else None
        result, idx, trans = infer.predict_depth(depth, k, rgb)
        extra = dict(point_index=idx, trans=trans)
        xyz, colors, _ = backproject_depth(depth, k, rgb)
        pts = np.concatenate([ball_space_normalize(xyz[idx])[0],
                              colors[idx] if colors is not None else np.zeros((len(idx), 3))],
                             axis=1)
    elif args.asset:
        print(f"[demo] rendering a view of asset {args.asset}")
        view = asset_request(infer, args.asset, args.seed)
        result, pts, trans = view["result"], view["points"], view["trans"]
        extra = dict(point_index=view["index"], trans=trans)
        print(f"[demo] sem agreement vs render labels: {view['agreement']:.3f} "
              "(random weights ~ chance unless --weights or --ckpt given)")
    else:
        d = load_cloud_file(args.points or str(BENCH_CLOUD))
        pts = d["points"][: cfg.max_points]
        result = infer.predict(pts)

    print(f"[demo] {int((result.ins_preds > 0).sum())} part points, "
          f"{len(result.bboxes)} bboxes, "
          f"classes={result.proposal_classes.tolist()}, "
          f"scores={np.round(result.proposal_scores, 3).tolist()}")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "demo_result.npz")
    np.savez(path, sem_preds=result.sem_preds, ins_preds=result.ins_preds,
             npcs_map=result.npcs_map, proposal_scores=result.proposal_scores,
             proposal_classes=result.proposal_classes,
             bboxes=np.asarray(result.bboxes, np.float32).reshape(-1, 8, 3), **extra)
    print(f"[demo] wrote {os.path.abspath(path)}")
    if not visu.have_cv2():
        print("[demo] no panels written: cv2 (opencv-python), which draws and writes them, "
              "is not installed")
        return
    panels = visu.visualize_gapartnet(
        save_root=args.out, name="demo", split="demo", points=pts, trans=trans,
        sem_preds=result.sem_preds, ins_preds=result.ins_preds, npcs_preds=result.npcs_map,
        bboxes=result.bboxes,
        save_option=("pc", "sem_pred", "ins_pred", "npcs_pred", "bbox_pred"),
    )
    print(f"[demo] wrote {len(panels)} panels under {os.path.abspath(args.out)}")


if __name__ == "__main__":
    main()
