"""Inference demo of the PyTorch port: one object's cloud in, part labels,
instances, NPCS and part boxes out.

    python -m gapartnet_tpu_torch.demo [--points cloud.npz|cloud.pth |
        --depth depth.npy --K K.npy [--rgb rgb.npy]] [--weights model.pt]
        [--device cuda|cpu] [--out demo_out]

Without an input it runs on the committed real cloud assets/bench_cloud.npz.
`--rgb` is an (H, W, 3) uint8 array in BGR order, as cv2 reads images.
Without `--weights` (a state_dict saved with torch.save) the weights are
random, drawn from `--seed`.  Prints a one-line summary and writes the
result to <out>/demo_result.npz.
"""

import argparse
import os

import numpy as np

from gapartnet_tpu_torch.entry import BENCH_CLOUD


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", default="", help=".npz / .pth cloud (default: the bench cloud)")
    ap.add_argument("--depth", default="", help="depth map .npy (meters)")
    ap.add_argument("--K", default="", help="3x3 intrinsics .npy")
    ap.add_argument("--rgb", default="", help="(H, W, 3) BGR uint8 .npy")
    ap.add_argument("--weights", default="", help="state_dict .pt (default: random weights)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="demo_out")
    args = ap.parse_args(argv)

    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.data.loader import load_cloud_file
    from gapartnet_tpu_torch.infer.api import GAPartNetInference

    cfg = GAPartNetConfig()
    # real clouds overflow the divisor-schedule voxel capacities at the mid
    # levels: size them from the input
    infer = GAPartNetInference(cfg=cfg, state_dict=args.weights or None, seed=args.seed,
                               auto_capacity=True, device=args.device)
    extra = {}
    if args.depth:
        if not args.K:
            ap.error("--depth needs --K")
        rgb = np.load(args.rgb) if args.rgb else None
        result, idx, trans = infer.predict_depth(np.load(args.depth), np.load(args.K), rgb)
        extra = dict(point_index=idx, trans=trans)
    else:
        d = load_cloud_file(args.points or str(BENCH_CLOUD))
        result = infer.predict(d["points"][: cfg.max_points])

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


if __name__ == "__main__":
    main()
