"""Per-class proposal birth and death through the eval cascade, with the
PyTorch port (counterpart of tools/proposal_diag.py).

When a part class scores AP@50 = 0, this names the stage that kills it.
For each part class it follows the proposal population through the
instance pipeline on one split:

    gt          GT instances of the class in the split
    semrec      sem-head point recall (GT points of the class predicted right)
    born        clustered proposals whose GT-majority class is this class
    iou50       born proposals with IoU > 0.5 against a GT instance of the class
    scored      survivors of the score / size filter (score > 0.09, > 3 points)
    kept        survivors of NMS (IoU 0.3)
    match-gt    kept proposals of the GT-majority class with IoU > 0.5
    match-pred  kept proposals of the PREDICTED class with IoU > 0.5 (what AP@50 counts)

    python -m gapartnet_tpu_torch.tools.proposal_diag --workdir runs/sustained_r4 \\
        --data runs/sustained_r4_data --split val [--ckpt PATH] [--device cuda|cpu]

The config is sustained_run.make_cfg's (auto_capacity over the test
splits, the model at those capacities).  The JAX tool stops before its
first batch (its `state.replace` on a NamedTuple, tools/proposal_diag.py:98);
this one computes what that tool's loop intends.  `main` returns
{class id: [gt, semrec, born, iou50, scored, kept, match-gt, match-pred]}
for the classes it prints.
"""

import argparse
from collections import defaultdict
from pathlib import Path

import numpy as np


def majority_gt_class(prop, sem_labels, num_classes):
    """(B, P) GT-majority semantic class per proposal (-1 for a proposal
    without a labelled point), on the host."""
    ep = np.asarray(prop.entry_point)
    pid = np.asarray(prop.entry_proposal)
    em = np.asarray(prop.entry_mask)
    b, p = np.asarray(prop.proposal_mask).shape
    out = np.full((b, p), -1, np.int64)
    for bi in range(b):
        sel = em[bi]
        gt = sem_labels[bi][ep[bi][sel]]
        pp = pid[bi][sel]
        ok = gt >= 0
        hist = np.zeros((p, num_classes), np.int64)
        np.add.at(hist, (pp[ok], gt[ok]), 1)
        has = hist.sum(1) > 0
        out[bi][has] = hist[has].argmax(1)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default="runs/sustained_r4")
    # required, where the JAX tool has a /tmp default that every checkout would share
    ap.add_argument("--data", required=True)
    ap.add_argument("--split", default="val", choices=["train", "val", "test_intra", "test_inter"])
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint (default <workdir>/checkpoints/last)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--sem-alpha", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from gapartnet_tpu_torch.constants import PART_ID2NAME
    from gapartnet_tpu_torch.entry import make_model, use_fp32_math
    from gapartnet_tpu_torch.eval.ap import _proposal_pred_classes, select_eval_proposals
    from gapartnet_tpu_torch.structures import PointCloudBatch
    from gapartnet_tpu_torch.tools import resolve_device
    from gapartnet_tpu_torch.tools.sustained_run import make_cfg
    from gapartnet_tpu_torch.train import trainer as T
    from gapartnet_tpu_torch.train.loop import eval_step

    device = resolve_device(args.device)
    use_fp32_math()
    workdir = Path(args.workdir)
    cfg = make_cfg(Path(args.data), workdir, 1, "diag.jsonl", n_points=args.points,
                   sem_alpha=args.sem_alpha, batch_size=args.batch)
    datasets = T.build_datasets(cfg, "test")
    T._apply_auto_capacity(cfg, datasets)
    model = make_model(cfg.model, device, seed=0)

    ds = datasets.get(args.split)
    if ds is None or len(ds) == 0:
        raise ValueError(f"split {args.split!r}: no clouds under {args.data}")
    ckpt = Path(args.ckpt) if args.ckpt else workdir / "checkpoints" / "last"
    T.load_warm_start(model, str(ckpt))

    C = cfg.model.num_part_classes
    agg = defaultdict(lambda: np.zeros(7, np.float64))  # per-class stages
    sem_hit = np.zeros(C, np.float64)
    sem_tot = np.zeros(C, np.float64)

    for raw in T._iter_batches(ds, args.batch, drop_last=False, workers=0):
        batch = PointCloudBatch.from_numpy(raw, device)
        out = eval_step(model, batch, do_cluster=True, do_score=True, do_npcs=True)
        keep = select_eval_proposals(out, cfg.model, cfg.model.max_points)
        pred_cls = _proposal_pred_classes(out.proposals, out.sem_preds)
        out, keep, pred_cls = T.cpu_tree((out, keep, pred_cls))

        sem_labels = raw["sem_labels"]
        point_mask = raw["point_mask"]
        sem_preds = out.sem_preds.numpy()
        for c in range(1, C):
            m = (sem_labels == c) & point_mask
            sem_tot[c] += m.sum()
            sem_hit[c] += (sem_preds[m] == c).sum()

        prop = out.proposals
        gcls = majority_gt_class(prop, sem_labels, C)          # (B, P)
        pm = prop.proposal_mask.numpy()
        sizes = prop.proposal_size.numpy()
        scores = out.score_preds.numpy()
        ious = out.ious.numpy()                                # (B, P, I)
        isl = raw["instance_sem_labels"]                       # (B, I)
        scored = pm & (scores > cfg.model.val_score_threshold) & (
            sizes > cfg.model.val_min_num_points_per_proposal)
        kept = keep.numpy()
        pred_cls = pred_cls.numpy()
        for bi in range(pm.shape[0]):
            for c in range(1, C):
                born = pm[bi] & (gcls[bi] == c)
                # IoU > 0.5 against a GT instance of class c
                iou_c = ious[bi].copy()
                iou_c[:, isl[bi] != c] = 0.0
                hit50 = born & (iou_c.max(1) > 0.5)
                row = agg[c]
                row[0] += (isl[bi] == c).sum()                 # gt
                row[1] += born.sum()                           # born
                row[2] += hit50.sum()                          # iou50
                row[3] += (born & scored[bi]).sum()            # scored
                row[4] += (born & kept[bi]).sum()              # kept
                row[5] += (hit50 & kept[bi]).sum()             # match-gt
                # matched with the PREDICTED class (what AP counts)
                sel = kept[bi] & (pred_cls[bi] == c)
                row[6] += (sel & (iou_c.max(1) > 0.5)).sum()   # match-pred

    print(f"split={args.split} ckpt={ckpt}")
    print(f"{'class':22s} {'gt':>5s} {'semrec':>7s} {'born':>6s} {'iou50':>6s} "
          f"{'scored':>7s} {'kept':>5s} {'match-gt':>9s} {'match-pred':>10s}")
    table = {}
    for c in range(1, C):
        row = agg[c]
        if row[0] == 0 and row[1] == 0:
            continue
        rec = sem_hit[c] / sem_tot[c] if sem_tot[c] else 0.0
        print(f"{PART_ID2NAME[c]:22s} {row[0]:5.0f} {rec:7.2%} {row[1]:6.0f} "
              f"{row[2]:6.0f} {row[3]:7.0f} {row[4]:5.0f} {row[5]:9.0f} {row[6]:10.0f}")
        table[c] = [row[0], rec, *row[1:]]
    return table


if __name__ == "__main__":
    main()
