"""Per-view semantic confusion of a trained checkpoint, with the PyTorch
port (counterpart of tools/confusion_diag.py).

Answers where the ground-truth points of a class go, which an aggregate
recall cannot (a recall of 0 for line_fixed_handle says the handles are
lost; this says to which class).  Runs the sem-only reduced eval step per
view (batch 1, no clustering) and prints, per split:

  * the aggregate GT-row-normalised confusion over the part classes;
  * for the focus class, a per-view table: GT points, recall in that view
    and the class that takes most of them, which tells "lost in distant
    views only" from "lost everywhere".

    python -m gapartnet_tpu_torch.tools.confusion_diag --data runs/sustained_r4_data \\
        --workdir runs/confusion_diag --ckpt runs/sustained_r4/checkpoints_a/last --splits val --focus-class 1 \\
        [--limit N] [--device cuda|cpu]

The config is sustained_run.make_cfg's (auto_capacity over the test
splits).  `main` returns {split: (the aggregate (C, C) int64 confusion,
the per-view rows)}.
"""

import argparse
from pathlib import Path

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # required, where the JAX tool has /tmp defaults that every checkout would share
    ap.add_argument("--data", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--splits", nargs="+", default=["val"])
    ap.add_argument("--focus-class", type=int, default=1,
                    help="part class id for the per-view table (1 = line_fixed_handle)")
    ap.add_argument("--limit", type=int, default=0, help="max views per split (0 = all)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from gapartnet_tpu_torch.constants import PART_ID2NAME
    from gapartnet_tpu_torch.entry import make_model, use_fp32_math
    from gapartnet_tpu_torch.structures import PointCloudBatch
    from gapartnet_tpu_torch.tools import resolve_device
    from gapartnet_tpu_torch.tools.sustained_run import make_cfg
    from gapartnet_tpu_torch.train import trainer as T

    device = resolve_device(args.device)
    use_fp32_math()
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    cfg = make_cfg(Path(args.data), workdir, 1, "diag.jsonl")
    cfg.data.val_batch_size = 1  # per-view confusion
    datasets = T.build_datasets(cfg, "test")
    T._apply_auto_capacity(cfg, datasets)
    model = make_model(cfg.model, device, seed=0)
    T.load_warm_start(model, args.ckpt)
    # sem only: no clustering
    eval_step = T.make_reduced_eval_step(model, cfg, do_instance=False)

    C = cfg.model.num_part_classes
    fc = args.focus_class
    tables = {}
    for split in args.splits:
        ds = datasets[split]
        n = len(ds) if not args.limit else min(len(ds), args.limit)
        agg = np.zeros((C, C), np.int64)
        rows = []
        it = T._iter_batches(ds, 1, drop_last=False)
        for vi in range(n):
            batch = PointCloudBatch.from_numpy(next(it), device)
            conf = T.host_copy(eval_step(batch))["conf"].astype(np.int64)
            agg += conf
            gt = int(conf[fc].sum())
            if gt > 0:
                rec = conf[fc, fc] / gt * 100
                top = int(np.argmax(conf[fc]))
                rows.append((vi, gt, rec, top, conf[fc, top] / gt * 100))
        print(f"\n=== {split}: GT-row-normalized confusion (percent) ===")
        names = [PART_ID2NAME.get(i, str(i)) for i in range(C)]
        present = [i for i in range(C) if agg[i].sum() > 0]
        print("gt\\pred".ljust(20) + "".join(names[j][:10].rjust(11) for j in present))
        for i in present:
            row = agg[i] / max(agg[i].sum(), 1) * 100
            print(names[i][:18].ljust(20) + "".join(f"{row[j]:11.1f}" for j in present))
        if rows:
            print(f"\n--- per-view {names[fc]} (views with GT points) ---")
            print("view  gt_pts  recall%  top_pred(share%)")
            for vi, gt, rec, top, share in rows:
                print(f"{vi:4d}  {gt:6d}  {rec:6.1f}   {names[top]}({share:.0f}%)")
        tables[split] = (agg, rows)
    return tables


if __name__ == "__main__":
    main()
