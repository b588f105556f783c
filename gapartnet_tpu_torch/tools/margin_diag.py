"""Foreground logit-margin trend of a run's checkpoints, with the PyTorch
port (counterpart of tools/margin_diag.py).

For each checkpoint, on one training batch: the margin between each
ground-truth foreground point's correct-class logit and its background
logit.  A healthy run's margin rises toward 0; a run sliding into
predicting background everywhere shows a falling margin while its total
loss still falls.

    python -m gapartnet_tpu_torch.tools.margin_diag --workdir runs/sustained_r3 \\
        --data runs/sustained_data_4k --points 4096 [--ckpts NAME ...] [--device cuda|cpu]

The batch is the first `fit`-stage train batch of 4 (shuffle seed 0) under
sustained_run.make_cfg's config.  `main` returns one row per checkpoint
found: (name, mean, p50, p90, frac>0, predfg%).
"""

import argparse
from pathlib import Path

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--ckpts", nargs="*", default=None,
                    help="checkpoint names under <workdir>/checkpoints (default: all, sorted, "
                         "plus 'last')")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from gapartnet_tpu_torch.entry import make_model, use_fp32_math
    from gapartnet_tpu_torch.structures import PointCloudBatch
    from gapartnet_tpu_torch.tools import resolve_device
    from gapartnet_tpu_torch.tools.sustained_run import make_cfg
    from gapartnet_tpu_torch.train import trainer as T
    from gapartnet_tpu_torch.train.loop import eval_step

    device = resolve_device(args.device)
    use_fp32_math()
    wd = Path(args.workdir)
    cfg = make_cfg(Path(args.data), wd, 8, "margin_diag.jsonl", n_points=args.points)
    datasets = T.build_datasets(cfg, "fit")
    T._apply_auto_capacity(cfg, datasets)
    model = make_model(cfg.model, device, seed=0)
    raw = next(T._iter_batches(datasets["train"], 4, True, 0))
    batch = PointCloudBatch.from_numpy(raw, device)

    names = args.ckpts
    if not names:
        names = sorted(p.name for p in (wd / "checkpoints").iterdir()
                       if p.name.startswith("epoch_")) + ["last"]
    sem = raw["sem_labels"]
    maskv = raw["point_mask"]
    fg = (sem > 0) & maskv
    print(f"{'ckpt':28s} {'mean':>7s} {'p50':>7s} {'p90':>7s} {'frac>0':>7s} {'predfg%':>8s}")
    rows = []
    for name in names:
        p = wd / "checkpoints" / name
        if not p.exists():
            continue
        model.load_state_dict(T.CkptManager.restore(str(p))["model"])
        out = eval_step(model, batch, do_cluster=False, do_score=False, do_npcs=False)
        lg, preds = T.host_copy((out.sem_logits, out.sem_preds))
        fg_lg = lg[fg]
        margin = fg_lg[np.arange(len(fg_lg)), sem[fg]] - fg_lg[:, 0]
        row = (name, margin.mean(), np.percentile(margin, 50), np.percentile(margin, 90),
               (margin > 0).mean(), (preds[maskv] > 0).mean() * 100)
        print(f"{name:28s} {row[1]:7.3f} {row[2]:7.3f} {row[3]:7.3f} {row[4]:7.3f} "
              f"{row[5]:8.3f}")
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
