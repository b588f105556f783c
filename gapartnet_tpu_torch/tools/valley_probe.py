"""Short controlled training probes of the sem head's slide into predicting
background everywhere, with the PyTorch port (counterpart of
tools/valley_probe.py).

One short fit under sustained_run.make_cfg's config with targeted
overrides (lr, dice loss, focal loss, alpha, batch size, the offset loss,
augmentation, the stage schedule), then the per-epoch trajectory read back
from its fit.jsonl, so that single factors can be isolated:

    python -m gapartnet_tpu_torch.tools.valley_probe --data runs/sustained_r4_data \\
        --workdir runs/valley_probes --tag lr3e4 --lr 3e-4 --epochs 14
    ... --tag nodice --no-dice --epochs 14
    ... --tag alpha02 --sem-alpha 0.02
    ... --tag b4 --batch 4 [--device cuda|cpu]

The resolved Config goes to <workdir>/<tag>/probe_config.json.  `main`
returns the printed trajectory (one dict per line of fit.jsonl).
"""

import argparse
import dataclasses
import json
from pathlib import Path

TRAJECTORY_KEYS = ("step", "train_pixel_accu", "train_loss/loss_sem_seg", "val/pixel_accu",
                   "val/recall_hinge_door", "val/recall_slider_button",
                   "val/recall_line_fixed_handle")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # required, where the JAX tool has /tmp defaults that every checkout would share
    ap.add_argument("--data", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--epochs", type=int, default=14)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sem-alpha", default=0.1, type=lambda v: v if v == "auto" else float(v))
    ap.add_argument("--no-dice", action="store_true")
    ap.add_argument("--no-focal", action="store_true")
    ap.add_argument("--no-offset", action="store_true",
                    help="zero the offset-loss weight (backbone-coupling probe; not a "
                         "reference configuration)")
    ap.add_argument("--schedule", type=int, nargs=2, default=(100, 110),
                    help="default: stages never activate (sem-only probe)")
    ap.add_argument("--aug", action="store_true",
                    help="geometric augmentation on (default off for probes)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from gapartnet_tpu_torch.tools import resolve_device
    from gapartnet_tpu_torch.tools.sustained_run import make_cfg
    from gapartnet_tpu_torch.train import trainer as T

    device = resolve_device(args.device)
    workdir = Path(args.workdir) / args.tag
    workdir.mkdir(parents=True, exist_ok=True)
    cfg = make_cfg(
        Path(args.data), workdir, args.epochs, "fit.jsonl",
        sem_alpha=args.sem_alpha, batch_size=args.batch, color_jitter=0.0,
        pos_jitter=0.1 if args.aug else 0.0,
        flip_prob=0.3 if args.aug else 0.0,
        rotate_prob=0.3 if args.aug else 0.0,
        schedule=tuple(args.schedule),
    )
    cfg.trainer.learning_rate = args.lr
    cfg.trainer.val_every_n_epochs = 4
    cfg.trainer.save_top_k = 1
    mkw = {}
    if args.no_dice:
        mkw["use_sem_dice_loss"] = False
    if args.no_focal:
        mkw["use_sem_focal_loss"] = False
    if args.no_offset:
        mkw["offset_loss_weight"] = 0.0
    if mkw:
        cfg.model = dataclasses.replace(cfg.model, **mkw)
    (workdir / "probe_config.json").write_text(
        json.dumps(dataclasses.asdict(cfg), indent=1, default=str))
    T.fit(cfg, device=device)

    print(f"=== probe {args.tag} trajectory")
    trajectory = []
    for line in (workdir / "fit.jsonl").read_text().splitlines():
        d = json.loads(line)
        keys = {k: round(float(d[k]), 2) for k in TRAJECTORY_KEYS if k in d}
        print(keys, flush=True)
        trajectory.append(keys)
    return trajectory


if __name__ == "__main__":
    main()
