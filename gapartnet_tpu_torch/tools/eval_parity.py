"""AP-parity evaluation against the reference checkpoint (BASELINE config
#4), with the PyTorch port (counterpart of tools/eval_parity.py).

Given the GAPartNet dataset tree and the reference release checkpoint
(release.ckpt / all_best_7816.ckpt), this converts the spconv / Lightning
state_dict to the port's (train/ckpt_convert.py) and runs the fixed mAP
evaluation over val / test_intra / test_inter with the exact reference
thresholds (score > 0.09, > 3 points, NMS IoU 0.3, AP IoU 0.50:0.05:0.95):

    python -m gapartnet_tpu_torch.tools.eval_parity --data data/GAPartNet_All \\
        --ckpt release.ckpt [--spatial-order xyz|zyx] [--clustering exact|hash] \\
        [--batch 8] [--bf16] [--device cuda|cpu]

Clustering defaults to the exact reference-parity path (ball query with the
50/300 per-query caps + CCL); --clustering hash measures the fast path's AP
delta.  The spconv kernel-tap layout is "xyz"; --spatial-order zyx is an
A/B escape hatch only.  The metrics are appended to parity_metrics.jsonl in
the working directory and printed sorted.  `--splits` is parsed and, as in
the JAX tool, not used: the three splits are always evaluated.  A staged
checkpoint without the score or NPCS head cannot be evaluated, since the
evaluation runs all three stages: the tool stops before evaluating, as the
JAX tool does at its first forward.
"""

import argparse
from pathlib import Path
from typing import Dict

import torch

TRUST_NOTE = ("--ckpt is unpickled (torch.load with weights_only=False): load only checkpoints "
              "from a trusted source")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], epilog=TRUST_NOTE)
    ap.add_argument("--data", required=True)
    ap.add_argument("--ckpt", required=True,
                    help="the reference's Lightning .ckpt (or a bare state_dict); " + TRUST_NOTE)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--spatial-order", default="xyz", choices=["xyz", "zyx"])
    ap.add_argument("--clustering", default="exact", choices=["exact", "hash"])
    ap.add_argument("--splits", nargs="*", default=["val", "test_intra", "test_inter"],
                    help="parsed and not used, as in the JAX tool: all three splits run")
    ap.add_argument("--bf16", action="store_true", help="bf16 conv compute")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_config(args: argparse.Namespace):
    """The JAX tool's Config: the flagship model with the conv dtype and
    the clustering asked for, the data tree with `val_batch_size = --batch`
    and `<data>/nopart.txt` (auto_capacity off), the default trainer."""
    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.train.config import Config, DataConfig, TrainerConfig

    return Config(
        model=GAPartNetConfig(
            conv_compute_dtype="bfloat16" if args.bf16 else "float32",
            clustering_impl=args.clustering,
        ),
        data=DataConfig(
            root_dir=args.data, val_batch_size=args.batch,
            nopart_path=str(Path(args.data) / "nopart.txt"),
        ),
        trainer=TrainerConfig(),
    )


def load_weights(path: str, cfg, spatial_order: str = "xyz") -> Dict[str, torch.Tensor]:
    """The port's state_dict of a reference checkpoint at `cfg`'s widths
    (`load_reference_ckpt`; the file is unpickled: trusted files only)."""
    from gapartnet_tpu_torch.train.ckpt_convert import load_reference_ckpt

    return load_reference_ckpt(path, channels=cfg.model.channels,
                               block_repeat=cfg.model.block_repeat, spatial_order=spatial_order)


def build_model(cfg, state_dict: Dict[str, torch.Tensor], device):
    """The eval-mode model with `state_dict` loaded.  Every tensor of the
    model must come from the checkpoint: a staged checkpoint lacking the
    score or NPCS branch raises, naming the missing modules."""
    from gapartnet_tpu_torch.models.gapartnet import GAPartNet

    model = GAPartNet(cfg.model)
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    if missing or unexpected:
        modules = sorted({k.split(".", 1)[0] for k in missing})
        raise ValueError(
            f"eval_parity: the checkpoint does not cover the model (missing {len(missing)} "
            f"tensors of {modules}, {len(unexpected)} unexpected); the evaluation runs all three "
            "stages, so a staged checkpoint without the score or NPCS head cannot be evaluated")
    return model.eval().to(device)


def main(argv=None) -> Dict[str, float]:
    args = parse_args(argv)

    from gapartnet_tpu_torch.entry import use_fp32_math
    from gapartnet_tpu_torch.tools import resolve_device
    from gapartnet_tpu_torch.train import trainer as T

    device = resolve_device(args.device)
    use_fp32_math()
    cfg = build_config(args)

    print(f"[parity] converting {args.ckpt} (spatial_order={args.spatial_order})")
    model = build_model(cfg, load_weights(args.ckpt, cfg, args.spatial_order), device)
    datasets = T.build_datasets(cfg, "test")
    logger = T.MetricLogger("parity_metrics.jsonl")
    _, metrics = T.evaluate_splits(model, cfg, datasets, 0, logger, 0, do_instance=True,
                                   device=device)
    print("\n[parity] results (compare against the reference's `train.py test`"
          " with the same checkpoint):")
    for k in sorted(metrics):
        print(f"  {k}: {metrics[k]:.2f}")
    return metrics


if __name__ == "__main__":
    main()
