"""Console entry point of the port's trainer:

    python -m gapartnet_tpu_torch.train.cli fit|test -c configs/gapartnet.yaml \
        [--dotted.key value ...] [--device cuda|cpu]

(also installed as `gapartnet-torch-train`).  The same surface as the JAX
package's `train.py` / `gapartnet-train` (the reference's LightningCLI
invocation, gapartnet/train.py:62-69), plus `--device`, which defaults to
cuda and fails when no card is present.
"""

import sys


def main(argv=None):
    from gapartnet_tpu_torch.train import trainer
    from gapartnet_tpu_torch.train.config import load_config, parse_cli

    if argv is None:
        argv = sys.argv[1:]
    sub, cfg_path, overrides, device = parse_cli(argv)
    cfg = load_config(cfg_path, overrides)
    print(f"[gapartnet_tpu_torch] {sub} on {device} with model={cfg.model}", flush=True)
    if sub == "fit":
        trainer.fit(cfg, device=device)
    else:
        trainer.test(cfg, device=device)


if __name__ == "__main__":
    main()
