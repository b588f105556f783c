"""Console entry point of the port's trainer:

    python -m gapartnet_tpu_torch.train.cli fit|test -c configs/gapartnet.yaml \
        [--dotted.key value ...] [--device cuda|cpu]

(also installed as `gapartnet-torch-train`).  The same surface as the JAX
package's `train.py` / `gapartnet-train` (the reference's LightningCLI
invocation, gapartnet/train.py:62-69), plus `--device`, which defaults to
cuda and fails when no card is present.

Data parallel, one process per card:

    python -m torch.distributed.run --nproc_per_node K \
        -m gapartnet_tpu_torch.train.cli fit -c configs/gapartnet.yaml

Under the launcher each process joins the group (NCCL on `cuda:LOCAL_RANK`,
gloo with `--device cpu`); `data.train_batch_size` is per process, so the
global batch is K times it (parallel/dist.py, train/trainer.py).
"""

import sys


def main(argv=None):
    import torch.distributed

    from gapartnet_tpu_torch.parallel import dist as pdist
    from gapartnet_tpu_torch.train import trainer
    from gapartnet_tpu_torch.train.config import load_config, parse_cli

    if argv is None:
        argv = sys.argv[1:]
    sub, cfg_path, overrides, device = parse_cli(argv)
    device, created = pdist.init_from_env(device)
    try:
        if pdist.is_initialized():
            print(f"[gapartnet_tpu_torch] data parallel: rank {pdist.rank()} of "
                  f"{pdist.world_size()} ({torch.distributed.get_backend()})", flush=True)
        cfg = load_config(cfg_path, overrides)
        print(f"[gapartnet_tpu_torch] {sub} on {device} with model={cfg.model}", flush=True)
        if sub == "fit":
            trainer.fit(cfg, device=device)
        else:
            trainer.test(cfg, device=device)
    finally:
        if created:
            pdist.close()


if __name__ == "__main__":
    main()
