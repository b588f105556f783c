"""Readings that set the limits of `correct`; not run by the benchmark.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --modes program,control [--seconds 0]

For each seed and mode one run of the cell in this process (a short or no
window), printing its compared numbers as one JSON line:

  * program   the program, as the benchmark runs it (the lower readings);
  * control   the plain reference in the program's place, in the nearest
              precision below the configuration's: TF32 on for matmuls and
              cuDNN convs (the upper readings);
  * fp32      the plain reference in the program's place in fp32: how far
              two fp32 runs of the reference itself drift apart;
  * half      training: the program stepping on the first half of every
              batch, its losses the means over that half (a planted fault);
  * frozen    training: the program's optimizer leaves the parameters as
              they were (a planted fault);
  * stuck     training: the program's optimizer updates every moment but
              leaves the largest leaf's parameters as they were (a planted
              fault that the gradient, read from the moment, cannot see);
  * altered   requests: every mask's score is altered by 1e-3 where the
              request's reply is laid out (a planted fault).
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def plant(mode: str):
    """Break the program underneath the harness for a fault mode; returns
    an undo function."""
    import torch
    from gapartnet_tpu_torch.train import loop

    if mode == "half":
        orig = loop.train_step

        def half_step(model, opt, batch, gen, *flags, cluster_sem_override=None,
                      cluster_offset_override=None, **kw):
            h = batch.batch_size // 2
            cut = {f.name: (getattr(batch, f.name)[:h] if getattr(batch, f.name) is not None
                            else None) for f in dataclasses.fields(batch)}
            return orig(model, opt, type(batch)(**cut), gen, *flags,
                        cluster_sem_override=cluster_sem_override[:h],
                        cluster_offset_override=cluster_offset_override[:h], **kw)

        loop.train_step = half_step
        return lambda: setattr(loop, "train_step", orig)
    if mode == "altered":
        from gapartnet_tpu_torch.infer import api

        orig_scatter = api.GAPartNetInference._scatter

        def altered(self, *args, **kw):
            result, jobs = orig_scatter(self, *args, **kw)
            result.proposal_scores = result.proposal_scores + 1e-3
            return result, jobs

        api.GAPartNetInference._scatter = altered
        return lambda: setattr(api.GAPartNetInference, "_scatter", orig_scatter)
    if mode == "frozen":
        orig = loop.optimizer_step
        loop.optimizer_step = lambda opt: None
        return lambda: setattr(loop, "optimizer_step", orig)
    if mode == "stuck":
        orig = loop.optimizer_step

        def stuck_step(opt):
            leaf = max((p for g in opt.param_groups for p in g["params"]), key=lambda p: p.numel())
            kept = leaf.detach().clone()
            orig(opt)
            with torch.no_grad():
                leaf.copy_(kept)

        loop.optimizer_step = stuck_step
        return lambda: setattr(loop, "optimizer_step", orig)
    return lambda: None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,control")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    bench = harness.benchmark()
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            t0 = time.perf_counter()
            run = harness.make_run(bench, args.workload, seed, args.seconds, False, t0)
            run.control = {"control": "tf32", "fp32": "fp32"}.get(mode, "")
            undo = plant(mode)
            try:
                out = harness.traffic_module(run).run(run)
            finally:
                undo()
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "values": {k: v["value"] for k, v in out.compared.items()},
                              "metrics": out.metrics, "notes": out.notes,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
