"""The program's own spans and counters in a cell, the span metrics per
unit, the recorder's cost and the sync inventory; not run by the benchmark.

    python3 portbench/spans.py --workload <cell> --seeds 1,2,3 [--inventory 1] [--turns N]

The program records spans and counts (gapartnet_tpu_torch/utils/profiling.py:
`span`, `count`, `record`).  A `--trace 1` run's third stretch runs with
the recorder on (portbench/tracing.py, portbench/recording.py), and the
span metrics read it.  This script runs each seed's traced run in this
process and prints, beside its result line, that stretch's span values,
summary and counts; `--turns N` then runs N pairs of stretches with the
recorder off and on (its cost).  With `--inventory 1` one more stretch runs
under `torch.cuda.set_sync_debug_mode("warn")` with the recorder on, and
every call that made the host wait for the device is listed by its program
frame and the innermost span open around it.  One JSON line per seed: the
traced run's result line, with `program` (the span values per unit, the
recorded stretch and its summary, the counts, the turns, the inventory).
"""

import contextlib
import json
import os
import sys
import time
import traceback
import warnings
from pathlib import Path
from typing import Callable, Dict

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness, tracing  # noqa: E402
from portbench.recording import SYNC, recorded_stretch, values  # noqa: E402


def sync_inventory(run_units: Callable[[Callable], int], sync: Callable[[], None]) -> Dict:
    """`run_units` under the sync debug mode "warn", with the recorder on:
    per site (the innermost frame in the program and the innermost span
    open around the call), the synchronizing calls per unit, and the sync
    spans per unit."""
    import torch

    from gapartnet_tpu_torch.utils import profiling

    sites: Dict[str, int] = {}
    program = str(Path(profiling.__file__).resolve().parents[1])

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        frames = [f for f in traceback.extract_stack() if f.filename.startswith(program)]
        where = f"{Path(frames[-1].filename).relative_to(program)}:{frames[-1].lineno}" if frames \
            else f"{filename}:{lineno}"
        rec = profiling._recording
        open_span = rec._rows[rec._stack[-1]][0] if rec is not None and rec._stack else "-"
        key = f"{where} in {open_span}"
        sites[key] = sites.get(key, 0) + 1

    sync()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiling.record() as rec:
                units = run_units(contextlib.nullcontext)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sync()
    spans = {n: d["n"] / units for n, d in rec.summary().items() if n.startswith(SYNC)}
    return {"units": units,
            "warnings_per_unit": sum(sites.values()) / units,
            "sync_spans_per_unit": sum(spans.values()),
            "sites_per_unit": {k: v / units for k, v in sorted(sites.items(), key=lambda kv: -kv[1])},
            "sync_spans": spans}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--inventory", type=int, choices=(0, 1), default=0)
    ap.add_argument("--turns", type=int, default=0,
                    help="stretches with the recorder off and on, in turns, after the first")
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    torch.set_num_threads(1)
    traced = tracing.traced_stretch
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.make_run(harness.benchmark(), args.workload, seed, 0.0, True, t0)
        extra = {}

        def with_program_spans(run_units, modules, backbone):
            trace = traced(run_units, modules, backbone)
            extra.update(stretch={"wall_s": trace.program_s, "units": trace.program_units,
                                  "unprofiled_s": trace.untraced_s,
                                  "unprofiled_units": trace.untraced_units},
                         values=values(trace.program_summary, trace.program_counts,
                                       trace.program_units),
                         summary=trace.program_summary, counts=trace.program_counts)
            # the recorder's cost: stretches with it off and on, in turns
            turns = [recorded_stretch(run_units, torch.cuda.synchronize, on)
                     for _ in range(args.turns) for on in (False, True)]
            extra["turns"] = [{"on": i % 2 == 1, "wall_s": t["wall_s"], "units": t["units"],
                               "values": t.get("summary") and values(
                                   t["summary"], t["counts"], t["units"])}
                              for i, t in enumerate(turns)]
            if args.inventory:
                extra["inventory"] = sync_inventory(run_units, torch.cuda.synchronize)
            return trace

        tracing.traced_stretch = with_program_spans
        try:
            out = harness.traffic_module(run).run(run)
        finally:
            tracing.traced_stretch = traced
        out.notes["card"] = harness.power_limit()
        res = harness.result_line(run, out, torch.cuda.get_device_name(0))
        res.update(workload=args.workload, seed=seed, program=extra)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
