"""The program's own spans and counters in a cell, and the per-unit values
that span metrics take from them; not run by the benchmark.

    python3 portbench/spans.py --workload <cell> --seeds 1,2,3 [--inventory 1]

The program records spans and counts (gapartnet_tpu_torch/utils/profiling.py:
`span`, `count`, `record`).  Under the profiler of a `--trace 1` run its
spans are `record_function` ranges, so `breakdown.idle_gaps` names them;
their host times need a stretch with the recorder on and no profiler, which
`tracing.traced_stretch` does not run (PERF.md, Open questions).  This
script runs each seed's traced run in this process with that stretch added
after the two the benchmark runs: `trace_units` more units with the
recorder on, on the host clock, ending in a synchronize; `--turns N` then
runs N pairs of stretches with the recorder off and on (its cost).  With
`--inventory 1` one more stretch runs under
`torch.cuda.set_sync_debug_mode("warn")` with the recorder on, and every
call that made the host wait for the device is listed by its program frame
and the innermost span open around it.  One JSON line per seed: the traced
run's result line, with `program` (the span values per unit, the recorder's
stretch and its summary, the counts, the inventory).
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

SYNC = "sync:"


def values(summary: Dict[str, Dict[str, float]], counts: Dict[str, int],
           units: int) -> Dict[str, float]:
    """Each span metric of a stretch of `units` train steps (the `.train`
    variants, read where `step` spans ran) or requests (`.request`, where
    `request` spans ran), from its recording's summary and counts: times
    and syncs per unit.  A span that never ran gives no value, and a
    recording with neither root (a program without spans) gives none."""
    variant = "train" if "step" in summary else "request" if "request" in summary else None
    if variant is None or units <= 0:
        return {}
    syncs = [d for name, d in summary.items() if name.startswith(SYNC)]
    out = {
        "host_syncs": sum(d["n"] for d in syncs) / units,
        "host_wait_ms": sum(d["ms"] for d in syncs) / units,
    }
    per_unit = {"train": {"clustering_ms": ("model:cluster", "ms"),
                          "backward_ms": ("step:backward", "ms"),
                          "optimizer_ms": ("step:optimizer", "ms")},
                "request": {"scatter_ms": ("request:scatter", "self_ms"),
                            "ransac_ms": ("request:ransac", "ms")}}[variant]
    for metric, (name, key) in per_unit.items():
        if name in summary:
            out[metric] = summary[name][key] / units
    if variant == "request" and counts.get("dense_grids_convolved"):
        out["dense_grid_live_pct"] = 100.0 * counts["dense_grids_live"] / counts["dense_grids_convolved"]
    return {f"{k}.{variant}": v for k, v in out.items()}


def recorded_stretch(run_units: Callable[[Callable], int], sync: Callable[[], None],
                     on: bool = True) -> Dict:
    """`run_units` with the program's recorder on (or, `on` false, off), on
    the host clock to a synchronize: wall time, units, the recording's
    summary and counts."""
    from gapartnet_tpu_torch.utils import profiling

    sync()
    with profiling.record() if on else contextlib.nullcontext() as rec:
        t0 = time.perf_counter()
        units = run_units(contextlib.nullcontext)
        sync()
        wall = time.perf_counter() - t0
    if not on:
        return {"wall_s": wall, "units": units}
    return {"wall_s": wall, "units": units, "summary": rec.summary(), "counts": rec.counts}


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
            rec = recorded_stretch(run_units, torch.cuda.synchronize)
            extra.update(stretch={"wall_s": rec["wall_s"], "units": rec["units"],
                                  "unprofiled_s": trace.untraced_s,
                                  "unprofiled_units": trace.untraced_units},
                         values=values(rec["summary"], rec["counts"], rec["units"]),
                         summary=rec["summary"], counts=rec["counts"])
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
