"""The program's own spans and counters in a stretch, and the span metrics
taken from them.

The program records spans and counts (gapartnet_tpu_torch/utils/profiling.py:
`span`, `count`, `record`).  `recorded_stretch` runs a stretch with its
recorder on and no profiler, on the host clock to a synchronize;
`tracing.traced_stretch` runs one after its two stretches and keeps it in
the `Trace` (`program_*`).  `values` turns a recording into the span
metrics per unit, and `read` gives a reader (portbench/metrics) the one
variant of its metric that the trace's recording holds.
"""

import contextlib
import time
from typing import Callable, Dict, Optional

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


def read(trace, metric: str) -> Optional[float]:
    """The variant of `metric` (its name before the dot) that the trace's
    recorded stretch gives; None where the trace has no recording or the
    recording no such value."""
    if trace is None or trace.program_units <= 0:
        return None
    got = [v for k, v in values(trace.program_summary, trace.program_counts,
                                trace.program_units).items() if k.split(".", 1)[0] == metric]
    return got[0] if got else None


def recorded_stretch(run_units: Callable[[Callable], int], sync: Callable[[], None],
                     on: bool = True) -> Optional[Dict]:
    """`run_units` with the program's recorder on (or, `on` false, off), on
    the host clock to a synchronize: wall time, units, and with the
    recorder on the recording's summary and counts.  None where the
    program has no recorder."""
    try:
        from gapartnet_tpu_torch.utils import profiling
    except ImportError:
        return None
    if on and not hasattr(profiling, "record"):
        return None

    sync()
    with profiling.record() if on else contextlib.nullcontext() as rec:
        t0 = time.perf_counter()
        units = run_units(contextlib.nullcontext)
        sync()
        wall = time.perf_counter() - t0
    if not on:
        return {"wall_s": wall, "units": units}
    return {"wall_s": wall, "units": units, "summary": rec.summary(), "counts": rec.counts}
