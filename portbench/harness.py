"""One run of one cell: find its files by name, run its traffic, print the result.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found from the names in
BENCHMARK.json:

  * configuration  BENCHMARK.json `configs[].file` (portbench/configs/<name>.json):
                   the program's configuration as it is run (`model`), its
                   precision, its source and what was assumed;
  * traffic mix    portbench/traffic/<traffic>.json: parameters, with `kind`
                   naming the generator portbench/traffic/<kind>.py;
  * cell           portbench/cells/<workload>.json: the limits of the
                   numbers that decide `correct`, and how many units the
                   traced stretch holds;
  * metric         portbench/metrics/<metric>.py, or where there is none
                   portbench/metrics/<metric's name before its first dot>.py,
                   one reader for the metric's variants (`.train`, `.request`):
                   `read(trace) -> float or None`.

A traffic module's `run(run: Run) -> Outcome` builds the system under test,
warms it, measures the window, frees the program's state and compares what
the window produced with the plain reference (portbench/reference).
"""

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that may not be loaded in a measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gapartnet_tpu")


@dataclasses.dataclass
class Run:
    workload: str
    seed: int
    seconds: float
    trace: bool
    chips: int
    config: Dict[str, Any]          # the configuration file
    traffic: Dict[str, Any]         # the traffic mix file
    cell: Dict[str, Any]            # the cell file
    per_layer: List[Dict[str, Any]]  # BENCHMARK.json per-layer metrics of this cell
    end_to_end: List[Dict[str, Any]]
    t_start: float                  # perf_counter at process start
    bench_dir: Path = BENCH_DIR     # where the cell's files are found
    device: str = "cuda"
    # "" the program; "tf32" (the control) or "fp32": the plain reference
    # in the program's place, in that precision (portbench/readings.py)
    control: str = ""


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: Dict[str, float]       # end-to-end metrics by name (trace off)
    compared: Dict[str, Dict[str, float]]  # number -> {"value", "limit"}
    memory_peak_bytes: int
    trace: Any = None               # tracing.Trace (trace on)
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('.', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def make_run(bench: Dict[str, Any], workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, root: Path = ROOT) -> Run:
    """The files of one cell, found by name under `root`."""
    bench_dir = root / BENCH_DIR.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    return Run(
        workload=workload, seed=seed, seconds=seconds, trace=trace, chips=w["chips"],
        config=load_json(root / configs[w["config"]]["file"]),
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        cell=load_json(bench_dir / "cells" / f"{workload}.json"),
        per_layer=per_layer, end_to_end=e2e, t_start=t_start, bench_dir=bench_dir,
    )


def traffic_module(run: Run):
    return load_module(run.bench_dir / "traffic" / f"{run.traffic['kind']}.py")


def reader_path(bench_dir: Path, name: str) -> Path:
    """The reader of a per-layer metric: metrics/<name>.py, else the one
    that the metric's variants share, metrics/<name before the first dot>.py."""
    exact = bench_dir / "metrics" / f"{name}.py"
    return exact if exact.exists() else bench_dir / "metrics" / f"{name.split('.', 1)[0]}.py"


def read_per_layer(run: Run, trace) -> Dict[str, Dict[str, Any]]:
    """Each per-layer metric of the cell that its reader finds in the trace."""
    out = {}
    for m in run.per_layer:
        value = load_module(reader_path(run.bench_dir, m["name"])).read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({name for name in sys.modules if name.split(".", 1)[0] in FORBIDDEN})


def set_cache_dirs() -> None:
    """Kernel and extension caches at fixed paths inside the checkout."""
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else None


def is_correct(compared: Dict[str, Dict[str, float]]) -> bool:
    """Every compared number within its limit."""
    return all(c["value"] <= c["limit"] for c in compared.values())


def result_line(run: Run, out: Outcome, device_kind: str) -> Dict[str, Any]:
    correct = is_correct(out.compared)
    device = {"platform": "gpu", "kind": device_kind, "count": run.chips,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    res: Dict[str, Any] = {"correct": correct, "attempted": out.attempted, "failed": out.failed}
    if run.trace:
        res["metrics"] = read_per_layer(run, out.trace)
        device.update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
        res["breakdown"] = {"device_ops": out.trace.top_device_ops(10),
                            "idle_gaps": out.trace.idle_by_host[:10]}
        # the stretches' wall times: their ratios per unit to the first are
        # the profiler's cost and the recorder's
        out.notes["stretches"] = {"unprofiled_s": out.trace.untraced_s,
                                  "unprofiled_units": out.trace.untraced_units,
                                  "profiled_s": out.trace.window_s,
                                  "profiled_units": out.trace.units,
                                  "recorded_s": out.trace.program_s,
                                  "recorded_units": out.trace.program_units}
    else:
        units = {m["name"]: m["unit"] for m in run.end_to_end}
        res["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in out.metrics.items()
                          if k in units}
    res["device"] = device
    res["notes"] = out.notes
    res["compared"] = out.compared
    return res


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once and print its result.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    try:
        run = make_run(benchmark(), args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: cannot set up {args.workload}: {e!r}", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < run.chips:
        print(f"portbench: {run.workload} needs {run.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        out = traffic_module(run).run(run)
    except ImportError as e:
        print(f"portbench: the program cannot be imported here: {e!r}", file=sys.stderr)
        return 3
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    out.notes["card"] = power_limit()
    res = result_line(run, out, torch.cuda.get_device_name(0))
    for name, c in out.compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
