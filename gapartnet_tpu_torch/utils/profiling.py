"""Profiling and step-timing hooks (the port's counterpart of
utils/profiling.py).

A step timer with EMA summaries, a context manager around torch.profiler
tracing that writes a Chrome trace, and a device-memory snapshot.  Unlike
the JAX module's `maybe_trace`, an exception from the traced body
propagates, and a profiler that cannot write its trace raises.
"""

import contextlib
import itertools
import json
import os
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_TRACE_IDS = itertools.count()


class StepTimer:
    """Accumulates per-stage wall times; synchronizing is the caller's job

    (time around torch.cuda.synchronize() for honest numbers)."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        if name in self.times:
            self.times[name] = self.ema * self.times[name] + (1 - self.ema) * dt
        else:
            self.times[name] = dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {k: round(v * 1000, 2) for k, v in self.times.items()}  # ms


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]):
    """torch.profiler around the body, CPU activity plus CUDA activity when
    a CUDA device is available, written as a Chrome trace
    `trace-<pid>-<n>.json` under `trace_dir`; a no-op for None.  Yields the
    profiler (None when off)."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace-{os.getpid()}-{next(_TRACE_IDS)}.json")
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    if not os.path.exists(path):
        raise RuntimeError(f"maybe_trace: the profiler wrote no trace at {path}")


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per CUDA device: bytes_in_use, peak_bytes_in_use and bytes_limit
    (the JAX names), from torch.cuda.memory_stats and mem_get_info; {}
    without a CUDA device."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
        }
    return out


def dump_timings(path: str, timer: StepTimer, extra: Optional[dict] = None):
    rec = {"timings_ms": timer.summary(), **(extra or {})}
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "a") as f:
        f.write(json.dumps(rec) + "\n")
