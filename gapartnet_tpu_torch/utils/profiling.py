"""Profiling and step-timing hooks (the port's counterpart of
utils/profiling.py), and the program's own spans and counters.

A step timer with EMA summaries, a context manager around torch.profiler
tracing that writes a Chrome trace, and a device-memory snapshot.  Unlike
the JAX module's `maybe_trace`, an exception from the traced body
propagates, and a profiler that cannot write its trace raises.

The program marks its layers with `span(name)` (a train step's forward,
backward and optimizer, the model's stages, a request's four stages, every
call that makes the host wait for the device, named `sync:<site>`) and
counts work with `count(name, value)`.  With nothing on, a span is one
shared no-op object and a count does nothing.  Under a torch.profiler (so
also under `maybe_trace`) every span is a `record_function` range as well:
the Chrome trace and the profiler's events carry the program's spans beside
the kernels.  To read them without a profiler, turn the recorder on around
your own calls:

    with profiling.record() as rec:
        infer.predict_with_masks(points, masks)
        torch.cuda.synchronize()
    rec.summary()["request:scatter"]   # {"n": 1, "ms": ..., "self_ms": ...}
    rec.counts["dense_grids_live"]

Spans are host times (`time.perf_counter_ns`), kept in memory.  A count
given as a device tensor is summed when the block ends, after the caller's
synchronize, so no count makes the host wait (the recorder reads each
tensor counter once then).  The recorder serves one thread at a time (a
backward's worker thread runs while its caller waits).
"""

import contextlib
import itertools
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Union

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


class Span(NamedTuple):
    name: str
    parent: int     # index of the enclosing span in Recording.spans, -1 at a root
    t0_ns: int      # time.perf_counter_ns() at entry
    t1_ns: int      # and at exit


class Recording:
    """What one `record()` block saw: `spans` in the order they were
    entered, `counts` by name.  Both are complete when the block ends."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self._rows: List[list] = []        # [name, parent, t0, t1] while open
        self._stack: List[int] = []
        self._tensors: Dict[str, List[torch.Tensor]] = {}

    def _enter(self, name: str) -> int:
        i = len(self._rows)
        self._rows.append([name, self._stack[-1] if self._stack else -1,
                           time.perf_counter_ns(), None])
        self._stack.append(i)
        return i

    def _exit(self, i: int) -> None:
        self._rows[i][3] = time.perf_counter_ns()
        self._stack.pop()

    def _count(self, name: str, value: Union[int, torch.Tensor]) -> None:
        if isinstance(value, torch.Tensor):
            self._tensors.setdefault(name, []).append(value)
        else:
            self.counts[name] = self.counts.get(name, 0) + int(value)

    def _close(self) -> None:
        """Spans still open end now; tensor counts are summed on their
        device (one read per counter, after the caller's synchronize)."""
        end = time.perf_counter_ns()
        self.spans = [Span(n, p, t0, end if t1 is None else t1) for n, p, t0, t1 in self._rows]
        for name, ts in self._tensors.items():
            self.counts[name] = self.counts.get(name, 0) + int(sum(t.sum() for t in ts))
        self._tensors = {}

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per span name: `n` spans, their inclusive time `ms` and their
        `self_ms`, each span's time less the part its child spans cover."""
        covered = [0] * len(self.spans)
        for s in self.spans:
            if s.parent >= 0:
                covered[s.parent] += s.t1_ns - s.t0_ns
        out: Dict[str, Dict[str, float]] = {}
        for s, c in zip(self.spans, covered):
            d = out.setdefault(s.name, {"n": 0, "ms": 0.0, "self_ms": 0.0})
            d["n"] += 1
            d["ms"] += (s.t1_ns - s.t0_ns) / 1e6
            d["self_ms"] += (s.t1_ns - s.t0_ns - c) / 1e6
        return out


_recording: Optional[Recording] = None
_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rf", "rec", "i")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec = _recording
        if self.rec is not None:
            self.i = self.rec._enter(self.name)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec._exit(self.i)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one layer's work: recorded while `record()`
    is on, a `record_function` range while a torch.profiler runs, else the
    shared no-op."""
    if _recording is None and not _profiler_enabled():
        return _OFF
    return _Span(name)


def count(name: str, value: Union[int, torch.Tensor, Callable]) -> None:
    """Add `value` (an int, or a tensor whose sum counts; keep it unchanged
    until the recording ends) to the counter `name` while `record()` is on.
    A callable `value` is called only then, for counts that cost device work."""
    if _recording is not None:
        _recording._count(name, value() if callable(value) else value)


@contextlib.contextmanager
def record():
    """Turn the recorder on for the block and yield its `Recording`.  End
    the block with a synchronize where the spans are to hold the device's
    work.  One recording at a time."""
    global _recording
    if _recording is not None:
        raise RuntimeError("profiling.record: a recording is already on")
    rec = _recording = Recording()
    try:
        yield rec
    finally:
        _recording = None
    rec._close()
