"""The traced stretch of a `--trace 1` run, read in memory.

`traced_stretch` runs a few steps or requests three times.  The first stretch
runs with no profiler, only CUDA events around the backbone's forward, and
is timed by the host clock to a synchronize: the readers of times and
rates (`backbone_fwd_ms.*`, `mfu_pct.*`) take it, since the profiler's
cost per host op about doubles a host-bound step.  The second runs under
torch.profiler (host ops and device activity), with a span for the whole
stretch that ends in a synchronize, a span for each unit of work and a
span for each hooked module's forward: the device intervals, the idle
stretches and the kernels' device time come from it.  The third runs with
the program's recorder on (portbench/recording.py) and no profiler, on the
host clock to a synchronize: the span and counter metrics take it.  Nothing
is written to disk: the profiler's events and the recording are read once
into a `Trace`, from which the per-layer readers (portbench/metrics) take
their numbers.
"""

import bisect
import collections
import contextlib
import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench import recording, stats

STRETCH = "portbench:stretch"
UNIT = "portbench:unit"


@dataclasses.dataclass
class Trace:
    # the unprofiled stretch
    untraced_s: float                    # host time of the stretch, ending in a synchronize
    untraced_units: int                  # steps or requests in it
    backbone_ms: List[float]             # the backbone's forward, per call (CUDA events)
    # the profiled stretch
    window_s: float                      # host time of the stretch, ending in a synchronize
    busy_s: float                        # union of device activity in the stretch
    units: int                           # steps or requests in the stretch
    device: List[Tuple[str, float, float]]   # (name, start s, end s) of each device activity
    under_conv_s: float                  # device time of kernels launched under aten::convolution
    idle_by_host: List[Tuple[str, float]]    # idle seconds by what the host was doing
    # the work of each stretch's units (portbench/work.py), filled by the traffic
    untraced_work: Dict[str, float] = dataclasses.field(default_factory=dict)
    work: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the recorded stretch, after the other two (none where the program has no recorder)
    program_s: float = 0.0               # host time of the stretch, ending in a synchronize
    program_units: int = 0               # steps or requests in it
    program_summary: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    program_counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def device_seconds(self, pattern) -> float:
        return sum(e - s for n, s, e in self.device if pattern.search(n))

    def top_device_ops(self, k: int = 10) -> List[List]:
        tot = collections.Counter()
        for n, s, e in self.device:
            tot[n] += e - s
        return [[n, t] for n, t in tot.most_common(k)]


def _t(e, which: str) -> float:
    """A kineto event's start or end in seconds."""
    if hasattr(e, "start_ns"):
        ns = e.start_ns() if which == "start" else (
            e.end_ns() if hasattr(e, "end_ns") else e.start_ns() + e.duration_ns())
        return ns * 1e-9
    us = e.start_us() if which == "start" else e.start_us() + e.duration_us()
    return us * 1e-6


class _ModuleSpans:
    """record_function spans around hooked modules' forwards."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.handles, self.open = [], []
        for name, mod in modules.items():
            self.handles.append(mod.register_forward_pre_hook(self._enter(name)))
            self.handles.append(mod.register_forward_hook(self._exit))

    def _enter(self, name):
        def hook(mod, args):
            rf = torch.profiler.record_function(f"module:{name}")
            rf.__enter__()
            self.open.append(rf)
        return hook

    def _exit(self, mod, args, out):
        self.open.pop().__exit__(None, None, None)

    def remove(self):
        for h in self.handles:
            h.remove()


class _ForwardEvents:
    """CUDA events around a module's forwards."""

    def __init__(self, module: Optional[torch.nn.Module]):
        self.handles, self.events = [], []
        if module is not None:
            self.handles.append(module.register_forward_pre_hook(self._start))
            self.handles.append(module.register_forward_hook(self._end))

    def _start(self, mod, args):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append([ev, None])

    def _end(self, mod, args, out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[-1][1] = ev

    def elapsed_ms(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in self.events if b is not None]

    def remove(self):
        for h in self.handles:
            h.remove()


def _host_index(spans: List[Tuple[str, float, float]]):
    """One thread's host events as (starts, spans, parents), sorted by start
    and, at one start, the longest first; each event's parent is the latest
    earlier one still open at its start (a thread's events nest), -1 at a root."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    parents, open_ = [], []
    for i, (_, start, _) in enumerate(spans):
        while open_ and spans[open_[-1]][2] < start:
            open_.pop()
        parents.append(open_[-1] if open_ else -1)
        open_.append(i)
    return [s[1] for s in spans], spans, parents


def _innermost(index_by_thread, t: float) -> str:
    """Name of the innermost host event at time t (the latest-starting one
    that contains t, on any thread), with its parent's name before it.  On
    each thread the latest event to start by t, or the nearest of its
    enclosing events that has not ended by t, is the innermost there,
    however long ago its parents started."""
    best, best_start = None, None
    for starts, spans, parents in index_by_thread.values():
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i][2] < t:
            i = parents[i]
        if i < 0 or (best_start is not None and spans[i][1] <= best_start):
            continue
        best_start, names = spans[i][1], []
        while i >= 0 and len(names) < 2:
            if spans[i][0] != STRETCH and spans[i][1] <= t <= spans[i][2]:
                names.append(spans[i][0])
            i = parents[i]
        best = names
    return " > ".join(reversed(best)) if best else "host: no op"


def traced_stretch(run_units: Callable[[Callable], int], modules: Dict[str, torch.nn.Module],
                   backbone: Optional[torch.nn.Module]) -> Trace:
    """Run `run_units(unit_span)` three times: with no profiler and CUDA
    events around `backbone`'s forward; under the profiler with spans
    around `modules`' forwards; with the program's recorder on (skipped
    where the program has none).  `unit_span()` gives the context manager
    the traffic wraps each step or request in, and `run_units` returns the
    number of units it ran."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    fwd = _ForwardEvents(backbone)
    try:
        t0 = time.perf_counter()
        untraced_units = run_units(contextlib.nullcontext)
        torch.cuda.synchronize()
        untraced_s = time.perf_counter() - t0
    finally:
        fwd.remove()
    backbone_ms = fwd.elapsed_ms()

    spans = _ModuleSpans(modules)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(STRETCH):
                units = run_units(lambda: record_function(UNIT))
                torch.cuda.synchronize()
    finally:
        spans.remove()
    torch.cuda.synchronize()
    trace = Trace(untraced_s=untraced_s, untraced_units=untraced_units, backbone_ms=backbone_ms,
                  units=units, **_read_profile(prof))
    # the profiler's events go, and are collected, before the recorded
    # stretch: left to the collector they slow its steps by about a tenth
    del prof
    gc.collect()

    rec = recording.recorded_stretch(run_units, torch.cuda.synchronize)
    if rec is not None:
        trace.program_s, trace.program_units = rec["wall_s"], rec["units"]
        trace.program_summary, trace.program_counts = rec["summary"], rec["counts"]
    return trace


def _read_profile(prof) -> Dict:
    """The profiled stretch's fields of a `Trace`, from the profiler's events."""
    events = prof.profiler.kineto_results.events()
    cpu = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU]
    # device-side copies of host annotations (record_function spans) share
    # their host span's name; every kernel, copy and set has its own
    host_names = {e.name() for e in cpu}
    dev = [e for e in events if e.device_type() != torch.autograd.DeviceType.CPU
           and e.name() not in host_names]
    stretch = [e for e in cpu if e.name() == STRETCH]
    if not stretch:
        raise RuntimeError("the profiler recorded no stretch span")
    lo, hi = _t(stretch[0], "start"), _t(stretch[0], "end")
    device = [(e.name(), _t(e, "start"), _t(e, "end")) for e in dev]
    device = [(n, max(s, lo), min(e, hi)) for n, s, e in device if e > lo and s < hi]
    busy = stats.union_length([(s, e) for _, s, e in device], lo, hi)

    # host spans per thread, nested, for naming idle stretches
    by_thread = collections.defaultdict(list)
    for e in cpu:
        by_thread[e.start_thread_id()].append((e.name(), _t(e, "start"), _t(e, "end")))
    index_by_thread = {tid: _host_index(spans) for tid, spans in by_thread.items()}
    idle = collections.Counter()
    for a, b in stats.gaps([(s, e) for _, s, e in device], lo, hi):
        idle[_innermost(index_by_thread, 0.5 * (a + b))] += b - a

    # kernels launched under aten::convolution: the op each kernel links to
    # starts inside a convolution op of its thread
    conv = collections.defaultdict(list)
    for e in cpu:
        if e.name() == "aten::convolution":
            conv[e.start_thread_id()].append((_t(e, "start"), _t(e, "end")))
    for v in conv.values():
        v.sort()
    launch = {e.correlation_id(): (e.start_thread_id(), _t(e, "start")) for e in cpu}
    under_conv = 0.0
    for e in dev:
        th_t = launch.get(e.linked_correlation_id())
        if th_t is None or th_t[0] not in conv:
            continue
        iv = conv[th_t[0]]
        i = bisect.bisect_right(iv, (th_t[1], float("inf"))) - 1
        if i >= 0 and iv[i][0] <= th_t[1] <= iv[i][1]:
            s, t = max(_t(e, "start"), lo), min(_t(e, "end"), hi)
            under_conv += max(t - s, 0.0)
    return dict(window_s=hi - lo, busy_s=busy, device=device, under_conv_s=under_conv,
                idle_by_host=[[n, t] for n, t in idle.most_common(10)])
