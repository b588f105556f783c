"""The exact clustering's connected components (the program's `cluster:ccl`
spans, inclusive: one per ball query, 16 a B = 8 step) per train step, in
ms, on the host clock in the trace run's recorded stretch
(portbench/recording.py).  None where the recording holds no train steps
or no such span."""


def read(trace):
    if trace is None or trace.program_units <= 0 or "step" not in trace.program_summary:
        return None
    got = trace.program_summary.get("cluster:ccl")
    return None if got is None else got["ms"] / trace.program_units
