"""The exact CCL's propagation iterations (the program's counter
`ccl_exact_iterations`; each is followed by one convergence test, a host
sync) per train step, in the trace run's recorded stretch
(portbench/recording.py).  None where the recording holds no train steps
or the program keeps no such counter."""


def read(trace):
    if trace is None or trace.program_units <= 0 or "step" not in trace.program_summary:
        return None
    got = trace.program_counts.get("ccl_exact_iterations")
    return None if got is None else got / trace.program_units
