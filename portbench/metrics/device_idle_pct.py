"""Share of the profiled stretch's wall time in which no operation ran on
the device (the union of kernel, copy and set intervals), in %.  One
reader for `device_idle_pct.train` and `device_idle_pct.request`."""


def read(trace):
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
