"""The clustering stage (the program's `model:cluster` span, inclusive)
per train step, in ms, on the host clock in the trace run's recorded
stretch (portbench/recording.py)."""

from portbench import recording


def read(trace):
    return recording.read(trace, "clustering_ms")
