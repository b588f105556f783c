"""The train step's backward (the program's `step:backward` span,
inclusive) per step, in ms, in the trace run's recorded stretch."""

from portbench import recording


def read(trace):
    return recording.read(trace, "backward_ms")
