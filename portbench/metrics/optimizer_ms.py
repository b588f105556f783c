"""The train step's optimizer stage (the program's `step:optimizer`
span, inclusive: fill, rank sum, Adam) per step, in ms, in the trace
run's recorded stretch."""

from portbench import recording


def read(trace):
    return recording.read(trace, "optimizer_ms")
