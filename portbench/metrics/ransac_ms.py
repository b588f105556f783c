"""The request's RANSAC fit (the program's `request:ransac` span,
inclusive: draws, input copies, fit, box copies) per request, in ms, in
the trace run's recorded stretch."""

from portbench import recording


def read(trace):
    return recording.read(trace, "ransac_ms")
