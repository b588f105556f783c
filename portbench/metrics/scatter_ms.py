"""The request's host scatter (the program's `request:scatter` span,
self time: less its `sync:outputs` copies) per request, in ms, in the
trace run's recorded stretch."""

from portbench import recording


def read(trace):
    return recording.read(trace, "scatter_ms")
