"""Calls that made the host wait for the device (the program's `sync:*`
spans) per unit, in the trace run's recorded stretch.  One reader for
`host_syncs.train` and `host_syncs.request`."""

from portbench import recording


def read(trace):
    return recording.read(trace, "host_syncs")
