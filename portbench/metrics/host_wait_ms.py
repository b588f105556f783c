"""Host time in the program's `sync:*` spans (waiting for the device)
per unit, in ms, in the trace run's recorded stretch.  One reader for
`host_wait_ms.train` and `host_wait_ms.request`."""

from portbench import recording


def read(trace):
    return recording.read(trace, "host_wait_ms")
