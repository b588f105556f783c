"""Live proposal grids over the grids the dense proposal UNets convolve
(the program's counters `dense_grids_live` / `dense_grids_convolved`)
in the trace run's recorded stretch, in %."""

from portbench import recording


def read(trace):
    return recording.read(trace, "dense_grid_live_pct")
