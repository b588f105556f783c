"""The span metrics' arithmetic (portbench/spans.py) on hand-built
recordings: times and syncs per unit, self time of the scatter, the live
share of the dense grids."""

import pytest

from portbench import spans


def _d(n, ms, self_ms=None):
    return {"n": n, "ms": ms, "self_ms": ms if self_ms is None else self_ms}


def test_train_values_per_step():
    summary = {"step": _d(4, 1000.0, 20.0), "step:backward": _d(4, 280.0),
               "step:optimizer": _d(4, 24.0), "model:cluster": _d(4, 180.0, 100.0),
               "sync:ccl_converged": _d(600, 60.0), "sync:constants": _d(40, 8.0)}
    got = spans.values(summary, {}, 4)
    assert got == pytest.approx({"host_syncs.train": 160.0, "host_wait_ms.train": 17.0,
                                 "clustering_ms.train": 45.0, "backward_ms.train": 70.0,
                                 "optimizer_ms.train": 6.0})


def test_request_values_per_request():
    summary = {"request": _d(30, 4200.0, 3.0), "request:scatter": _d(30, 900.0, 450.0),
               "sync:outputs": _d(30, 450.0), "request:ransac": _d(30, 240.0, 150.0),
               "sync:boxes": _d(60, 90.0)}
    counts = {"dense_grids_live": 120, "dense_grids_convolved": 3840}
    got = spans.values(summary, counts, 30)
    assert got == pytest.approx({"host_syncs.request": 3.0, "host_wait_ms.request": 18.0,
                                 "scatter_ms.request": 15.0, "ransac_ms.request": 8.0,
                                 "dense_grid_live_pct.request": 3.125})


def test_absent_spans_give_no_value():
    """A program without spans reads nothing; a stage that never ran reads
    no value, and a unit with no sync span reads zero syncs."""
    assert spans.values({}, {}, 4) == {}
    got = spans.values({"step": _d(4, 1000.0)}, {}, 4)
    assert got == {"host_syncs.train": 0.0, "host_wait_ms.train": 0.0}
    assert "dense_grid_live_pct.request" not in spans.values({"request": _d(30, 10.0)}, {}, 30)
