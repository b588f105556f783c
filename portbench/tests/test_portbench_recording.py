"""The trace run's recorded stretch: each span metric's reader on a
hand-built trace, nothing read without a recording, the variant a cell
reads, the stretch on the program's recorder, and idle time named by the
innermost host span however long ago its parents started."""

import pytest

from portbench import harness, recording, tracing

BENCH = harness.benchmark()
TRAIN_CELLS = ["sparseunet-fp32.train-b8", "pointnet-fp32.train-b8"]
MASKS = "sparseunet-fp32.masks-b1"
SPAN_METRICS = {
    "clustering_ms.train": 45.0, "backward_ms.train": 70.0, "optimizer_ms.train": 6.0,
    "host_syncs.train": 160.0, "host_wait_ms.train": 17.0,
    "host_syncs.request": 3.0, "host_wait_ms.request": 18.0, "scatter_ms.request": 15.0,
    "ransac_ms.request": 8.0, "dense_grid_live_pct.request": 3.125,
}


def _d(n, ms, self_ms=None):
    return {"n": n, "ms": ms, "self_ms": ms if self_ms is None else self_ms}


def _trace(**program):
    return tracing.Trace(untraced_s=1.0, untraced_units=4, backbone_ms=[], window_s=2.0,
                         busy_s=0.5, units=4, device=[], under_conv_s=0.0, idle_by_host=[],
                         **program)


def _train_trace():
    summary = {"step": _d(4, 1000.0, 20.0), "step:backward": _d(4, 280.0),
               "step:optimizer": _d(4, 24.0), "model:cluster": _d(4, 180.0, 100.0),
               "sync:ccl_converged": _d(600, 60.0), "sync:constants": _d(40, 8.0)}
    return _trace(program_s=1.1, program_units=4, program_summary=summary, program_counts={})


def _request_trace():
    summary = {"request": _d(30, 4200.0, 3.0), "request:scatter": _d(30, 900.0, 450.0),
               "sync:outputs": _d(30, 450.0), "request:ransac": _d(30, 240.0, 150.0),
               "sync:boxes": _d(60, 90.0)}
    counts = {"dense_grids_live": 120, "dense_grids_convolved": 3840}
    return _trace(program_s=4.3, program_units=30, program_summary=summary,
                  program_counts=counts)


def _reader(name):
    return harness.load_module(harness.reader_path(harness.BENCH_DIR, name))


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_gives_the_values_figure(name):
    trace = _train_trace() if name.endswith(".train") else _request_trace()
    got = _reader(name).read(trace)
    want = recording.values(trace.program_summary, trace.program_counts, trace.program_units)
    assert got == pytest.approx(want[name])
    assert got == pytest.approx(SPAN_METRICS[name])


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_reads_nothing_without_a_recording(name):
    assert _reader(name).read(_trace()) is None
    assert _reader(name).read(None) is None


@pytest.mark.parametrize("cell", TRAIN_CELLS + [MASKS])
def test_a_cell_reads_the_variant_of_its_workloads(cell):
    run = harness.make_run(BENCH, cell, 1, 1.0, True, 0.0)
    trace = _request_trace() if cell == MASKS else _train_trace()
    got = harness.read_per_layer(run, trace)
    suffix = ".request" if cell == MASKS else ".train"
    span_names = {n for n in got if n in SPAN_METRICS}
    assert span_names == {n for n in SPAN_METRICS if n.endswith(suffix)}
    for n in span_names:
        assert got[n]["value"] == pytest.approx(SPAN_METRICS[n])
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    assert all(entries[n]["source"] in ("program_span", "program_counter") for n in span_names)


def test_recorded_stretch_on_the_program_recorder():
    """Two units, each a `step` span holding a backward and two syncs, with
    a count; the stretch reads them per unit on the host clock."""
    from gapartnet_tpu_torch.utils import profiling

    def units(unit_span):
        for _ in range(2):
            with unit_span(), profiling.span("step"):
                with profiling.span("step:backward"):
                    with profiling.span("sync:a"):
                        pass
                with profiling.span("sync:b"):
                    pass
                profiling.count("things", 3)
        return 2

    rec = recording.recorded_stretch(units, lambda: None)
    assert rec["units"] == 2 and rec["wall_s"] > 0 and rec["counts"] == {"things": 6}
    assert rec["summary"]["sync:a"]["n"] == 2 and rec["summary"]["step"]["n"] == 2
    got = recording.values(rec["summary"], rec["counts"], rec["units"])
    assert got["host_syncs.train"] == 2.0 and "backward_ms.train" in got
    off = recording.recorded_stretch(units, lambda: None, on=False)
    assert set(off) == {"wall_s", "units"} and off["units"] == 2


def test_no_recorded_stretch_without_the_recorder(monkeypatch):
    from gapartnet_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "record")
    ran = []
    assert recording.recorded_stretch(lambda unit_span: ran.append(1) or 1, lambda: None) is None
    assert ran == []


def _index(*threads):
    return {tid: tracing._host_index(spans) for tid, spans in enumerate(threads)}


def test_idle_named_by_spans_that_started_long_before():
    """The parent spans started 600 host events before t: the innermost
    open span is still found, named with its parent."""
    main = [(tracing.STRETCH, 0.0, 100.0), (tracing.UNIT, 1.0, 99.0), ("step", 1.5, 98.0),
            ("step:backward", 2.0, 50.0)]
    main += [("aten::op", 2.0 + 0.05 * k, 2.0 + 0.05 * k + 0.01) for k in range(600)]
    main += [("step:optimizer", 60.0, 70.0), ("aten::add", 60.0, 60.5)]
    index = _index(main)
    assert tracing._innermost(index, 49.99) == "step > step:backward"
    assert tracing._innermost(index, 2.005) == "step:backward > aten::op"
    assert tracing._innermost(index, 55.0) == "portbench:unit > step"
    assert tracing._innermost(index, 60.25) == "step:optimizer > aten::add"
    assert tracing._innermost(index, 99.5) == "host: no op"
    assert tracing._innermost(_index([]), 1.0) == "host: no op"


def test_idle_named_by_the_thread_whose_span_started_last():
    main = [(tracing.STRETCH, 0.0, 100.0), ("step", 1.0, 98.0), ("step:backward", 2.0, 50.0)]
    worker = [("autograd::engine::evaluate_function: X", 30.0, 31.0),
              ("XBackward", 30.1, 30.9), ("aten::mm", 30.2, 30.3)]
    index = _index(main, worker)
    assert tracing._innermost(index, 30.5) == "autograd::engine::evaluate_function: X > XBackward"
    assert tracing._innermost(index, 31.5) == "step > step:backward"
