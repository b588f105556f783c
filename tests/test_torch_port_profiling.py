"""The port's profiling hooks (gapartnet_tpu_torch/utils/profiling.py): the
JAX package's StepTimer and maybe_trace cases (tests/test_utils.py), a
Chrome trace written on the CPU, exceptions from the traced body
propagating, and device_memory_stats without a card."""

import json
import time

import pytest
import torch

from gapartnet_tpu.utils import profiling as jprof
from gapartnet_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("mod", [tprof, jprof], ids=["port", "jax"])
def test_step_timer_accumulates(mod):
    t = mod.StepTimer()
    with t.time("a"):
        time.sleep(0.01)
    with t.time("a"):
        time.sleep(0.01)
    with t.time("b"):
        pass
    s = t.summary()
    assert s["a"] >= 5.0  # ms
    assert t.counts["a"] == 2 and t.counts["b"] == 1


def test_step_timer_ema_equal(monkeypatch):
    """The same stage times give the same EMA summary."""
    timers = (tprof.StepTimer(ema=0.8), jprof.StepTimer(ema=0.8))
    ticks = iter([1.0, 1.030, 2.0, 2.002, 3.0, 3.010] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    for t in timers:
        for _ in range(3):
            with t.time("x"):
                pass
    assert timers[0].summary() == timers[1].summary()
    assert timers[0].summary()["x"] == pytest.approx(
        (0.8 * (0.8 * 0.030 + 0.2 * 0.002) + 0.2 * 0.010) * 1000, abs=0.006)


def test_maybe_trace_noop():
    with tprof.maybe_trace(None) as prof:
        x = 1
    assert x == 1 and prof is None


def test_maybe_trace_writes_a_chrome_trace(tmp_path):
    with tprof.maybe_trace(str(tmp_path / "trace")) as prof:
        y = torch.randn(64, 64) @ torch.randn(64, 64)
    assert prof is not None and y.shape == (64, 64)
    files = list((tmp_path / "trace").glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_maybe_trace_propagates_exceptions(tmp_path):
    with pytest.raises(KeyError, match="inside"):
        with tprof.maybe_trace(str(tmp_path / "trace")):
            raise KeyError("inside")
    assert not list((tmp_path / "trace").glob("*.json"))


def test_maybe_trace_unwritable_dir_raises(tmp_path):
    (tmp_path / "a_file").write_text("")
    with pytest.raises(OSError):
        with tprof.maybe_trace(str(tmp_path / "a_file")):
            pass


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tprof.device_memory_stats() == {}


def test_dump_timings_equal(tmp_path):
    for mod, name in ((tprof, "port"), (jprof, "jax")):
        t = mod.StepTimer()
        t.times = {"step": 0.12345, "load": 0.5}
        mod.dump_timings(str(tmp_path / name / "t.jsonl"), t, {"epoch": 3})
    assert (tmp_path / "port" / "t.jsonl").read_text() == (tmp_path / "jax" / "t.jsonl").read_text()
