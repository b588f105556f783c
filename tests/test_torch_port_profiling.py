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


# the program's spans and counters (span, count, record)

SMALL = dict(
    channels=(8, 16, 24), block_repeat=2, max_points=512, max_proposals=32,
    max_instances=8, level_capacity_divisors=(1, 2, 4),
    min_num_points_per_proposal=3, ball_query_radius=0.1,
    max_num_points_per_query=16, max_num_points_per_query_shift=32,
)


def _names(rec):
    return [s.name for s in rec.spans]


def _children(rec, i):
    return [s.name for s in rec.spans if s.parent == i]


def _ancestors(rec, s):
    out = []
    while s.parent >= 0:
        s = rec.spans[s.parent]
        out.append(s.name)
    return out


def test_span_off_is_the_shared_noop(monkeypatch):
    """With neither the recorder nor a profiler on, every span is one
    shared no-op, no record_function is entered and counts go nowhere."""
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) entered with everything off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert tprof.span("a") is tprof.span("b")
    with tprof.span("a"):
        tprof.count("c", torch.ones(3))
        tprof.count("c", 2)
    assert tprof._recording is None
    with tprof.record() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}


def test_spans_nest_with_parents():
    with tprof.record() as rec:
        with tprof.span("root"):
            with tprof.span("a"):
                with tprof.span("a1"):
                    pass
            with tprof.span("b"):
                pass
        with tprof.span("root"):
            pass
    assert _names(rec) == ["root", "a", "a1", "b", "root"]
    assert [s.parent for s in rec.spans] == [-1, 0, 1, 0, -1]
    for s in rec.spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    assert tprof._recording is None


def test_self_time_on_a_hand_built_record():
    """Self time: a span's duration less what its child spans cover; the
    sums are per name."""
    rec = tprof.Recording()
    ms = 1_000_000
    rec.spans = [tprof.Span("request", -1, 0, 100 * ms),
                 tprof.Span("request:forward", 0, 0, 60 * ms),
                 tprof.Span("request:scatter", 0, 60 * ms, 90 * ms),
                 tprof.Span("sync:outputs", 2, 60 * ms, 70 * ms),
                 tprof.Span("sync:outputs", 2, 80 * ms, 85 * ms),
                 tprof.Span("request", -1, 200 * ms, 210 * ms)]
    got = rec.summary()
    assert got["request"] == {"n": 2, "ms": 110.0, "self_ms": 20.0}
    assert got["request:forward"] == {"n": 1, "ms": 60.0, "self_ms": 60.0}
    assert got["request:scatter"] == {"n": 1, "ms": 30.0, "self_ms": 15.0}
    assert got["sync:outputs"] == {"n": 2, "ms": 15.0, "self_ms": 15.0}


def test_tensor_counts_are_summed_when_the_recording_ends():
    """A tensor count is kept as it is and read once, when the block ends:
    a change made to it before then shows in the count."""
    live = torch.tensor([True, False, True, False])
    with tprof.record() as rec:
        tprof.count("live", live)
        tprof.count("grids", 4)
        tprof.count("grids", 4)
        assert "live" not in rec.counts
        live[1] = True
    assert rec.counts == {"live": 3, "grids": 8}


def test_callable_count_is_called_only_while_recording():
    """A callable count costs nothing with the recorder off; on, its value
    counts as an int or a tensor would."""
    calls = []

    def rows():
        calls.append(1)
        return torch.tensor([True, True, False])

    tprof.count("rows", rows)
    assert calls == []
    with tprof.record() as rec:
        tprof.count("rows", rows)
        tprof.count("rows", lambda: 5)
    assert calls == [1] and rec.counts == {"rows": 7}


def test_record_is_off_after_an_error_and_not_reentrant():
    with pytest.raises(RuntimeError, match="already on"):
        with tprof.record():
            with tprof.record():
                pass
    assert tprof._recording is None
    with pytest.raises(KeyError):
        with tprof.record():
            with tprof.span("a"):
                raise KeyError("inside")
    assert tprof._recording is None
    assert tprof.span("a") is tprof._OFF


def test_span_is_a_profiler_range():
    """Under a CPU torch.profiler a span is a record_function range among
    the kineto events, also with the recorder off."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tprof.span("model:test_span"):
            torch.ones(4).sum()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "model:test_span" in names


def test_maybe_trace_carries_program_spans(tmp_path):
    with tprof.maybe_trace(str(tmp_path / "trace")):
        with tprof.span("step:forward"):
            torch.randn(8, 8) @ torch.randn(8, 8)
    (f,) = (tmp_path / "trace").glob("trace-*.json")
    events = json.loads(f.read_text())["traceEvents"]
    assert any(e.get("name") == "step:forward" for e in events)


@pytest.fixture(scope="module")
def small_cloud():
    import numpy as np

    from gapartnet_tpu_torch.data.synthetic import synthetic_cloud

    return synthetic_cloud(np.random.RandomState(2), num_points=SMALL["max_points"], num_parts=4)


def test_predict_with_masks_spans_and_dense_counts(small_cloud):
    """A request is one `request` span with its four stages as children,
    the output copies under the scatter; the dense UNets count their live
    and convolved grids."""
    import numpy as np

    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.infer.api import GAPartNetInference

    cfg = GAPartNetConfig(**SMALL)
    inf = GAPartNetInference(cfg, seed=0, auto_capacity=True, device="cpu")
    c = small_cloud
    masks = np.stack([c["instance_labels"] == k for k in range(3)])
    with tprof.record() as rec:
        inf.predict_with_masks(c["points"], masks)
    names = _names(rec)
    assert names.count("request") == 1
    root = names.index("request")
    assert rec.spans[root].parent == -1
    assert [n for n in _children(rec, root) if n.startswith("request:")] == [
        "request:forward", "request:select", "request:scatter", "request:ransac"]
    outputs = [s for s in rec.spans if s.name == "sync:outputs"]
    assert len(outputs) == 8     # one per output copied to the host
    assert {rec.spans[s.parent].name for s in outputs} == {"request:scatter"}
    for stage in ("model:backbone", "model:heads", "model:proposal_grids", "model:score",
                  "model:npcs"):
        (s,) = [s for s in rec.spans if s.name == stage]
        assert rec.spans[s.parent].name == "request:forward"
    (live,) = [s for s in rec.spans if s.name == "sync:dense_live"]
    assert rec.spans[live.parent].name == "model:proposal_grids"
    # the pool holds the 3 live grids rounded up to a power of two
    assert rec.counts == {"dense_grids_live": 3, "dense_grids_convolved": 4}


def test_train_step_spans_and_ccl_syncs(monkeypatch):
    """A train step is one `step` span with its forward, backward and
    optimizer; clustering runs in the forward, and it has one
    `ccl:iteration` with its `sync:ccl_converged` span per convergence
    test of the hash CCL, counted here by wrapping torch.equal."""
    import numpy as np

    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.data.synthetic import synthetic_batch
    from gapartnet_tpu_torch.models.gapartnet import GAPartNet
    from gapartnet_tpu_torch.structures import PointCloudBatch
    from gapartnet_tpu_torch.train import loop
    from gapartnet_tpu_torch.weights import init_weights

    cfg = GAPartNetConfig(**SMALL)
    model = init_weights(GAPartNet(cfg), torch.Generator().manual_seed(0))
    opt = loop.adam(model.named_parameters())
    d = synthetic_batch(np.random.RandomState(0), batch_size=2, num_points=SMALL["max_points"],
                        num_parts=4, max_instances=SMALL["max_instances"])
    batch = PointCloudBatch.from_numpy(d, "cpu")
    inst = batch.instance_labels
    off = torch.where((inst >= 0)[..., None],
                      batch.instance_regions[..., :3] - batch.points[..., :3], torch.zeros(()))
    tests = []
    equal = torch.equal

    def counted(a, b):
        tests.append(1)
        return equal(a, b)

    monkeypatch.setattr(torch, "equal", counted)
    with tprof.record() as rec:
        loop.train_step(model, opt, batch, torch.Generator().manual_seed(1), True, True, True,
                        cluster_sem_override=batch.sem_labels, cluster_offset_override=off)
    names = _names(rec)
    assert names[0] == "step" and names.count("step") == 1
    assert _children(rec, 0) == ["step:prepare", "step:forward", "step:backward",
                                 "step:optimizer", "step:metrics"]
    fwd = names.index("step:forward")
    assert [n for n in _children(rec, fwd)] == [
        "model:grid", "model:backbone", "model:heads", "model:cluster", "model:proposal_grids",
        "model:score", "model:npcs"]
    syncs = [s for s in rec.spans if s.name == "sync:ccl_converged"]
    assert len(tests) > 0 and len(syncs) == len(tests)
    assert {rec.spans[s.parent].name for s in syncs} == {"ccl:iteration"}
    assert names.count("ccl:iteration") == len(syncs)
    assert all("model:cluster" in _ancestors(rec, s) for s in syncs)
    assert "dense_grids_live" not in rec.counts   # training runs the sparse UNets


def test_hash_train_step_clusters_the_batch_in_one_call():
    """With hash clustering a B = 2 train step clusters both clouds in one
    call: one `cluster:batch` with one `ccl:nodes` inside `model:cluster`,
    no `cluster:cloud`; `hash_ccl_clouds` counts the batch's clouds and
    `hash_ccl_iterations` its convergence tests, one `sync:ccl_converged`
    each."""
    import numpy as np

    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.data.synthetic import synthetic_batch
    from gapartnet_tpu_torch.models.gapartnet import GAPartNet
    from gapartnet_tpu_torch.structures import PointCloudBatch
    from gapartnet_tpu_torch.train import loop
    from gapartnet_tpu_torch.weights import init_weights

    cfg = GAPartNetConfig(**SMALL)
    model = init_weights(GAPartNet(cfg), torch.Generator().manual_seed(0))
    opt = loop.adam(model.named_parameters())
    d = synthetic_batch(np.random.RandomState(0), batch_size=2, num_points=SMALL["max_points"],
                        num_parts=4, max_instances=SMALL["max_instances"])
    batch = PointCloudBatch.from_numpy(d, "cpu")
    inst = batch.instance_labels
    off = torch.where((inst >= 0)[..., None],
                      batch.instance_regions[..., :3] - batch.points[..., :3], torch.zeros(()))
    with tprof.record() as rec:
        loop.train_step(model, opt, batch, torch.Generator().manual_seed(1), True, True, True,
                        cluster_sem_override=batch.sem_labels, cluster_offset_override=off)
    names = _names(rec)
    assert names.count("cluster:batch") == names.count("ccl:nodes") == 1
    assert "cluster:cloud" not in names
    (cluster,) = [s for s in rec.spans if s.name == "cluster:batch"]
    assert _ancestors(rec, cluster)[0] == "model:cluster"
    assert rec.counts["hash_ccl_clouds"] == 2
    assert rec.counts["hash_ccl_iterations"] == names.count("sync:ccl_converged") > 0
    assert rec.summary()["sync:ccl_constant"]["n"] == 4


def test_exact_train_step_ball_query_and_ccl_spans():
    """With exact clustering each cloud runs two ball queries and two CCLs,
    a `cluster:ball_query` and a `cluster:ccl` span each inside its
    `cluster:cloud`; every host sync has its span: the r2 copy and the
    valid points' gather once a ball query, the band `nonzero` once a tile,
    the convergence test once per CCL iteration (the last test finds the
    labels unchanged).  No CCL is cut off by its iteration cap."""
    import numpy as np

    from gapartnet_tpu_torch.config import GAPartNetConfig
    from gapartnet_tpu_torch.data.synthetic import synthetic_batch
    from gapartnet_tpu_torch.models.gapartnet import GAPartNet
    from gapartnet_tpu_torch.structures import PointCloudBatch
    from gapartnet_tpu_torch.train import loop
    from gapartnet_tpu_torch.weights import init_weights

    cfg = GAPartNetConfig(**SMALL, clustering_impl="exact")
    model = init_weights(GAPartNet(cfg), torch.Generator().manual_seed(0))
    opt = loop.adam(model.named_parameters())
    d = synthetic_batch(np.random.RandomState(0), batch_size=2, num_points=SMALL["max_points"],
                        num_parts=4, max_instances=SMALL["max_instances"])
    batch = PointCloudBatch.from_numpy(d, "cpu")
    inst = batch.instance_labels
    off = torch.where((inst >= 0)[..., None],
                      batch.instance_regions[..., :3] - batch.points[..., :3], torch.zeros(()))
    with tprof.record() as rec:
        metrics = loop.train_step(model, opt, batch, torch.Generator().manual_seed(1), True, True,
                                  True, cluster_sem_override=batch.sem_labels,
                                  cluster_offset_override=off)
    names = _names(rec)
    summary = rec.summary()
    for name in ("cluster:ball_query", "cluster:ccl"):
        spans = [s for s in rec.spans if s.name == name]
        assert len(spans) == 2 * 2
        assert {rec.spans[s.parent].name for s in spans} == {"cluster:cloud"}
    assert "ccl:iteration" not in names and "sync:ccl_converged" not in names
    assert summary["sync:ball_query_constant"]["n"] == summary["sync:ball_query_valid"]["n"] == 4
    assert summary["sync:ball_query_band"]["n"] == rec.counts["ball_query_tiles"] >= 4
    converged = [s for s in rec.spans if s.name == "sync:ccl_exact_converged"]
    assert len(converged) == rec.counts["ccl_exact_iterations"] >= 4
    assert {rec.spans[s.parent].name for s in converged} == {"cluster:ccl"}
    assert rec.counts["ccl_exact_unconverged"] == 0
    assert rec.counts["ball_query_band_pairs"] >= 0
    assert rec.counts["ball_query_hits"] >= rec.counts["ball_query_full_rows"] >= 0
    assert rec.counts["ball_query_index_sum"] >= 0
    assert float(metrics["counters/ccl_exact_unconverged"]) == 0


@pytest.mark.parametrize("max_iters, cut", [(1, 1), (2, 1), (4, 0), (64, 0)])
def test_exact_ccl_counts_a_cut_off_chain(max_iters, cut):
    """A directed chain of 40 nodes reaches its fixpoint in 3 iterations (a
    4th finds it): a cap below 3 ends the loop before the fixpoint, which
    the flag and the counter `ccl_exact_unconverged` report, and a cap of
    4 or more does not; a call makes as many convergence tests as
    iterations.  A CPU tensor takes the plain loop: no kernel launch, and
    the flag a () int32 tensor as on the card."""
    from gapartnet_tpu_torch.ops import ccl

    n = 40
    nbr = torch.full((n, 2), -1, dtype=torch.int32)
    nbr[:-1, 0] = torch.arange(1, n, dtype=torch.int32)
    with tprof.record() as rec:
        labels, flag = ccl.connected_components_single(nbr, torch.ones(n, dtype=torch.bool),
                                                       max_iters)
    assert "ccl_exact_launches" not in rec.counts
    assert flag.shape == () and flag.dtype == torch.int32
    assert flag == cut and rec.counts["ccl_exact_unconverged"] == cut
    assert rec.counts["ccl_exact_iterations"] == rec.summary()["sync:ccl_exact_converged"]["n"]
    assert bool((labels == 0).all()) == (cut == 0)
