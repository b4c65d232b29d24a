"""Per-op device attribution in the port (monitor/deviceprof.py) on the
CPU.

Port twin of tests/test_deviceprof.py: the scope scheme (`op_scope`,
`SCOPE_RE`, `scope_of`) equals the reference's; `attribute`'s join
arithmetic, roofline verdicts and the row renderings equal the
reference's on the same aggregate; the kineto-shaped aggregation
attributes each device event to the op scope enclosing its launch (by
CUPTI correlation, uncorrelated kernels paired in order with the
uncorrelated launch calls, CUDA-graph replays by name under their rung)
and falls back to leaf CPU ops without device events; `profile_program`
runs end to end on the CPU (`host-cpu`: every row names an op of the
program, the attributed time is at most the total); the executor enters
its op scopes only while a profile captures; and the serving sampler
exists only with `profile_sample_n` > 0, times 1 in N dispatches into
per-rung histograms and links them to a device lane by flow events.
"""

import json
import time

import numpy as np
import pytest

from paddle_tpu.monitor import deviceprof as jdp
import paddle_tpu_torch as pt
from paddle_tpu_torch import flags, monitor
from paddle_tpu_torch.monitor import deviceprof as dp
from paddle_tpu_torch.monitor import trace as mon_trace
from paddle_tpu_torch.serving import EngineConfig, InferenceEngine


@pytest.fixture(autouse=True)
def clean():
    pt.framework.reset_default_programs()
    monitor.reset()
    monitor.set_enabled(False)
    mon_trace.stop(save=False)
    dp.reset()
    flags.set_flag("profile_sample_n", 0)
    yield
    monitor.reset()
    monitor.set_enabled(False)
    mon_trace.stop(save=False)
    dp.reset()
    flags.set_flag("profile_sample_n", 0)


@pytest.mark.parametrize("text", [
    "jit(step)/jit(main)/0/7:matmul/dot_general",
    "0/2:while/1/0:elementwise_add/add", "0/12:mul", "", "no/scope/here",
    "0/3:fused_lm_head_xent_grad", "7/40:layer_norm.x-y"])
def test_scope_scheme_equals_the_references(text):
    assert dp.scope_of(text) == jdp.scope_of(text)
    assert dp.SCOPE_RE.pattern == jdp.SCOPE_RE.pattern
    assert dp.op_scope(0, 7, "matmul") == jdp.op_scope(0, 7, "matmul") \
        == "0/7:matmul"
    assert dp.scope_op_type("0/7:matmul") == "matmul"


def _fixture_agg():
    return {"ops": {
        "dot.6": {"dur_us": 80.0, "calls": 2, "scope_hint": None},
        "fusion.1": {"dur_us": 10.0, "calls": 1, "scope_hint": "0/5:relu"},
        "exp.3": {"dur_us": 5.0, "calls": 1, "scope_hint": "0/9:exp"},
        "copy.9": {"dur_us": 5.0, "calls": 1, "scope_hint": None},
    }, "total_us": 100.0, "source": "device"}


_STATIC = {"0/3:matmul": {"flops": 8_000_000, "bytes": 4_000, "eqns": 1},
           "0/5:relu": {"flops": 0, "bytes": 1_000_000, "eqns": 1}}


@pytest.mark.parametrize("steps,peak,bw", [(1, 1e12, 1e9), (2, 1e12, 1e9),
                                           (3, 989e12, 3.35e12)])
def test_attribute_join_equals_the_references(steps, peak, bw):
    args = (_fixture_agg(), {"dot.6": "0/3:matmul"}, _STATIC)
    mine = dp.attribute(*args, steps=steps, peak=peak, bw=bw)
    assert mine == jdp.attribute(*args, steps=steps, peak=peak, bw=bw)
    rows, coverage, unresolved = mine
    assert coverage == pytest.approx(0.95)
    assert unresolved == pytest.approx(5.0 / steps)
    by = {r["scope"]: r for r in rows}
    assert by["0/3:matmul"]["device_time_us"] == pytest.approx(80 / steps)
    assert by["0/5:relu"]["verdict"] == "transfer-bound"
    assert by["0/9:exp"]["verdict"] == "unknown"
    assert dp.format_rows(rows, top=3) == jdp.format_rows(rows, top=3)
    assert dp.brief_rows(rows) == jdp.brief_rows(rows)
    json.dumps(dp.brief_rows(rows))


def _x(name, cat, ts, dur, **args):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
          "pid": 1, "tid": 2}
    if args:
        ev["args"] = args
    return ev


def _kineto_fixture():
    """Two op scopes on the executor thread (and a device-timeline
    projection of another); kernels launched inside them (one
    correlated through cudaLaunchKernel, one through the autograd
    thread's launch, one only through an uncorrelated cuLaunchKernelEx),
    a memcpy launched outside every scope, and a CUDA-graph kernel."""
    return [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "python"}},
        _x("0/3:mul", "user_annotation", 100.0, 50.0),
        _x("0/4:mul_grad", "user_annotation", 200.0, 80.0),
        # kineto's projection of a scope onto the device timeline: host
        # launch times must not be matched against it
        _x("0/9:exp", "gpu_user_annotation", 225.0, 10.0),
        _x("aten::mm", "cpu_op", 101.0, 20.0),
        _x("cudaLaunchKernel", "cuda_runtime", 110.0, 3.0, correlation=11),
        _x("cudaLaunchKernel", "cuda_runtime", 230.0, 3.0, correlation=12),
        _x("cuLaunchKernelEx", "cuda_driver", 250.0, 4.0),
        _x("cudaMemcpyAsync", "cuda_runtime", 300.0, 2.0, correlation=13),
        _x("cudaGraphLaunch", "cuda_runtime", 400.0, 5.0, correlation=14),
        _x("gemm_kernel", "kernel", 120.0, 30.0, correlation=11),
        _x("gemm_kernel", "kernel", 235.0, 25.0, correlation=12),
        _x("flash_bwd_kernel", "kernel", 262.0, 40.0),
        _x("Memcpy DtoH", "gpu_memcpy", 305.0, 5.0, correlation=13),
        _x("int8_matmul_kernel", "kernel", 410.0, 10.0, correlation=14),
    ]


def test_kineto_aggregation_attributes_each_kernel_to_its_launch_scope():
    agg = dp.aggregate_trace(_kineto_fixture())
    assert agg["source"] == "device"
    assert agg["total_us"] == 110.0
    ops = agg["ops"]
    assert ops["0/3:mul|gemm_kernel"]["dur_us"] == 30.0
    assert ops["0/4:mul_grad|gemm_kernel"]["dur_us"] == 25.0
    # uncorrelated: paired in order with the uncorrelated driver launch
    assert ops["0/4:mul_grad|flash_bwd_kernel"]["scope_hint"] == \
        "0/4:mul_grad"
    assert ops["Memcpy DtoH"]["scope_hint"] is None
    assert ops["int8_matmul_kernel"]["scope_hint"] is None
    assert agg["kernels"]["gemm_kernel"] == {"events": 2, "dur_us": 55.0}
    assert agg["links"] == {"correlated": 4, "paired": 1, "unlaunched": 0}
    rows, coverage, unresolved = dp.attribute(agg, {}, peak=1e12, bw=1e9)
    assert coverage == pytest.approx(95.0 / 110.0)
    assert unresolved == pytest.approx(15.0)
    assert [r["scope"] for r in rows] == ["0/4:mul_grad", "0/3:mul"]
    # a CUDA-graph replay carries no op scope: attributed by name under
    # its rung
    agg = dp.aggregate_trace(_kineto_fixture(), unscoped="rung8")
    assert agg["ops"]["rung8:int8_matmul_kernel|int8_matmul_kernel"][
        "scope_hint"] == "rung8:int8_matmul_kernel"
    rows, coverage, _ = dp.attribute(agg, {}, peak=1e12, bw=1e9)
    assert coverage == 1.0
    assert "int8_matmul_kernel" in {r["op_type"] for r in rows}


def test_uncorrelated_kernels_pair_only_one_to_one():
    """Two uncorrelated kernels and one uncorrelated launch call: no
    pairing is trusted, both stay unresolved."""
    events = _kineto_fixture() + [_x("flash_fwd_kernel", "kernel", 500.0,
                                     6.0)]
    agg = dp.aggregate_trace(events)
    assert agg["links"] == {"correlated": 4, "paired": 0, "unlaunched": 2}
    assert agg["ops"]["flash_bwd_kernel"]["scope_hint"] is None
    _, coverage, _ = dp.attribute(agg, {}, peak=1e12, bw=1e9)
    assert coverage == pytest.approx(55.0 / 116.0)


def test_host_cpu_aggregation_counts_leaf_ops_only():
    events = [_x("0/1:mul", "user_annotation", 0.0, 100.0),
              _x("aten::linear", "cpu_op", 5.0, 60.0),
              _x("aten::mm", "cpu_op", 10.0, 40.0),
              _x("aten::add", "cpu_op", 70.0, 10.0),
              _x("aten::copy_", "cpu_op", 150.0, 7.0)]
    agg = dp.aggregate_trace(events)
    assert agg["source"] == "host-cpu"
    assert agg["total_us"] == 57.0          # linear encloses mm: not a leaf
    assert set(agg["ops"]) == {"0/1:mul|aten::mm", "0/1:mul|aten::add",
                               "aten::copy_"}
    assert dp.aggregate_trace([]) == {"ops": {}, "total_us": 0.0,
                                      "source": "empty", "kernels": {},
                                      "links": {}}


def test_garbage_trace_warns_not_crashes(tmp_path, capsys):
    path = tmp_path / "garbage.trace.json"
    path.write_text("{not json")
    assert dp.load_trace_events(str(path)) is None
    assert "deviceprof:" in capsys.readouterr().err
    assert dp.find_trace_files(str(tmp_path)) == [str(path)]


def _tiny_lm():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        tok = pt.layers.data("tok", [16, 1], dtype="int64")
        nxt = pt.layers.data("nxt", [16, 1], dtype="int64")
        cost = pt.models.transformer.transformer_lm_cost(
            tok, nxt, 96, hid=32, num_layers=2, num_heads=2, max_len=16)
        pt.AdamOptimizer(1e-3).minimize(cost)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {k: rng.randint(0, 96, (2, 16, 1)).astype(np.int64)
            for k in ("tok", "nxt")}
    return main, cost, exe, scope, feed


def test_profile_program_end_to_end_on_the_cpu():
    main, cost, exe, scope, feed = _tiny_lm()
    rep = dp.profile_program(main, feed, [cost], scope, exe, steps=2,
                             warmup=1)
    assert rep["mode"] == "host-cpu" and rep["device"] == "cpu-smoke"
    assert rep["schema_version"] == dp.SCHEMA_VERSION == jdp.SCHEMA_VERSION
    scopes = {dp.op_scope(0, i, op.type)
              for i, op in enumerate(main.global_block().ops)}
    assert rep["rows"] and all(r["scope"] in scopes for r in rep["rows"])
    attributed = sum(r["device_time_us"] for r in rep["rows"])
    assert attributed <= rep["total_us"] * (1 + 1e-9)
    assert 0 < rep["coverage"] <= 1
    by = {r["scope"]: r for r in rep["rows"]}
    mul = next(s for s in by if s.endswith(":mul"))
    assert by[mul]["flops"] > 0
    assert rep["trace_dir"] is None


def test_executor_enters_op_scopes_only_while_profiling(monkeypatch):
    import torch
    main, cost, exe, scope, feed = _tiny_lm()
    entered = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    assert entered == [] and not dp.scopes_active()
    with dp.profiling():
        assert dp.scopes_active()
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    assert not dp.scopes_active()
    assert entered == [dp.op_scope(0, i, op.type)
                       for i, op in enumerate(main.global_block().ops)]


def test_sampler_disabled_constructs_nothing():
    assert dp.sampler_from_flags() is None and dp.stats() is None
    engine = InferenceEngine(lambda a: [a + 1.0], ["x"], ["y"],
                             config=EngineConfig(max_batch_size=4))
    try:
        engine.infer([np.ones((1, 4), np.float32)])
        assert engine._profiler is None
        assert "deviceprof" not in engine.stats()
    finally:
        engine.shutdown()
    assert "deviceprof" not in monitor.introspect.debug_vars(engine)


def test_serving_sampler_one_in_n_histograms_and_stats():
    monitor.set_enabled(True)
    flags.set_flag("profile_sample_n", 3)
    engine = InferenceEngine(lambda a: [a * 2.0], ["x"], ["y"],
                             config=EngineConfig(max_batch_size=8,
                                                 batch_timeout_ms=0.0,
                                                 queue_limit=16))
    try:
        assert engine._profiler is not None
        for _ in range(9):
            engine.infer([np.ones((1, 8), np.float32)])
        stats = engine.stats()
    finally:
        engine.shutdown(drain=True)
    d = stats["deviceprof"]
    assert (d["profile_sample_n"], d["batches_seen"], d["sampled"],
            d["capture_errors"]) == (3, 9, 3, 0)
    assert d["last"]["device_time_s"] > 0 and d["last"]["trace_ids"]
    assert d["last"]["mode"] == "host"
    snap = monitor.snapshot()
    assert snap["counters"]["deviceprof.sampled_batches"] == 3
    assert snap["histograms"]["serving.device_time|rung=1"]["count"] == 3
    assert monitor.introspect.debug_vars()["deviceprof"]["sampled"] == 3


def test_sampler_capture_attributes_an_executor_dispatch():
    """A full capture of a dispatch that runs the Executor on the CPU:
    its rows are the program's op scopes."""
    monitor.set_enabled(True)
    main, cost, exe, scope, feed = _tiny_lm()
    sampler = dp.SamplingProfiler(1, trace_min_interval_s=0.0,
                                  on_card=False)
    assert sampler.tick()
    out = sampler.sample(lambda f: exe.run(main, feed=f, fetch_list=[cost],
                                           scope=scope), feed, rung=2,
                         trace_ids=["t1"])
    assert np.isfinite(out[0]).all()
    sec = sampler.section()
    assert sec["captures"] == 1 and sec["capture_errors"] == 0
    assert sec["last"]["mode"] == "host-cpu"
    assert sec["top_ops"] and all(dp.SCOPE_RE.search(r["op"])
                                  for r in sec["top_ops"])


def test_sampler_flow_events_link_host_to_device_lane():
    tb = mon_trace.start()
    sampler = dp.SamplingProfiler(1, trace_min_interval_s=3600,
                                  on_card=False)
    sampler._last_capture_t = time.monotonic()
    assert sampler.tick()
    out = sampler.sample(lambda p: [p * 2.0], np.ones(3), rung=8,
                         trace_ids=["req-1", "req-2"])
    assert np.allclose(out[0], 2.0)
    evs = tb.to_dict()["traceEvents"]
    start = [e for e in evs if e["ph"] == "s"]
    finish = [e for e in evs if e["ph"] == "f"]
    assert len(start) == 1 and len(finish) == 1
    assert start[0]["id"] == finish[0]["id"] and finish[0]["bp"] == "e"
    assert finish[0]["tid"] == dp._DEVICE_LANE_TID
    lane = [e for e in evs if e["ph"] == "X"
            and e.get("tid") == dp._DEVICE_LANE_TID]
    assert len(lane) == 1
    assert lane[0]["args"]["trace_ids"] == ["req-1", "req-2"]
