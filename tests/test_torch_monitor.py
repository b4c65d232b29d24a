"""The port's metrics registry, flags, introspection, profiler facade
and serve CLI telemetry (monitor/registry.py, flags.py,
monitor/introspect.py, profiler.py, cli.py) against the JAX package's.

Port twin of tests/test_monitor.py and the profiler half of
tests/test_evaluators_profiler.py: the same recorded families give
equal Prometheus text (summaries and native `_hist` buckets), tables,
JSON and JSON-lines dumps; the telemetry flags have the reference's
defaults, env names and side effects, and with every one off no
sampler thread or sampler object exists and no per-op scope is entered;
`/debug/vars` has the reference's sections on both engines; the compile
table is capped at 128 signatures; the profiler's report keeps its row
schema and `trace_dir` writes the host trace and a torch.profiler trace;
the serve CLI dumps the registry to `--metrics_path` at exit. Also: the
new modules import neither JAX nor the JAX package.
"""

import ast
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from paddle_tpu import flags as jflags
from paddle_tpu import monitor as jmonitor
from paddle_tpu import profiler as jprofiler
import paddle_tpu_torch as pt
from paddle_tpu_torch import cli, flags, monitor, profiler
from paddle_tpu_torch.monitor import (deviceprof, introspect, registry,
                                      timeseries, trace)
from paddle_tpu_torch.serving import EngineConfig, InferenceEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_MODULES = ["monitor/__init__.py", "monitor/registry.py",
               "monitor/spans.py", "monitor/trace.py", "monitor/blackbox.py",
               "monitor/timeseries.py", "monitor/slo.py",
               "monitor/introspect.py", "monitor/health.py",
               "monitor/deviceprof.py", "profiler.py"]
TELEMETRY_FLAGS = {"metrics": False, "metrics_path": "",
                   "metrics_sample_s": 0.0, "slo_rules": "",
                   "trace_path": "", "blackbox_dir": "",
                   "profile_sample_n": 0}


def _clean():
    for fl, mon in ((flags, monitor), (jflags, jmonitor)):
        fl.reset()
        mon.reset()
        mon.set_enabled(False)
        mon.trace.stop(save=False)
    timeseries.reset()
    introspect.reset()
    deviceprof.reset()
    profiler.reset_profiler()


@pytest.fixture(autouse=True)
def clean():
    _clean()
    yield
    _clean()


@pytest.mark.parametrize("path", NEW_MODULES)
def test_new_modules_import_no_jax(path):
    tree = ast.parse(open(os.path.join(REPO, "paddle_tpu_torch", path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        assert not [m for m in mods if m.split(".")[0] in (
            "jax", "jaxlib", "paddle_tpu")], (path, mods)


def _record(mon, seed):
    rng = np.random.RandomState(seed)
    mon.set_enabled(True)
    mon.counter_inc("serving_lm.tokens", 40)
    mon.counter_inc("serving_lm.requests", 3)
    mon.counter_inc("slo.fired")
    mon.counter_inc("trainer.steps", 7)
    mon.gauge_set("serving_lm.queue_depth", 2.0)
    mon.gauge_set('slo.firing|rule=serving-lm-ttft', 1.0)
    mon.gauge_set("device.mem_in_use_bytes|device=cuda:0", 1234)
    mon.gauge_set('health.update_ratio|param=fc "w"\\n', 0.5)
    for v in rng.exponential(0.2, 300):
        mon.histogram_observe("serving_lm.ttft_s", float(v))
    for v in rng.exponential(30.0, 40):
        mon.histogram_observe("trainer.step_time_s|phase=a", float(v))
    mon.histogram_observe("trainer.step_time_s|phase=b", 0.5)
    return mon.snapshot()


@pytest.mark.parametrize("seed", [0, 1])
def test_exports_equal_the_references(seed, tmp_path):
    mine, ref = _record(monitor, seed), _record(jmonitor, seed)
    assert mine == ref
    assert monitor.format_prometheus(mine) == jmonitor.format_prometheus(ref)
    assert "serving_lm_ttft_s_hist_bucket" in monitor.format_prometheus(mine)
    assert monitor.format_table() == jmonitor.format_table()
    assert monitor.format_snapshot(mine) == jmonitor.format_snapshot(ref)
    for dump in ("dump_json", "dump_jsonl"):
        p = getattr(monitor, dump)(str(tmp_path / "p" / f"m.{dump}"))
        j = getattr(jmonitor, dump)(str(tmp_path / "j" / f"m.{dump}"))
        assert open(p).read() == open(j).read()


def test_help_covers_the_ports_families():
    for name in ("health.grad_norm", "perf.mfu", "slo.firing",
                 "deviceprof.coverage", "serving.device_time",
                 "monitor.spans", "serving_lm.tokens",
                 "executor.compiled_signatures", "device.mem_in_use_bytes"):
        assert name in registry._HELP, name


def test_maybe_dump_writes_the_metrics_path(tmp_path):
    assert monitor.maybe_dump() is None
    monitor.set_enabled(True)
    monitor.counter_inc("c", 2)
    assert monitor.maybe_dump() is None          # no destination
    flags.set_flag("metrics_path", str(tmp_path / "d" / "m.jsonl"))
    path = monitor.maybe_dump()
    lines = [json.loads(x) for x in open(path)]
    assert lines == [{"type": "counter", "name": "c", "value": 2}]


@pytest.mark.parametrize("name", sorted(TELEMETRY_FLAGS))
def test_telemetry_flags_have_the_references_defaults(name, monkeypatch):
    assert flags.get(name) == jflags.get(name) == TELEMETRY_FLAGS[name]
    assert flags._DEFS[name][1] == jflags._DEFS[name][1]
    flags.reset()
    env = {"metrics": "1", "metrics_path": "/x.json",
           "metrics_sample_s": "0", "slo_rules": "/r.json",
           "trace_path": "", "blackbox_dir": "/bb",
           "profile_sample_n": "4"}[name]
    monkeypatch.setenv("PADDLE_TPU_" + name.upper(), env)
    assert flags.get(name) == flags._DEFS[name][0](env)


def test_every_flag_off_means_no_sampler_and_no_scope(monkeypatch):
    import torch
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda n, *a, **k: (entered.append(n),
                                            real(n, *a, **k))[1])
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4])
        out = pt.layers.fc(x, size=2)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    engine = InferenceEngine.from_program(
        main, ["x"], [out], executor=exe, scope=scope,
        config=EngineConfig(max_batch_size=2, buckets=(1, 2)))
    try:
        engine.warmup()
        engine.infer({"x": np.ones((1, 4), np.float32)})
        assert engine._profiler is None and deviceprof.stats() is None
    finally:
        engine.shutdown()
    assert entered == []
    assert not any(t.name == timeseries.SAMPLER_THREAD_NAME
                   for t in threading.enumerate())
    assert timeseries.sampler() is None and trace.current() is None
    assert monitor.snapshot() == {"counters": {}, "gauges": {},
                                  "histograms": {}}
    for k, v in TELEMETRY_FLAGS.items():
        assert flags.get(k) == v


def test_compile_table_is_capped_and_exported(monkeypatch):
    monitor.set_enabled(True)
    monkeypatch.setattr(introspect, "_MAX_SIGNATURES", 4)
    for i in range(6):
        introspect.note_compile(f"cuda_graph:{i}", 0.1 * i)
    introspect.note_compile("cuda_graph:5", 0.7)
    stats = introspect.compile_stats()
    assert list(stats) == [f"cuda_graph:{i}" for i in range(2, 6)]
    assert stats["cuda_graph:5"] == {"count": 2, "total_s": 0.5 + 0.7,
                                     "last_s": 0.7}
    g = monitor.snapshot()["gauges"]
    assert g["executor.compiled_signatures"] == 6
    assert "executor.compile_last_s|signature=cuda_graph:0" not in g


def test_device_memory_and_peak_on_the_cpu():
    assert introspect.peak_flops() == (197e12, "cpu-smoke")
    stats = introspect.device_memory_stats()
    assert stats and stats[0]["device"] == "cpu"
    assert introspect.hbm_bytes_limit() is None
    monitor.set_enabled(True)
    introspect.sample_device_gauges()
    assert monitor.snapshot()["gauges"]["device.mem_in_use_bytes_total"] == 0


def _http_json(url, headers=None, body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return dict(r.headers), json.loads(r.read())


def test_one_shot_server_debug_vars_and_trace(tmp_path):
    """The one-shot engine behind the HTTP server: /debug/vars has the
    reference's sections, and the request's spans land in the ambient
    trace under the x-trace-id the client sent."""
    from paddle_tpu_torch.serving.http import make_server
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4])
        out = pt.layers.fc(x, size=2)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    flags.set_flag("metrics", True)
    path = str(tmp_path / "trace.json")
    flags.set_flag("trace_path", path)
    engine = InferenceEngine.from_program(
        main, ["x"], [out], executor=exe, scope=scope,
        config=EngineConfig(max_batch_size=2, buckets=(1, 2)))
    server = make_server(engine, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        hdrs, reply = _http_json(
            f"http://127.0.0.1:{port}/v1/infer",
            headers={"x-trace-id": "cafe0123deadbeef",
                     "Content-Type": "application/json"},
            body={"feeds": {"x": [[1.0, 2.0, 3.0, 4.0]]}})
        assert hdrs["x-trace-id"] == "cafe0123deadbeef"
        _, dv = _http_json(f"http://127.0.0.1:{port}/debug/vars")
    finally:
        server.shutdown()
        engine.shutdown()
    want = set(jmonitor.introspect.debug_vars())
    assert want - {"feed", "quant"} <= set(dv) <= want | {"engine"}
    assert dv["engine"]["completed"] == 1
    assert dv["metrics"]["counters"]["serving.requests"] == 1
    assert dv["persistent_compile_cache"]["enabled"] is False
    trace.stop()
    events = json.load(open(path))["traceEvents"]
    req = [e for e in events if e.get("name") == "serving/request"]
    assert [e["args"]["trace_id"] for e in req] == ["cafe0123deadbeef"]


def _profiled(prof_mod, fl):
    prof_mod.start_profiler("All")
    for _ in range(3):
        with prof_mod.record_event("step"):
            pass
    with prof_mod.record_event("io"):
        pass
    return prof_mod.stop_profiler("calls")


def test_profiler_report_schema_equals_the_references(capsys):
    mine, ref = _profiled(profiler, flags), _profiled(jprofiler, jflags)
    assert [sorted(r) for r in mine] == [sorted(r) for r in ref]
    assert [(r["name"], r["calls"]) for r in mine] == [
        (r["name"], r["calls"]) for r in ref] == [("step", 3), ("io", 1)]
    out = capsys.readouterr().out
    assert "Profiling Report" in out and "step" in out
    assert not profiler.is_profiling()
    with profiler.record_event("off"):         # the profiler is off
        pass
    assert {r["name"] for r in profiler.report()} == {"step", "io"}


def test_profiler_trace_dir_writes_host_and_torch_traces(tmp_path):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4])
        cost = pt.layers.mean(pt.layers.fc(x, size=2))
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    runs = tmp_path / "plugins" / "profile"
    for i in range(profiler.TRACE_RETAIN + 1):
        (runs / f"old{i:02d}").mkdir(parents=True)
    with profiler.profiler(trace_dir=str(tmp_path)):
        with profiler.record_event("train_step"):
            exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                    fetch_list=[cost], scope=scope)
    host = json.load(open(tmp_path / "host_trace.json"))
    assert any(e.get("name") == "train_step" for e in host["traceEvents"])
    kept = sorted(os.listdir(runs))
    assert len(kept) == profiler.TRACE_RETAIN
    newest = [d for d in kept if not d.startswith("old")]
    assert len(newest) == 1
    (f,) = os.listdir(runs / newest[0])
    dev = json.load(open(runs / newest[0] / f))
    scopes = {e["name"] for e in dev["traceEvents"]
              if deviceprof._SCOPE_NAME.match(str(e.get("name", "")))}
    assert "0/0:mul" in scopes and not deviceprof.scopes_active()


def test_cost_analysis_takes_a_program_only():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4])
        pt.layers.fc(x, size=3)
    assert profiler.cost_analysis(main, {"x": np.ones((5, 4))}) == {
        "flops": 2.0 * 5 * 4 * 3}
    with pytest.raises(TypeError, match="JAX-only"):
        profiler.cost_analysis(lambda v: v)
    with profiler.cuda_profiler():
        pass


def test_serve_cli_dumps_metrics_at_exit_even_on_failure(tmp_path):
    path = str(tmp_path / "m" / "metrics.json")
    with pytest.raises(SystemExit, match="not found"):
        cli.main(["serve", "--model_dir", str(tmp_path / "nope"),
                  "--device", "cpu", "--metrics_path", path,
                  "--set", "metrics_sample_s=0,blackbox_dir=" +
                  str(tmp_path / "bb")])
    assert flags.get("blackbox_dir") == str(tmp_path / "bb")
    assert flags.get("metrics") is True
    assert json.load(open(path)) == monitor.snapshot()
    assert cli._parse_kv("a=1, b = x=y") == {"a": "1", "b": "x=y"}
    with pytest.raises(SystemExit, match="flag=value"):
        cli._parse_kv("novalue")
