"""Spans, the Chrome trace and the flight recorder in the port
(monitor/spans.py, monitor/trace.py, monitor/blackbox.py) against the
JAX package's, and the escalation paths that write bundles.

Port twins of tests/test_spans.py and the trace half of
tests/test_monitor.py: the same span calls give the same trace events
(timestamps, pids, thread ids and span/trace ids left out; parentage
compared by position), the event cap's marker, a stopped trace never
resurrected, the ring's wraparound and `spans_for_trace`; a bundle has
the reference's top-level keys; and the call sites write real bundles:
the executor's NaN guard, the Trainer's anomaly path under
`PADDLE_TPU_FAULTS=step:N:nan` (with the health section), preemption,
rollback, and a failed serving batch.
"""

import glob
import json
import os
import threading

import numpy as np
import pytest

from paddle_tpu import flags as jflags
from paddle_tpu import monitor as jmonitor
import paddle_tpu_torch as pt
from paddle_tpu_torch import flags, monitor, resilience
from paddle_tpu_torch.monitor import blackbox, spans, trace
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import EngineConfig, InferenceEngine


def _clean_both():
    for fl, mon in ((flags, monitor), (jflags, jmonitor)):
        fl.reset()
        mon.reset()
        mon.set_enabled(False)
        mon.trace.stop(save=False)
        mon.blackbox.reset()
    faults.reset()
    monitor.health.activate(None)
    pt.framework.reset_default_programs()


@pytest.fixture(autouse=True)
def clean():
    _clean_both()
    yield
    _clean_both()


def _span_story(mon):
    """One request's spans, nested, cross-thread, with an error, an
    instant and a flow pair, recorded into a path-less ambient trace."""
    mon.set_enabled(True)
    tr = mon.trace.start()
    root = mon.start_span("serving/request", trace_id="feedfacecafebeef",
                          attrs={"rows": 2})
    with mon.span("serving/admit", parent=root, attrs={"depth": 0}):
        with mon.span("serving/admit/validate"):
            pass
    ctx = root.context

    def worker():
        with mon.attach(ctx):
            with mon.span("serving/batch", attrs={"trace_ids": [
                    "feedfacecafebeef"]}):
                pass
    t = threading.Thread(target=worker, name="batcher")
    t.start()
    t.join()
    with pytest.raises(ValueError):
        with mon.span("serving/split"):
            raise ValueError("bad rows")
    mon.instant("marker", args={"k": 1})
    tr.add_flow("device/batch", 7, 1.0, "s")
    tr.add_flow("device/batch", 7, 2.0, "f")
    root.finish()
    events = tr.to_dict()["traceEvents"]
    mon.trace.stop(save=False)
    return events


def _normalize(events):
    """Events without timestamps, pids, thread ids and raw ids; span ids
    become their order of appearance so parentage stays comparable."""
    order = {}

    def ref(v):
        return order.setdefault(v, len(order))
    out = []
    for ev in events:
        e = {k: v for k, v in ev.items()
             if k not in ("ts", "dur", "pid", "tid")}
        args = dict(e.pop("args", {}) or {})
        for key in ("span_id", "parent_id", "trace_id"):
            if key in args:
                args[key] = (key, ref(args[key]))
        if e.get("name") == "thread_name":
            args = {}                   # thread names differ by pid
        e["args"] = args
        out.append(e)
    return out


def test_trace_events_equal_the_references():
    mine = _normalize(_span_story(monitor))
    ref = _normalize(_span_story(jmonitor))
    assert mine == ref
    names = [e["name"] for e in mine if e["ph"] == "X"]
    assert names == ["serving/admit/validate", "serving/admit",
                     "serving/batch", "serving/split", "serving/request"]
    err = next(e for e in mine if e["name"] == "serving/split")
    assert err["args"]["error"] == "ValueError: bad rows"


def test_trace_event_cap_marks_truncation_like_the_reference(monkeypatch):
    out = []
    for mod in (trace, jmonitor.trace):
        monkeypatch.setattr(mod, "_MAX_EVENTS", 5)
        tb = mod.TraceBuilder()
        for i in range(9):
            tb.add_complete(f"e{i}", float(i), 1.0)
        out.append(_normalize(tb.to_dict()["traceEvents"]))
    assert out[0] == out[1]
    assert out[0][-1]["name"] == "trace_truncated"
    assert len(out[0]) == 6


def test_trace_path_flag_writes_and_never_resurrects(tmp_path):
    path = str(tmp_path / "t" / "trace.json")
    flags.set_flag("trace_path", path)
    with monitor.span("region", attrs={"i": 1}):
        pass
    assert trace.current() is not None
    assert trace.stop() == path
    doc = json.load(open(path))
    assert any(e.get("name") == "region" for e in doc["traceEvents"])
    # a stopped ambient trace stays stopped: spans do not record
    assert trace.current() is None and not spans.on()
    os.remove(path)
    with monitor.span("after"):
        pass
    assert not os.path.exists(path)


def test_ring_wraparound_and_trace_membership():
    ring = blackbox.FlightRecorder(capacity=8)
    for i in range(20):
        ring.note({"kind": "event", "i": i})
    assert len(ring) == 8 and ring.dropped == 12
    assert [r["i"] for r in ring.records()] == list(range(12, 20))
    ring.note({"kind": "span", "name": "mine", "trace_id": "t1"})
    ring.note({"kind": "span", "name": "shared", "trace_id": "b",
               "attrs": {"trace_ids": ["t1", "t2"]}})
    ring.note({"kind": "event", "name": "noise", "trace_id": "t1"})
    assert [s["name"] for s in ring.spans_for_trace("t1")] == [
        "mine", "shared"]
    ring.clear()
    assert len(ring) == 0 and ring.dropped == 0


def test_note_event_gated_and_spans_land_in_the_ring():
    blackbox.note_event("ignored", detail=1)
    assert len(blackbox.recorder()) == 0
    monitor.set_enabled(True)
    blackbox.note_event("kept", detail=2)
    with monitor.span("finished", attrs={"a": 1}):
        pass
    recs = blackbox.recorder().records()
    assert recs[0]["name"] == "kept" and recs[0]["detail"] == 2
    assert recs[1]["kind"] == "span" and recs[1]["name"] == "finished"
    assert monitor.snapshot()["counters"]["monitor.spans"] == 1


def _bundle(mon, path):
    mon.set_enabled(True)
    mon.counter_inc("some.counter", 5)
    with mon.span("lead_up"):
        pass
    with mon.span("open_at_crash", attrs={"step": 7}):
        mon.blackbox.dump("unit_test", error=ValueError("boom"), path=path)
    return json.load(open(path))


def test_bundle_has_the_references_keys(tmp_path, monkeypatch):
    # no input pipeline has run in either package (a `feed` section
    # rides along once one has)
    from paddle_tpu.reader import pipeline as jpipeline
    from paddle_tpu_torch.reader import pipeline
    monkeypatch.setattr(pipeline, "_active", None)
    monkeypatch.setattr(jpipeline, "_active", None)
    mine = _bundle(monitor, str(tmp_path / "p" / "b.json"))
    ref = _bundle(jmonitor, str(tmp_path / "j" / "b.json"))
    assert set(mine) == set(ref)
    assert mine["reason"] == "unit_test"
    assert mine["error"] == "ValueError: boom"
    assert mine["open_span"]["name"] == "open_at_crash"
    assert any(r["name"] == "lead_up" for r in mine["records"])
    assert mine["metrics"]["counters"]["some.counter"] == 5
    assert isinstance(mine["device_memory"], list) and mine[
        "device_memory"]


def test_maybe_dump_dedupes_and_needs_the_flag(tmp_path):
    monitor.set_enabled(True)
    with pytest.raises(ValueError, match="blackbox_dir"):
        blackbox.dump("nowhere")
    assert blackbox.maybe_dump("nowhere") is None
    flags.set_flag("blackbox_dir", str(tmp_path))
    err = RuntimeError("the one failure")
    p1 = blackbox.maybe_dump("layer_a", error=err)
    assert p1 is not None
    assert blackbox.maybe_dump("layer_b", error=err) is None
    assert blackbox.maybe_dump("layer_a", error=RuntimeError("new"))
    assert len(glob.glob(str(tmp_path / "blackbox-*.json"))) == 2


def _bundles(d):
    return [json.load(open(p))
            for p in sorted(glob.glob(os.path.join(d, "blackbox-*.json")))]


def test_executor_nan_guard_writes_a_bundle(tmp_path):
    monitor.set_enabled(True)
    flags.set_flag("blackbox_dir", str(tmp_path))
    flags.set_flag("check_nan_inf", True)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4])
        cost = pt.layers.mean(pt.layers.fc(x, size=1))
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    bad = np.ones((2, 4), np.float32)
    bad[0, 0] = np.nan
    with pytest.raises(FloatingPointError):
        exe.run(main, feed={"x": bad}, fetch_list=[cost], scope=scope)
    (bundle,) = _bundles(str(tmp_path))
    assert bundle["reason"] == "nan_guard"
    assert cost.name in bundle["bad_vars"]


def _fit_trainer(**kw):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4])
        y = pt.layers.data("y", [1])
        cost = pt.layers.mean(pt.layers.square_error_cost(
            pt.layers.fc(x, size=1), y))
        pt.SGDOptimizer(0.05).minimize(cost)
    return pt.Trainer(cost, main_program=main, startup_program=startup,
                      place=pt.CPUPlace(), feed_workers=0, **kw)


def _fit_reader(n=6):
    rng = np.random.RandomState(0)
    data = [(rng.randn(4).astype(np.float32),
             rng.randn(1).astype(np.float32)) for _ in range(4 * n)]
    return pt.reader.batch(lambda: iter(data), 4)


def test_injected_nan_writes_one_bundle_with_health(tmp_path):
    monitor.set_enabled(True)
    flags.set_flag("blackbox_dir", str(tmp_path))
    flags.set_flag("faults", "step:3:nan")
    faults.reset()
    t = _fit_trainer(health_metrics=True,
                     anomaly_policy=resilience.AnomalyPolicy("skip_batch"))
    skipped = []
    t.train(_fit_reader(), 1, ["x", "y"],
            lambda ev: skipped.append(ev.batch_id)
            if isinstance(ev, pt.event.IterationSkipped) else None)
    assert skipped == [3]
    (bundle,) = _bundles(str(tmp_path))
    assert bundle["reason"] == "anomaly"
    assert "injected NaN" in bundle["error"]
    assert bundle["health"]["last"]["step"] == 2
    assert "grad_norm" in bundle["health_context"]
    assert any(r["kind"] == "span" and r["name"] == "trainer/step"
               for r in bundle["records"])
    assert any(r.get("name") == "anomaly_health_context"
               for r in bundle["records"])
    assert bundle["error_context"] is None    # dumped after the step


def test_preemption_and_rollback_write_bundles(tmp_path):
    monitor.set_enabled(True)
    bb = tmp_path / "bb"
    flags.set_flag("blackbox_dir", str(bb))
    t = _fit_trainer(checkpoint_dir=str(tmp_path / "ck"))
    with pytest.raises(resilience.PreemptionShutdown):
        t.train(_fit_reader(), 1, ["x", "y"],
                lambda ev: t.request_preemption()
                if isinstance(ev, pt.event.EndIteration)
                and ev.batch_id == 1 else None)
    flags.set_flag("faults", "step:8:nan")
    faults.reset()
    t2 = _fit_trainer(checkpoint_dir=str(tmp_path / "ck2"),
                      anomaly_policy=resilience.AnomalyPolicy("rollback"))
    t2.train(_fit_reader(), 2, ["x", "y"])
    # the rollback's dump is the anomaly's failure again: one bundle
    reasons = sorted(b["reason"] for b in _bundles(str(bb)))
    assert reasons == ["anomaly", "preemption"], reasons
    events = [r["name"] for r in blackbox.recorder().records()
              if r.get("kind") == "event"]
    assert "checkpoint_restored" in events


def test_serving_batch_failure_writes_a_bundle(tmp_path):
    monitor.set_enabled(True)
    flags.set_flag("blackbox_dir", str(tmp_path))

    def broken(arrays):
        raise RuntimeError("device fell over")

    engine = InferenceEngine(broken, ["x"], ["y"],
                             config=EngineConfig(max_batch_size=4,
                                                 batch_timeout_ms=1.0))
    try:
        p = engine.submit({"x": np.ones((1, 4), np.float32)})
        with pytest.raises(RuntimeError, match="fell over"):
            p.result(timeout=30)
    finally:
        engine.shutdown(drain=False)
    (bundle,) = _bundles(str(tmp_path))
    assert bundle["reason"] == "serving_batch_failure"
    assert p.trace_id in bundle["trace_ids"]
    assert bundle["engine"]["errors"] == 1
    assert [s["name"] for s in blackbox.recorder().spans_for_trace(
        p.trace_id)][-1] == "serving/request"


def test_lm_step_failure_writes_a_bundle(tmp_path):
    from paddle_tpu_torch.serving import (GenerationConfig,
                                          GenerationEngine, LMSpec,
                                          init_lm_weights)
    monitor.set_enabled(True)
    flags.set_flag("blackbox_dir", str(tmp_path))
    spec = LMSpec(64, 32, 2, 2, 64)
    engine = GenerationEngine(
        spec, init_lm_weights(spec, seed=0),
        config=GenerationConfig(max_slots=2, prefill_batch=2,
                                max_prompt_len=16, max_new_tokens=4),
        device="cpu")

    def broken(*a, **k):
        raise RuntimeError("decode fell over")
    engine._dispatch_decode = broken
    try:
        req = engine.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(RuntimeError, match="fell over"):
            req.result(timeout=60)
    finally:
        engine.shutdown(drain=False)
    (bundle,) = _bundles(str(tmp_path))
    assert bundle["reason"] == "serving_lm_step_failure"
    assert req.trace_id in bundle["trace_ids"]


def test_skip_budget_escalation_is_noted():
    monitor.set_enabled(True)
    pol = resilience.AnomalyPolicy("skip_batch", max_consecutive_skips=1)
    assert pol.next_action() == pol.SKIP_BATCH
    assert pol.next_action() == pol.ROLLBACK
    (ev,) = [r for r in blackbox.recorder().records()
             if r.get("name") == "anomaly_escalation"]
    assert ev["consecutive_skips"] == 2 and ev["escalated_to"] == "rollback"
