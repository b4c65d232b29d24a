"""The port's time series and SLO engine (monitor/timeseries.py,
monitor/slo.py) held exactly to the JAX package's.

Port twins of tests/test_timeseries.py and tests/test_slo.py: the same
snapshot sequence with explicit `now` gives equal `TimeSeriesStore`
windows, series and rates and equal `merge_quantiles`; the same rules
and probe values give the same alert sequence, table and metric side
effects; the JSON rule grammar and the default packs are the same; the
flag-driven sampler thread exists only while `metrics_sample_s` is
positive, and `/debug/vars` carries its `timeseries` section (windows
and the SLO table) only then — over HTTP from the LM server too.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from paddle_tpu.monitor import slo as jslo
from paddle_tpu.monitor import timeseries as jts
from paddle_tpu_torch import flags, monitor
from paddle_tpu_torch.monitor import slo, timeseries as ts


@pytest.fixture(autouse=True)
def clean():
    flags.reset()
    ts.reset()
    monitor.reset()
    monitor.blackbox.reset()
    monitor.set_enabled(True)
    yield
    flags.set_flag("metrics_sample_s", 0)
    flags.reset()
    ts.reset()
    monitor.reset()
    monitor.blackbox.reset()
    monitor.set_enabled(False)


def _snap(counters=None, gauges=None, hists=None):
    return {"counters": counters or {}, "gauges": gauges or {},
            "histograms": hists or {}}


def _summary(samples):
    s = sorted(samples)
    n = len(s)

    def q(p):
        return s[max(1, -(-p * n // 100)) - 1]
    return {"count": n, "sum": float(sum(s)), "mean": float(np.mean(s)),
            "min": s[0], "max": s[-1], "p50": q(50), "p95": q(95),
            "p99": q(99)}


def _sequence(seed):
    """Twelve ticks of a serving replica: a counter with a restart, a
    labeled counter family, gauges, and a latency histogram whose raw
    samples ride along on some ticks and not on others."""
    rng = np.random.RandomState(seed)
    ticks, total, seen = [], 0, []
    for i in range(12):
        total = total + int(rng.randint(0, 50)) if i != 7 else 3
        new = [float(x) for x in rng.exponential(0.05, rng.randint(1, 9))]
        seen += new
        snap = _snap(
            counters={"serving.requests": total,
                      "serving.errors|code=500": i,
                      "serving.errors|code=504": 2 * i},
            gauges={"serving.queue_depth": float(rng.randint(0, 20)),
                    "perf.mfu|device=cpu-smoke": 0.001 * i},
            hists={"serving.request_latency_s": _summary(seen)})
        ticks.append((snap, 100.0 + 0.5 * i,
                      {"serving.request_latency_s": new}
                      if i % 3 else None))
    return ticks


def _store(mod, ticks, capacity=512):
    store = mod.TimeSeriesStore(capacity=capacity)
    for snap, now, samples in ticks:
        store.append_snapshot(json.loads(json.dumps(snap)), now=now,
                              hist_samples=samples)
    return store


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window", [None, 1.0, 2.5, 30.0])
def test_store_windows_series_and_rates_equal_the_references(seed,
                                                             window):
    ticks = _sequence(seed)
    now = ticks[-1][1]
    mine, ref = _store(ts, ticks), _store(jts, ticks)
    assert mine.window(window, now=now) == ref.window(window, now=now)
    for name in ("serving.requests", "serving.queue_depth",
                 "serving.request_latency_s", "serving.errors|code=504",
                 "missing"):
        assert mine.series(name, window, now=now) == \
            ref.series(name, window, now=now)
    assert mine.rate("serving.errors", window, now=now,
                     skip_labels={"code": "500"}) == \
        ref.rate("serving.errors", window, now=now,
                 skip_labels={"code": "500"})
    assert mine.gauge_window("perf.mfu", window, now=now,
                             skip_labels={"device": "cpu-smoke"}) is None
    assert mine.names() == ref.names()


def test_bounded_rings_equal_the_references():
    ticks = _sequence(3) * 3
    ticks = [(s, 100.0 + i, h) for i, (s, _, h) in enumerate(ticks)]
    mine, ref = _store(ts, ticks, 8), _store(jts, ticks, 8)
    assert mine.points("serving.requests") == \
        ref.points("serving.requests")
    assert len(mine.points("serving.requests")) == 8


@pytest.mark.parametrize("seed", range(4))
def test_merge_quantiles_and_window_math_equal_the_references(seed):
    rng = np.random.RandomState(seed)
    parts = []
    for s in (0.01, 0.1, 1.0)[:1 + seed % 3]:
        summ = _summary(list(rng.exponential(s, rng.randint(1, 40))))
        parts.append((summ["count"], summ))
    parts.append((0, {"count": 0}))
    assert ts.merge_quantiles(parts) == jts.merge_quantiles(parts)
    assert ts.merge_quantiles(parts, qs=(10, 90)) == \
        jts.merge_quantiles(parts, qs=(10, 90))
    pts = [(float(t), float(v)) for t, v in enumerate(
        np.cumsum(rng.randint(0, 9, 20)))]
    pts[11] = (11.0, 1.0)                # a counter reset
    for w in (None, 3.0, 7.5):
        assert ts.counter_rate(pts, w, now=19.0) == \
            jts.counter_rate(pts, w, now=19.0)
        assert ts.window_stats(pts, w, now=19.0) == \
            jts.window_stats(pts, w, now=19.0)


def test_window_summaries_from_debug_vars_equal_the_references():
    store = _store(ts, _sequence(4))
    payload = {"timeseries": {"window": store.window(5.0, now=105.5)}}
    assert ts.window_summaries_from_debug_vars(payload) == \
        jts.window_summaries_from_debug_vars(payload)
    assert ts.window_summaries_from_debug_vars({}) is None


class _Probe:
    """Scripted probe: a fixed value per call, any metric (the
    reference test's)."""

    def __init__(self, value=None, rates=None):
        self.value = value
        self.rates = rates or {}

    def rate(self, name, *a, **k):
        if name in self.rates:
            return self.rates[name]
        return self.value

    def gauge_window(self, *a, **k):
        v = self.value
        if v is None:
            return None
        return {"last": v, "min": v, "max": v, "mean": v, "n": 1}

    def hist_window(self, *a, **k):
        v = self.value
        if v is None:
            return None
        return {"count": 1, "mean": v, "p50": v, "p95": v, "p99": v}


# (rule kwargs, probe values at now = 0, 1, 2, ...)
SCENARIOS = {
    "for_s": (dict(window_s=10, for_s=3.0, clear_threshold=0.5),
              [2.0, 2.0, 2.0, 2.0, 0.4, 0.4, 2.0]),
    "transient": (dict(window_s=10, for_s=3.0),
                  [2.0, 0.1, 2.0, 2.0, 2.0, 2.0]),
    "hysteresis": (dict(window_s=10, clear_threshold=0.5),
                   [2.0, 0.8, 1.2, 0.4, 0.8, 2.0]),
    "clear_for_s": (dict(window_s=10, clear_threshold=0.5,
                         clear_for_s=3.0),
                    [2.0, 0.1, 2.0, 0.1, 0.1, 0.1, 0.1]),
    "no_data": (dict(window_s=10, clear_threshold=0.5),
                [None, 2.0, None, None, 0.1]),
    "lower_is_bad": (dict(window_s=10, for_s=1.0, clear_threshold=0.3,
                          op="<"),
                     [0.1, 0.1, 0.2, 0.5, 0.1, 0.1]),
}


def _run(mod, rule_kw, values):
    kw = dict(rule_kw)
    op = kw.pop("op", ">")
    threshold = 0.2 if op == "<" else 1.0
    eng = mod.SloEngine([mod.SloRule("r", "m", op, threshold, **kw)],
                        emit=False)
    p = _Probe()
    seq = []
    for t, v in enumerate(values):
        p.value = v
        seq.append(eng.evaluate(p, now=float(t)))
    return seq, eng.table()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_alert_sequences_equal_the_references(name):
    rule_kw, values = SCENARIOS[name]
    mine = _run(slo, rule_kw, values)
    assert mine == _run(jslo, rule_kw, values)
    assert any(mine[0])                  # every scenario fires once


def test_burn_rate_and_spike_values_equal_the_references():
    for mod in (slo, jslo):
        br = mod.BurnRateRule("avail", good="ok", total="all",
                              objective=0.99, threshold=10.0)
        got = [br.value(_Probe(rates={"ok": g, "all": a}))
               for g, a in ((9.0, 10.0), (None, None), (0.0, 0.0),
                            (11.0, 10.0))]
        assert got[0] == pytest.approx(10.0) and got[1:] == [None, None,
                                                            0.0]
    spike = [m.SloRule("r", "health.loss_ema", ">", 2.0, agg="spike")
             for m in (slo, jslo)]
    probe = _Probe(4.0)
    assert spike[0].value(probe) == spike[1].value(probe)


def test_firing_side_effects_and_one_bundle_per_episode(tmp_path):
    flags.set_flag("blackbox_dir", str(tmp_path))
    eng = slo.SloEngine([slo.SloRule("r", "m", ">", 1.0, window_s=10,
                                     clear_threshold=0.5)])
    p = _Probe(2.0)
    for now in (0.0, 1.0, 2.0):
        eng.evaluate(p, now=now)
    snap = monitor.snapshot()
    assert snap["gauges"]["slo.firing|rule=r"] == 1.0
    assert snap["counters"]["slo.fired"] == 1
    bundles = sorted(tmp_path.glob("blackbox-*.json"))
    assert len(bundles) == 1
    bundle = json.loads(bundles[0].read_text())
    assert bundle["reason"] == "slo:r"
    assert bundle["slo"]["alert"]["value"] == 2.0
    p.value = 0.1
    eng.evaluate(p, now=3.0)
    assert monitor.snapshot()["gauges"]["slo.firing|rule=r"] == 0.0
    assert monitor.snapshot()["counters"]["slo.cleared"] == 1
    p.value = 2.0
    eng.evaluate(p, now=4.0)
    assert len(sorted(tmp_path.glob("blackbox-*.json"))) == 2


def test_default_packs_and_json_grammar_equal_the_references(tmp_path):
    for fn in ("default_serving_rules", "default_lm_serving_rules",
               "default_training_rules", "default_rules",
               "default_fleet_rules"):
        assert [r.to_dict() for r in getattr(slo, fn)()] == \
            [r.to_dict() for r in getattr(jslo, fn)()], fn
    data = [{"name": "p99", "metric": "serving.request_latency_s",
             "op": ">", "threshold": 0.25, "agg": "p99", "for_s": 2},
            {"name": "burn", "good": "ok", "total": "all",
             "objective": 0.999, "threshold": 14.0},
            {"name": "fleet-only", "metric": "fleet.shed", "op": ">",
             "threshold": 1.0, "scope": "fleet"}]
    assert [r.to_dict() for r in slo.rules_from_json(data)] == \
        [r.to_dict() for r in jslo.rules_from_json(data)]
    path = tmp_path / "rules.json"
    path.write_text(json.dumps(data))
    flags.set_flag("slo_rules", str(path))
    local = [r.name for r in slo.rules_from_flag(scope="local")]
    assert local == ["p99", "burn"]
    assert [r.name for r in slo.rules_from_flag(scope="fleet")] == [
        "fleet-only"]
    with pytest.raises(ValueError):
        slo.rules_from_json([{"name": "x", "metric": "m", "op": "!=",
                              "threshold": 1}])


def _sampler_threads():
    return [t for t in threading.enumerate()
            if t.name == ts.SAMPLER_THREAD_NAME]


def test_sampler_thread_exists_only_while_the_flag_is_positive():
    assert flags.get("metrics_sample_s") == 0.0
    assert not _sampler_threads() and ts.stats() is None
    assert "timeseries" not in monitor.introspect.debug_vars()
    flags.set_flag("metrics_sample_s", 0.05)
    assert len(_sampler_threads()) == 1
    flags.set_flag("metrics_sample_s", 0.05)       # idempotent
    assert len(_sampler_threads()) == 1
    monitor.counter_inc("serving.requests", 3)
    sampler = ts.sampler()
    sampler.tick()
    monitor.counter_inc("serving.requests", 3)
    sampler.tick()
    section = monitor.introspect.debug_vars()["timeseries"]
    assert section["ticks"] >= 2
    assert section["window"]["counters"]["serving.requests"]["total"] == 6
    assert {r["rule"] for r in section["slo"]} == {
        r.name for r in slo.default_rules()}
    flags.set_flag("metrics_sample_s", 0)
    for t in threading.enumerate():
        if t.name == ts.SAMPLER_THREAD_NAME:
            t.join(2.0)
    assert not _sampler_threads()
    assert "timeseries" not in monitor.introspect.debug_vars()


def test_lm_server_debug_vars_carries_the_windows_and_slo_table(tmp_path):
    """The LM server over HTTP with the sampler on: /debug/vars has the
    metrics, perf, timeseries (with rates) and the SLO table; a user
    rule (slo_rules) on the token rate fires, and the Prometheus text
    exports its slo.firing|rule= gauge."""
    from paddle_tpu_torch.serving import (GenerationConfig,
                                          GenerationEngine, LMSpec,
                                          init_lm_weights)
    from paddle_tpu_torch.serving.http import make_server
    spec = LMSpec(64, 32, 2, 2, 64)
    engine = GenerationEngine(
        spec, init_lm_weights(spec, seed=0),
        config=GenerationConfig(max_slots=2, prefill_batch=2,
                                max_prompt_len=16, max_new_tokens=4),
        device="cpu")
    server = make_server(engine, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps([{
        "name": "tokens-flowing", "metric": "serving_lm.tokens",
        "op": ">", "threshold": 0.0, "agg": "rate", "window_s": 60}]))
    flags.set_flag("slo_rules", str(rules))
    flags.set_flag("metrics", True)
    flags.set_flag("metrics_sample_s", 3600)       # ticks driven here
    try:
        sampler = ts.sampler()
        for i in range(3):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/generate",
                data=json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 4,
                                 "stream": False}).encode())
            urllib.request.urlopen(req, timeout=60).read()
            if i != 1:
                sampler.tick()          # before and after the last two
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/vars", timeout=60) as r:
            dv = json.loads(r.read())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
            prom = r.read().decode()
    finally:
        server.shutdown()
        engine.shutdown(drain=True)
    for key in ("metrics", "perf", "timeseries", "engine", "flags",
                "device_memory", "flight_recorder"):
        assert key in dv, key
    rate = dv["timeseries"]["window"]["counters"]["serving_lm.tokens"]
    assert rate["total"] == 12 and rate["rate"] > 0
    assert dv["engine"]["kind"] == "lm"
    assert {r["rule"] for r in dv["timeseries"]["slo"]} >= {
        "serving-lm-ttft", "serving-lm-shed-rate"}
    firing = {r["rule"]: r["state"] for r in dv["timeseries"]["slo"]}
    assert firing["tokens-flowing"] == "firing"
    assert 'slo_firing{rule="tokens-flowing"} 1.0' in prom
    assert "deviceprof" not in dv
