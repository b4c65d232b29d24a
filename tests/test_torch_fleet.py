"""The port's serving fleet (paddle_tpu_torch/serving/fleet.py): the
twins of tests/test_fleet.py — membership leases, readiness, least-loaded
dispatch, the circuit-breaker state machine, deadline-aware failover
with trace preservation, typed shedding, the replica-side registrar and
the fleet aggregator — over a trivial y = 2x port engine on the CPU; and
the cross-package cases: a port replica behind the JAX package's router
and a JAX replica behind the port's, one scripted sequence giving equal
`fleet.*` counters and `status()` in both routers, and equal
dashboards from the same /debug/vars payloads.

No test holds a wall-clock budget: every wait polls with a deadline of
30 s or more."""

import json
import os
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu.serving as jserving
from paddle_tpu import monitor as jmonitor
from paddle_tpu_torch import monitor
from paddle_tpu_torch.serving import (EngineConfig, FleetRegistrar,
                                      FleetRouter, InferenceEngine,
                                      RouterConfig, make_server)
from paddle_tpu_torch.serving.fleet import DASHBOARD_SCHEMA_VERSION

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's intra-op work in one thread while this file runs: the
    tier-1 run puts several pytest workers on the same cores
    (tests/torch_port_helpers.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_telemetry():
    for mon in (monitor, jmonitor):
        mon.reset()
        mon.set_enabled(True)
    yield
    for mon in (monitor, jmonitor):
        mon.reset()
        mon.set_enabled(False)


def _counter(name):
    return int(monitor.snapshot()["counters"].get(name, 0))


def _wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _mk_replica(port=0, gate=None, ready=True, serving=None, **cfg):
    """A real HTTP replica over a trivial row-wise engine (y = 2x); the
    port's unless `serving` is the JAX package's serving module."""
    serving = serving or types.SimpleNamespace(
        InferenceEngine=InferenceEngine, EngineConfig=EngineConfig,
        make_server=make_server)
    specs = [{"name": "x", "dtype": "float32", "shape": [-1, 4]}]
    if gate is not None:
        def infer_fn(a):
            assert gate.wait(30), "test gate never released"
            return [a * 2.0]
    else:
        def infer_fn(a):
            return [a * 2.0]
    engine = serving.InferenceEngine(
        infer_fn, ["x"], ["y"], input_specs=specs, ready=ready,
        config=serving.EngineConfig(**(cfg or dict(
            max_batch_size=4, batch_timeout_ms=0.0))))
    server = serving.make_server(engine, port=port)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    return engine, server, url


def _stop_replica(engine, server):
    server.shutdown()
    server.server_close()
    if not engine.stats()["closed"]:
        engine.shutdown(drain=False)


def _post(url, body, trace_id=None, timeout=15):
    headers = {"Content-Type": "application/json"}
    if trace_id:
        headers["x-trace-id"] = trace_id
    req = urllib.request.Request(url + "/v1/infer",
                                 data=json.dumps(body).encode(),
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


BODY = {"feeds": {"x": [[1.0, 2.0, 3.0, 4.0]]}}


# ---------------------------------------------------------------------------
# membership: register / heartbeat / lease expiry / drain
# ---------------------------------------------------------------------------

def test_register_probe_and_route():
    engine, server, url = _mk_replica()
    router = FleetRouter(RouterConfig(probe_interval_s=0.05))
    try:
        assert router.register("r0", url, ttl_s=30)["status"] == "ok"
        assert _wait_until(lambda: router.replica_ready("r0"))
        code, body, hdrs = _post(router.url, BODY, trace_id="t-abc")
        assert code == 200
        out = json.loads(body)
        np.testing.assert_allclose(out["outputs"][0], [[2, 4, 6, 8]])
        assert hdrs["x-trace-id"] == "t-abc"
        assert hdrs["x-served-by"] == "r0"
        assert hdrs["x-fleet-attempts"] == "1"
        st = router.status()
        assert st["routable"] == 1
        assert st["replicas"][0]["breaker"]["state"] == "closed"
        assert _counter("fleet.registrations") == 1
    finally:
        router.shutdown()
        _stop_replica(engine, server)


def test_register_rejects_garbage():
    router = FleetRouter(start=False)
    assert router.register("r0", "not-a-url")["status"] == "error"
    assert router.register("r0", "http://h")["status"] == "error"
    assert router.register("", "http://127.0.0.1:1")["status"] == "error"
    assert router.register("r0", "http://127.0.0.1:9",
                           ttl_s=-1)["status"] == "error"
    router.shutdown()


def test_lease_expiry_ejects_despite_healthy_probes():
    """Membership is the REPLICA's assertion (self-registration): a
    probe-reachable replica whose lease stops being renewed is still
    ejected — reachability never substitutes for the heartbeat."""
    engine, server, url = _mk_replica()
    router = FleetRouter(RouterConfig(probe_interval_s=0.05))
    try:
        router.register("r0", url, ttl_s=0.3)
        assert _wait_until(lambda: router.replica_ready("r0"))
        assert _wait_until(lambda: not router.status()["replicas"])
        assert _counter("fleet.ejections") == 1
        code, body, _ = _post(router.url, BODY)
        assert code == 503
        assert json.loads(body)["error_type"] == "unavailable"
    finally:
        router.shutdown()
        _stop_replica(engine, server)


def test_heartbeat_renews_and_unknown_triggers_reregister():
    router = FleetRouter(RouterConfig(probe_interval_s=0.05))
    try:
        assert router.heartbeat("ghost")["status"] == "unknown"
        router.register("r0", "http://127.0.0.1:9", ttl_s=3.0)
        for _ in range(4):
            time.sleep(1.0)      # each beat lands well inside the lease
            assert router.heartbeat("r0")["status"] == "ok"
        assert [r["replica_id"] for r in router.status()["replicas"]] \
            == ["r0"]
        assert _counter("fleet.ejections") == 0
    finally:
        router.shutdown()


def test_draining_replica_not_picked():
    e1, s1, u1 = _mk_replica()
    e2, s2, u2 = _mk_replica()
    router = FleetRouter(RouterConfig(probe_interval_s=0.05))
    try:
        router.register("a", u1, ttl_s=30)
        router.register("b", u2, ttl_s=30)
        assert _wait_until(lambda: router.replica_ready("a")
                           and router.replica_ready("b"))
        router.begin_drain("a")
        served = {(_post(router.url, BODY))[2]["x-served-by"]
                  for _ in range(6)}
        assert served == {"b"}
        # a re-register (the swapped-in replacement) clears the drain
        router.register("a", u1, ttl_s=30, ready=True)
        assert router.replica_ready("a")
    finally:
        router.shutdown()
        _stop_replica(e1, s1)
        _stop_replica(e2, s2)


def test_readiness_gates_routing():
    """A booting replica (registered, live, but warmup pending) is NOT
    routable until its /healthz turns ready."""
    engine, server, url = _mk_replica(ready=False)
    router = FleetRouter(RouterConfig(probe_interval_s=0.05))
    try:
        router.register("r0", url, ttl_s=30)
        time.sleep(0.2)
        assert not router.replica_ready("r0")
        code, body, _ = _post(router.url, BODY)
        assert code == 503
        assert json.loads(body)["error_type"] == "unavailable"
        engine.set_ready(True)
        assert _wait_until(lambda: router.replica_ready("r0"))
        code, _, _ = _post(router.url, BODY)
        assert code == 200
    finally:
        router.shutdown()
        _stop_replica(engine, server)


# ---------------------------------------------------------------------------
# dispatch / failover / breaker
# ---------------------------------------------------------------------------

def test_least_loaded_dispatch():
    e1, s1, u1 = _mk_replica()
    e2, s2, u2 = _mk_replica()
    # probes effectively off: the registered queue depths stand
    router = FleetRouter(RouterConfig(probe_interval_s=60))
    try:
        router.register("busy", u1, ready=True, queue_depth=7)
        router.register("idle", u2, ready=True, queue_depth=0)
        served = {(_post(router.url, BODY))[2]["x-served-by"]
                  for _ in range(5)}
        assert served == {"idle"}
    finally:
        router.shutdown()
        _stop_replica(e1, s1)
        _stop_replica(e2, s2)


def test_failover_preserves_trace_and_counts():
    """A dead replica's hop fails over transparently to a peer; the
    client sees ONE 200 carrying its own trace id and the hop count."""
    e1, s1, u1 = _mk_replica()
    e2, s2, u2 = _mk_replica()
    router = FleetRouter(RouterConfig(probe_interval_s=60,
                                      breaker_threshold=5))
    try:
        # dead replica advertises the lower load -> picked first
        router.register("dead", u1, ready=True, queue_depth=0)
        router.register("live", u2, ready=True, queue_depth=3)
        _stop_replica(e1, s1)
        code, body, hdrs = _post(router.url,
                                 {**BODY, "deadline_ms": 5000},
                                 trace_id="trace-fo-1")
        assert code == 200
        np.testing.assert_allclose(json.loads(body)["outputs"][0],
                                   [[2, 4, 6, 8]])
        assert hdrs["x-served-by"] == "live"
        assert hdrs["x-fleet-attempts"] == "2"
        assert hdrs["x-trace-id"] == "trace-fo-1"
        assert _counter("fleet.failovers") == 1
        assert _counter("fleet.retries") == 1
    finally:
        router.shutdown()
        _stop_replica(e2, s2)


def test_breaker_opens_then_half_open_trial_recovers():
    engine, server, url = _mk_replica()
    port = server.server_address[1]
    router = FleetRouter(RouterConfig(probe_interval_s=60,
                                      retry_budget=0,
                                      breaker_threshold=2,
                                      breaker_cooldown_s=0.5))
    try:
        router.register("r0", url, ready=True)
        _stop_replica(engine, server)       # the port goes dead
        for _ in range(2):                  # 2 failures: breaker opens
            code, body, _ = _post(router.url, BODY)
            assert code == 503
            assert json.loads(body)["error_type"] == "unavailable"
        assert _counter("fleet.breaker_opens") == 1
        st = router.status()["replicas"][0]
        assert st["breaker"]["state"] == "open"
        # open = not even attempted: the reply says 0 attempts
        code, body, hdrs = _post(router.url, BODY)
        assert code == 503 and hdrs["x-fleet-attempts"] == "0"
        assert _counter("fleet.breaker_opens") == 1   # no double count
        # resurrect the replica on the SAME port; after the cooldown the
        # next request is the half-open trial and closes the breaker
        engine2, server2, _ = _mk_replica(port=port)
        time.sleep(0.6)
        code, _, hdrs = _post(router.url, BODY)
        assert code == 200 and hdrs["x-served-by"] == "r0"
        assert _counter("fleet.breaker_closes") == 1
        assert router.status()["replicas"][0]["breaker"]["state"] \
            == "closed"
        _stop_replica(engine2, server2)
    finally:
        router.shutdown()


def test_all_replicas_saturated_sheds_429_with_retry_after():
    gate = threading.Event()
    cfg = dict(max_batch_size=1, batch_timeout_ms=0.0, queue_limit=1)
    e1, s1, u1 = _mk_replica(gate=gate, **cfg)
    e2, s2, u2 = _mk_replica(gate=gate, **cfg)
    router = FleetRouter(RouterConfig(probe_interval_s=60))
    try:
        router.register("a", u1, ready=True)
        router.register("b", u2, ready=True)
        pendings = []
        for eng in (e1, e2):
            pendings.append(eng.submit({"x": np.ones((1, 4), np.float32)}))
            assert _wait_until(lambda: eng.stats()["batches"] >= 1)
            pendings.append(eng.submit({"x": np.ones((1, 4), np.float32)}))
        code, body, hdrs = _post(router.url, BODY)
        assert code == 429
        out = json.loads(body)
        assert out["error_type"] == "shed"
        assert hdrs.get("Retry-After")
        assert _counter("fleet.shed") == 1
        gate.set()
        for p in pendings:
            p.result(timeout=30)
    finally:
        gate.set()
        router.shutdown()
        _stop_replica(e1, s1)
        _stop_replica(e2, s2)


def test_expired_deadline_is_typed_504():
    engine, server, url = _mk_replica()
    router = FleetRouter(RouterConfig(probe_interval_s=60))
    try:
        router.register("r0", url, ready=True)
        code, body, _ = _post(router.url, {**BODY, "deadline_ms": 0})
        assert code == 504
        assert json.loads(body)["error_type"] == "deadline"
        assert _counter("fleet.deadline_exceeded") == 1
    finally:
        router.shutdown()
        _stop_replica(engine, server)


def test_client_errors_relay_without_retry():
    """A 400 is the CLIENT's fault: relayed from the first replica that
    answered it, never failed over."""
    engine, server, url = _mk_replica()
    router = FleetRouter(RouterConfig(probe_interval_s=60))
    try:
        router.register("r0", url, ready=True)
        code, body, hdrs = _post(router.url,
                                 {"feeds": {"wrong": [[1.0]]}})
        assert code == 400 and b"feeds must be exactly" in body
        assert hdrs["x-fleet-attempts"] == "1"
        assert _counter("fleet.retries") == 0
    finally:
        router.shutdown()
        _stop_replica(engine, server)


def test_deadline_budget_forwarded_shrinks_per_hop():
    """The hop body carries only the REMAINING deadline: a failed-over
    request must not restart its clock on the peer."""
    seen = {}

    class _Probe(FleetRouter):
        def _forward(self, rep, body, trace_id, timeout):
            seen.setdefault(rep.replica_id,
                            json.loads(body).get("deadline_ms"))
            return super()._forward(rep, body, trace_id, timeout)

    e1, s1, u1 = _mk_replica()
    router = _Probe(RouterConfig(probe_interval_s=60))
    try:
        router.register("r0", u1, ready=True)
        code, _, _ = _post(router.url, {**BODY, "deadline_ms": 5000})
        assert code == 200
        assert 0 < seen["r0"] <= 5000
    finally:
        router.shutdown()
        _stop_replica(e1, s1)


# ---------------------------------------------------------------------------
# HTTP control plane + registrar
# ---------------------------------------------------------------------------

def _control(url, path, payload):
    req = urllib.request.Request(url + path,
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


def test_http_control_plane_register_status_deregister():
    engine, server, url = _mk_replica()
    router = FleetRouter(RouterConfig(probe_interval_s=0.05))
    try:
        code, out = _control(router.url, "/fleet/register",
                             {"replica_id": "r9", "url": url,
                              "ttl_s": 30, "ready": True})
        assert code == 200 and out["status"] == "ok" and out["fresh"]
        code, out = _control(router.url, "/fleet/heartbeat",
                             {"replica_id": "r9", "queue_depth": 2})
        assert code == 200 and out["status"] == "ok"
        code, out = _control(router.url, "/fleet/heartbeat",
                             {"replica_id": "nobody"})
        assert out["status"] == "unknown"
        with urllib.request.urlopen(router.url + "/fleet/status",
                                    timeout=10) as resp:
            st = json.loads(resp.read())
        assert [r["replica_id"] for r in st["replicas"]] == ["r9"]
        with urllib.request.urlopen(router.url + "/healthz",
                                    timeout=10) as resp:
            hz = json.loads(resp.read())
        assert hz["replicas"] == 1
        code, out = _control(router.url, "/fleet/deregister",
                             {"replica_id": "r9"})
        assert out == {"status": "ok", "known": True}
        assert _counter("fleet.deregistrations") == 1
    finally:
        router.shutdown()
        _stop_replica(engine, server)


def test_registrar_registers_heartbeats_and_deregisters():
    engine, server, url = _mk_replica()
    router = FleetRouter(RouterConfig(probe_interval_s=0.05))
    try:
        reg = FleetRegistrar(router.url, "self-reg", url, engine,
                             ttl_s=2.0)
        reg.start()
        assert _wait_until(lambda: router.replica_ready("self-reg"))
        # heartbeats (every ttl/3) must outlive several lease windows
        time.sleep(5.0)
        assert router.replica_ready("self-reg")
        assert _counter("fleet.ejections") == 0
        assert _counter("fleet.registrations") == 1   # beats don't count
        reg.stop(deregister=True)
        assert _wait_until(lambda: not router.status()["replicas"])
        assert _counter("fleet.deregistrations") == 1
    finally:
        router.shutdown()
        _stop_replica(engine, server)


# ---------------------------------------------------------------------------
# fleet aggregation: /fleet/dashboard + merged time-series
# ---------------------------------------------------------------------------

def _metrics_payload(requests, queue, lat=None):
    hists = {}
    if lat is not None:
        hists["serving.request_latency_s"] = {
            "count": requests, "sum": requests * lat["p50"],
            "p50": lat["p50"], "p95": lat["p95"], "p99": lat["p99"]}
    return {"metrics": {
        "counters": {"serving.requests": requests},
        "gauges": {"serving.queue_depth": queue},
        "histograms": hists}}


def test_aggregator_merges_sum_rates_and_weighted_quantiles():
    """Hermetic merge math: counters sum as per-replica rates, queue
    depths sum, latency merges as a weighted quantile merge — the
    documented /fleet/dashboard semantics, no HTTP involved."""
    router = FleetRouter(start=False)
    try:
        agg = router.aggregator
        fast = {"p50": 0.01, "p95": 0.02, "p99": 0.03}
        slow = {"p50": 0.5, "p95": 0.9, "p99": 1.5}
        agg.ingest("a", "http://a", _metrics_payload(0, 2, fast), now=100.0)
        agg.ingest("b", "http://b", _metrics_payload(0, 3, slow), now=100.0)
        agg.ingest("a", "http://a", _metrics_payload(20, 2, fast), now=101.0)
        agg.ingest("b", "http://b", _metrics_payload(10, 3, slow), now=101.0)
        agg._merge_tick(101.0)
        probe = agg.probe()
        assert probe.rate("serving.requests", 10, now=101.0) == 30.0
        q = probe.gauge_window("serving.queue_depth", 10, now=101.0)
        assert q["last"] == 5.0                      # sum across replicas
        lat = probe.hist_window("serving.request_latency_s", 10,
                                now=101.0)
        assert lat["count"] == 30
        # 20 fast + 10 slow observations: the merged p50 stays fast,
        # the merged p99 reaches into the slow replica's tail
        assert lat["p50"] <= 0.02
        assert lat["p99"] >= 0.9
        d = agg.dashboard(window_s=10, now=101.0)
        assert d["schema_version"] == 1
        assert d["window"]["queue_depth"]["last"] == 5.0
        assert d["window"]["requests_per_sec"] == 30.0
        assert set(d["series"]["queue_depth"]["per_replica"]) == \
            {"a", "b"}
        assert d["series"]["queue_depth"]["fleet"][-1][1] == 5.0
        assert [r["rule"] for r in d["slo"]] == \
            [r.name for r in agg.slo_engine.rules()]
    finally:
        router.shutdown()


def test_aggregator_tolerates_replica_restart_counter_reset():
    """A replica restart reboots its counters: the fleet request rate
    must never go negative or spike from the reset."""
    router = FleetRouter(start=False)
    try:
        agg = router.aggregator
        for t, v in [(0, 1000), (1, 1100), (2, 5), (3, 55)]:
            agg.ingest("a", "http://a", _metrics_payload(v, 0),
                       now=float(t))
        # +100, reset -> +5, +50 over 3s
        rate = agg.probe().rate("serving.requests", None, now=3.0)
        assert rate == pytest.approx(155.0 / 3.0)
    finally:
        router.shutdown()


def test_aggregator_scrapes_real_replica_and_serves_dashboard():
    """The wired path: a registered replica's /debug/vars is scraped on
    the probe-loop cadence and GET /fleet/dashboard answers with the
    documented schema over real HTTP."""
    engine, server, url = _mk_replica()
    router = FleetRouter(RouterConfig(probe_interval_s=0.05,
                                      scrape_interval_s=0.05,
                                      dashboard_window_s=10.0))
    try:
        router.register("r1", url, ttl_s=60)
        _post(router.url, BODY)
        assert _wait_until(lambda: router.aggregator.scrapes >= 3), \
            "aggregator never scraped"
        assert _wait_until(
            lambda: len(router.aggregator.dashboard()
                        ["series"]["queue_depth"]["fleet"]) >= 2)
        req = urllib.request.Request(
            router.url + "/fleet/dashboard?window=5")
        with urllib.request.urlopen(req, timeout=10) as resp:
            d = json.loads(resp.read())
        assert resp.status == 200
        assert d["schema_version"] == 1 and d["window_s"] == 5.0
        row = next(r for r in d["replicas"]
                   if r["replica_id"] == "r1")
        assert row["scrape_ok"] is True
        assert row["scrape_age_s"] is not None
        assert any(r["rule"] == "fleet-shed-rate" for r in d["slo"])
        # the merged gauges export for Prometheus too
        gauges = monitor.snapshot()["gauges"]
        assert "fleet.series.queue_depth" in gauges
        assert "fleet.series.replicas_scraped" in gauges
        # bad window is a clean 400
        try:
            urllib.request.urlopen(urllib.request.Request(
                router.url + "/fleet/dashboard?window=0"), timeout=10)
            status = 200
        except urllib.error.HTTPError as e:
            status = e.code
        assert status == 400
    finally:
        router.shutdown()
        _stop_replica(engine, server)


def test_aggregator_prunes_departed_replicas():
    engine, server, url = _mk_replica()
    router = FleetRouter(RouterConfig(probe_interval_s=0.05,
                                      scrape_interval_s=0.05))
    try:
        router.register("r1", url, ttl_s=60)
        assert _wait_until(
            lambda: "r1" in router.aggregator._replica_stores())
        router.deregister("r1")
        assert _wait_until(
            lambda: "r1" not in router.aggregator._replica_stores())
        row = next(r for r in router.aggregator.dashboard()["replicas"]
                   if r["replica_id"] == "r1") if any(
            r["replica_id"] == "r1"
            for r in router.aggregator.dashboard()["replicas"]) else None
        assert row is None          # gone from membership AND stores
    finally:
        router.shutdown()
        _stop_replica(engine, server)


def test_aggregator_prefers_replica_windowed_latency_quantiles():
    """A scraped snapshot's histogram summary is process-LIFETIME and
    moves too slowly to alert on; when the replica's /debug/vars
    carries its own sampler's windowed view (serve --fleet defaults
    the sampler on), the aggregator must use THOSE quantile knots —
    an hour of fast history cannot mask a fresh latency regression."""
    router = FleetRouter(start=False)
    try:
        agg = router.aggregator

        def payload(count, windowed_p99):
            lifetime = {"count": count, "sum": count * 0.1,
                        "p50": 0.1, "p95": 0.1, "p99": 0.1}
            out = {"metrics": {
                "counters": {}, "gauges": {},
                "histograms": {"serving.request_latency_s": lifetime}}}
            if windowed_p99 is not None:
                out["timeseries"] = {"window": {"histograms": {
                    "serving.request_latency_s": {
                        "count": 30, "mean": windowed_p99,
                        "p50": windowed_p99, "p95": windowed_p99,
                        "p99": windowed_p99}}}}
            return out

        agg.ingest("a", "http://a", payload(100000, 2.0), now=0.0)
        agg.ingest("a", "http://a", payload(100030, 3.0), now=1.0)
        lat = agg.probe().hist_window("serving.request_latency_s", 10,
                                      now=1.0)
        # the tick-2 knots are the replica's WINDOWED p99 (3.0), not
        # the lifetime 0.1 that 100k old samples would pin
        assert lat["p99"] == 3.0, lat
        assert lat["count"] == 30
        # without the windowed section the lifetime fallback remains
        agg.ingest("b", "http://b", payload(0, None), now=0.0)
        agg.ingest("b", "http://b", payload(30, None), now=1.0)
        stores = agg._replica_stores()
        hb = stores["b"].hist_window("serving.request_latency_s", 10,
                                     now=1.0)
        assert hb["p99"] == 0.1
    finally:
        router.shutdown()


# ---------------------------------------------------------------------------
# across packages: one wire protocol
# ---------------------------------------------------------------------------

def _jax_replica(**kw):
    return _mk_replica(serving=types.SimpleNamespace(
        InferenceEngine=jserving.InferenceEngine,
        EngineConfig=jserving.EngineConfig,
        make_server=jserving.make_server), **kw)


@pytest.mark.parametrize("router_pkg", ["jax", "port"])
def test_replica_of_one_package_routed_by_the_other(router_pkg):
    """A port replica with the port's registrar is admitted and routed
    by the JAX package's FleetRouter, and a JAX replica with the JAX
    registrar by the port's: registration, heartbeats, /healthz
    readiness probes and the forwarded /v1/infer all cross."""
    if router_pkg == "jax":
        router = jserving.FleetRouter(
            jserving.RouterConfig(probe_interval_s=0.05))
        engine, server, url = _mk_replica()
        registrar_cls = FleetRegistrar
        router_mon = jmonitor
    else:
        router = FleetRouter(RouterConfig(probe_interval_s=0.05))
        engine, server, url = _jax_replica()
        registrar_cls = jserving.FleetRegistrar
        router_mon = monitor
    reg = registrar_cls(router.url, "cross-0", url, engine, ttl_s=5.0)
    try:
        reg.start()
        assert _wait_until(lambda: router.replica_ready("cross-0"))
        code, body, hdrs = _post(router.url, BODY, trace_id="t-cross")
        assert code == 200, body
        np.testing.assert_allclose(json.loads(body)["outputs"][0],
                                   [[2, 4, 6, 8]])
        assert hdrs["x-served-by"] == "cross-0"
        assert hdrs["x-trace-id"] == "t-cross"
        assert hdrs["x-fleet-attempts"] == "1"
        counters = router_mon.snapshot()["counters"]
        assert counters.get("fleet.registrations") == 1
        reg.stop(deregister=True)
        assert _wait_until(lambda: not router.status()["replicas"])
        assert router_mon.snapshot()["counters"].get(
            "fleet.deregistrations") == 1
    finally:
        reg.stop(deregister=False)
        router.shutdown()
        _stop_replica(engine, server)


def _timeless_status(st):
    """status() without the router's url and the lease clocks."""
    out = {k: v for k, v in st.items() if k != "url"}
    out["replicas"] = [{k: v for k, v in r.items()
                        if k not in ("url", "lease_remaining_s")}
                       for r in st["replicas"]]
    return out


def _scripted(router, live_url, dead_url):
    """Register / heartbeat / route into a dead member and fail over /
    breaker / deadline / drain / deregister, driving `router` directly
    (no prober, no HTTP front). Returns each step's answer."""
    body = json.dumps(BODY).encode()
    out = [router.register("a", live_url, ttl_s=30, ready=True,
                           queue_depth=2),
           router.register("b", dead_url, ttl_s=30, ready=True,
                           queue_depth=0),
           router.register("a", live_url, ttl_s=30),       # lease renewal
           router.heartbeat("a", ready=True, queue_depth=3),
           router.heartbeat("ghost"),
           router.register("bad", "not-a-url")]
    for _ in range(3):     # "b" looks idle: picked, dies, fails over
        r = router.route(body, inbound_trace_id="t-script")
        out.append((r.status, r.headers, json.loads(r.body).get(
            "error_type")))
    r = router.route(json.dumps({**BODY, "deadline_ms": 0}).encode())
    out.append((r.status, json.loads(r.body)["error_type"]))
    out.append(router.begin_drain("a"))
    r = router.route(body)
    out.append((r.status, r.headers, json.loads(r.body)["error_type"]))
    out.append(router.deregister("b"))
    out.append(router.deregister("b"))
    out.append(router.register("a", live_url, ttl_s=30, ready=True))
    r = router.route(body)
    out.append((r.status, r.headers))
    out.append(_timeless_status(router.status()))
    return out


def test_scripted_sequence_gives_equal_counters_and_status():
    engine, server, live_url = _mk_replica()
    e_dead, s_dead, dead_url = _mk_replica()
    _stop_replica(e_dead, s_dead)            # a port with nothing behind
    cfg = dict(probe_interval_s=60, breaker_threshold=2,
               breaker_cooldown_s=60, retry_budget=2)
    port_router = FleetRouter(RouterConfig(**cfg), start=False)
    jax_router = jserving.FleetRouter(jserving.RouterConfig(**cfg),
                                      start=False)
    try:
        port_steps = _scripted(port_router, live_url, dead_url)
        jax_steps = _scripted(jax_router, live_url, dead_url)
        assert port_steps == jax_steps
        # the script reached every branch it names
        codes = [s[0] for s in port_steps if isinstance(s, tuple)]
        assert codes == [200, 200, 200, 504, 503, 200]

        def fleet(mon):
            return {k: v for k, v in mon.snapshot()["counters"].items()
                    if k.startswith("fleet.")}
        assert fleet(monitor) == fleet(jmonitor)
        got = fleet(monitor)
        assert got["fleet.failovers"] == 2 and got["fleet.retries"] == 2
        assert got["fleet.breaker_opens"] == 1
        assert got["fleet.deadline_exceeded"] == 1
        assert got["fleet.unavailable"] == 1
        assert got["fleet.registrations"] == 2
        assert got["fleet.deregistrations"] == 1
    finally:
        port_router.shutdown()
        jax_router.shutdown()
        _stop_replica(engine, server)


def _agg_payload(requests, queue, p99, shed):
    return {"metrics": {
        "counters": {"serving.requests": requests,
                     "serving.deadline_shed": shed},
        "gauges": {"serving.queue_depth": queue},
        "histograms": {"serving.request_latency_s": {
            "count": requests, "sum": requests * p99 / 3,
            "p50": p99 / 3, "p95": p99 / 2, "p99": p99}}}}


def test_aggregator_dashboards_equal_across_packages():
    """FleetAggregator.ingest of the same /debug/vars payloads (with a
    counter reset and a failed scrape) gives equal dashboard() dicts in
    both packages."""
    routers = [FleetRouter(start=False),
               jserving.FleetRouter(start=False)]
    dashboards = []
    try:
        for router in routers:
            agg = router.aggregator
            for t in range(6):
                now = 1000.0 + t
                agg.ingest("a", "http://a:1",
                           _agg_payload(40 * t, t % 3, 0.05 + 0.01 * t,
                                        t // 2), now=now)
                b = (_agg_payload(25 * t if t < 4 else 5 * (t - 3), 2,
                                  0.4, 0) if t != 2
                     else OSError("connection refused"))
                agg.ingest("b", "http://b:2", b, now=now)
                agg._merge_tick(now)
                agg.slo_engine.evaluate(agg.probe(), now=now)
            dashboards.append(agg.dashboard(window_s=10, now=1005.0))
        assert dashboards[0] == dashboards[1]
        d = dashboards[0]
        assert d["schema_version"] == DASHBOARD_SCHEMA_VERSION == \
            jserving.fleet.DASHBOARD_SCHEMA_VERSION
        assert d["window"]["requests_per_sec"] is not None
        assert len(d["series"]["queue_depth"]["fleet"]) == 6
    finally:
        for router in routers:
            router.shutdown()
