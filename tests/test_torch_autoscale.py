"""The port's self-sizing fleet (paddle_tpu_torch/serving/autoscale.py):
the twins of tests/test_autoscale.py — AutoscalePolicy hysteresis (hold
clocks, per-direction cooldowns, no-data freeze, min/max bounds, giveup
backfill), the predictive load model, AutoscaleController actuation +
telemetry, drain-safe scale-down through real ReplicaSupervisor
subprocesses (`python -m paddle_tpu_torch serve --device cpu` over a
`save_inference_model` directory), slot-aware LM dispatch through the
router over the port's tiny GenerationEngine on the CPU, generation
cancel on client disconnect, loud supervisor giveup and the shaped-load
schedules against a port replica — and the decision sequence of both
packages' AutoscalePolicy over the same scripted dashboards, in both
modes, exactly equal.

No test holds a wall-clock budget: every wait polls with a deadline of
30 s or more."""

import json
import os
import socket
import struct
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu import serving as jserving
from paddle_tpu_torch import monitor
from paddle_tpu_torch.serving import (FleetRegistrar, FleetRouter,
                                      GenerationConfig, GenerationEngine,
                                      LMSpec, RouterConfig,
                                      init_lm_weights, make_server)
from paddle_tpu_torch.serving.autoscale import (AutoscaleConfig,
                                                AutoscaleController,
                                                AutoscalePolicy)

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
    monitor.reset()
    monitor.set_enabled(True)
    yield
    monitor.reset()
    monitor.set_enabled(False)


def _counter(name):
    return int(monitor.snapshot()["counters"].get(name, 0))


def _wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def dash(queue=None, rps=None, shed=0.0, lat=None, slo=False,
         deviceprof=None, scrapes=5):
    """A minimal fleet-dashboard payload with exactly the fields the
    policy reads (the REAL payload's shape, schema v1)."""
    return {
        "scrapes": scrapes,
        "window": {
            "queue_depth": {"last": queue},
            "requests_per_sec": rps,
            "shed_per_sec": shed,
            "latency_s": {"mean": lat},
        },
        "slo": [{"rule": "fleet-shed-rate",
                 "state": "firing" if slo else "ok"}],
        **({"deviceprof": deviceprof} if deviceprof else {}),
    }


def mk_policy(**over):
    cfg = dict(min_replicas=1, max_replicas=4, mode="reactive",
               interval_s=1.0, signal_window_s=5.0, queue_high=8.0,
               queue_low=2.0, up_for_s=3.0, idle_rps=1.0,
               idle_for_s=15.0, up_cooldown_s=10.0,
               down_cooldown_s=30.0, target_util=0.6)
    cfg.update(over)
    return AutoscalePolicy(AutoscaleConfig(**cfg))


def _replica_env():
    """The environment of a replica subprocess: one torch thread (six
    test workers share the cores)."""
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _save_mlp(dirname, features=8, hidden=16, classes=4):
    """A tiny softmax MLP saved by the port's save_inference_model."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [features], dtype="float32")
        h = pt.layers.fc(x, hidden, act="relu")
        y = pt.layers.fc(h, classes, act="softmax")
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    pt.io.save_inference_model(dirname, ["x"], [y], exe,
                               main_program=main, scope=scope)
    return dirname


PRESSURE = dict(queue=20.0, rps=50.0, lat=0.1)
IDLE = dict(queue=0.0, rps=0.2, lat=0.01)


# ---------------------------------------------------------------------------
# config resolution + validation
# ---------------------------------------------------------------------------

def test_config_validates():
    with pytest.raises(ValueError, match="min_replicas"):
        AutoscaleConfig(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError, match="mode"):
        AutoscaleConfig(mode="clairvoyant")
    with pytest.raises(ValueError, match="target_util"):
        AutoscaleConfig(target_util=1.5)


def test_config_from_flags_and_overrides():
    pt.flags.reset()
    try:
        pt.flags.set_flag("autoscale_queue_high", 5.0)
        cfg = AutoscaleConfig.from_flags(max_replicas=7, mode=None)
        assert cfg.queue_high == 5.0        # flag value
        assert cfg.max_replicas == 7        # explicit override wins
        assert cfg.mode == "reactive"       # None override = use flag
        assert set(cfg.summary()) >= {"min_replicas", "mode",
                                      "queue_high", "target_util"}
    finally:
        pt.flags.reset()


# ---------------------------------------------------------------------------
# reactive hysteresis: hold clocks, cooldowns, no-data, bounds
# ---------------------------------------------------------------------------

def test_pressure_must_hold_before_up():
    p = mk_policy(up_for_s=3.0)
    d0 = p.decide(dash(**PRESSURE), 1, now=100.0)
    assert (d0["action"], d0["reason"]) == ("hold", "up-hold")
    d1 = p.decide(dash(**PRESSURE), 1, now=102.0)
    assert d1["action"] == "hold"           # 2s < up_for_s
    d2 = p.decide(dash(**PRESSURE), 1, now=103.5)
    assert (d2["action"], d2["reason"]) == ("up", "queue-depth")
    assert d2["target"] == 2


def test_pressure_clock_resets_when_pressure_breaks():
    p = mk_policy(up_for_s=3.0)
    p.decide(dash(**PRESSURE), 1, now=100.0)
    steady = p.decide(dash(queue=4.0, rps=50.0), 1, now=102.0)
    assert (steady["action"], steady["reason"]) == ("hold", "steady")
    # pressure returns: the clock must restart from zero
    d = p.decide(dash(**PRESSURE), 1, now=102.5)
    assert (d["action"], d["reason"]) == ("hold", "up-hold")
    d = p.decide(dash(**PRESSURE), 1, now=105.0)
    assert d["action"] == "hold"            # only 2.5s of NEW pressure
    d = p.decide(dash(**PRESSURE), 1, now=105.6)
    assert d["action"] == "up"


def test_slo_firing_is_pressure_even_with_low_queue():
    p = mk_policy(up_for_s=1.0)
    d = p.decide(dash(queue=0.0, rps=50.0, slo=True), 1, now=10.0)
    assert (d["action"], d["reason"]) == ("hold", "up-hold")
    d = p.decide(dash(queue=0.0, rps=50.0, slo=True), 1, now=11.5)
    assert (d["action"], d["reason"]) == ("up", "slo:fleet-shed-rate")


def test_up_cooldown_rate_limits_consecutive_ups():
    p = mk_policy(up_for_s=1.0, up_cooldown_s=10.0)
    p.decide(dash(**PRESSURE), 1, now=100.0)
    assert p.decide(dash(**PRESSURE), 1, now=101.5)["action"] == "up"
    # sustained pressure, hold matured again — but inside the cooldown
    p.decide(dash(**PRESSURE), 2, now=102.0)
    d = p.decide(dash(**PRESSURE), 2, now=104.0)
    assert (d["action"], d["reason"]) == ("hold", "up-cooldown")
    d = p.decide(dash(**PRESSURE), 2, now=112.0)
    assert d["action"] == "up"              # cooldown elapsed


def test_at_max_holds_and_resets_the_up_clock():
    p = mk_policy(max_replicas=2, up_for_s=1.0)
    d = p.decide(dash(**PRESSURE), 2, now=100.0)
    assert (d["action"], d["reason"]) == ("hold", "at-max")
    d = p.decide(dash(**PRESSURE), 2, now=105.0)
    assert d["reason"] == "at-max"
    # capacity frees (a drain elsewhere): the hold must START now, not
    # inherit the at-max dwell time as matured pressure
    d = p.decide(dash(**PRESSURE), 1, now=105.5)
    assert (d["action"], d["reason"]) == ("hold", "up-hold")


def test_no_data_freezes_and_resets_both_clocks():
    p = mk_policy(up_for_s=2.0)
    p.decide(dash(**PRESSURE), 1, now=100.0)
    d = p.decide({"scrapes": 0}, 1, now=101.9)
    assert (d["action"], d["reason"]) == ("hold", "no-data")
    assert p.counts["no_data"] == 1
    d = p.decide(None, 1, now=102.0)
    assert d["reason"] == "no-data"
    # data returns with the pressure clock RESET: pre-blindness dwell
    # must not mature into an up
    d = p.decide(dash(**PRESSURE), 1, now=102.1)
    assert (d["action"], d["reason"]) == ("hold", "up-hold")


def test_idle_must_hold_then_scales_down():
    p = mk_policy(idle_for_s=5.0, down_cooldown_s=1.0,
                  up_cooldown_s=1.0)
    d = p.decide(dash(**IDLE), 3, now=100.0)
    assert (d["action"], d["reason"]) == ("hold", "idle-hold")
    d = p.decide(dash(**IDLE), 3, now=104.0)
    assert d["action"] == "hold"
    d = p.decide(dash(**IDLE), 3, now=105.5)
    assert (d["action"], d["reason"]) == ("down", "idle")
    assert d["target"] == 2


def test_idle_needs_every_clear_surface():
    p = mk_policy(idle_for_s=0.5)
    # rps idle but queue above queue_low -> not idle
    d = p.decide(dash(queue=5.0, rps=0.2), 3, now=100.0)
    assert d["reason"] == "steady"
    # rps idle but shed still flowing -> not idle
    d = p.decide(dash(queue=0.0, rps=0.2, shed=2.0), 3, now=101.0)
    assert d["reason"] == "steady"
    # rps idle but the shed SLO is still firing -> not idle
    d = p.decide(dash(queue=0.0, rps=0.2, slo=True), 3, now=102.0)
    assert d["reason"] != "idle-hold"


def test_down_respects_min_and_both_cooldowns():
    p = mk_policy(idle_for_s=1.0, down_cooldown_s=10.0,
                  up_cooldown_s=20.0)
    p.decide(dash(**IDLE), 1, now=100.0)
    d = p.decide(dash(**IDLE), 1, now=102.0)
    assert (d["action"], d["reason"]) == ("hold", "at-min")
    # a recent UP also blocks a down (scale-up is fresher evidence)
    p2 = mk_policy(idle_for_s=1.0, up_for_s=0.5, up_cooldown_s=50.0,
                   down_cooldown_s=1.0)
    p2.decide(dash(**PRESSURE), 1, now=200.0)
    assert p2.decide(dash(**PRESSURE), 1, now=201.0)["action"] == "up"
    p2.decide(dash(**IDLE), 2, now=202.0)
    d = p2.decide(dash(**IDLE), 2, now=204.0)
    assert (d["action"], d["reason"]) == ("hold", "down-cooldown")


def test_backfill_below_min_bypasses_everything():
    p = mk_policy(min_replicas=2, up_cooldown_s=1000.0)
    p._last_up_at = 99.0   # deep inside the up cooldown
    # ... and the dashboard is BLIND — the floor still gets restored
    d = p.decide(None, 1, now=100.0)
    assert (d["action"], d["reason"]) == ("up", "backfill")
    assert d["backfill"] is True
    assert p.counts["backfills"] == 1


def test_decision_counter_identity():
    p = mk_policy(up_for_s=1.0, idle_for_s=1.0, up_cooldown_s=0.5,
                  down_cooldown_s=0.5)
    now = 100.0
    for payload, current in [(dash(**PRESSURE), 1),
                             (dash(**PRESSURE), 1),
                             (dash(**IDLE), 2), (dash(**IDLE), 2),
                             (None, 2), (dash(**PRESSURE), 0)]:
        p.decide(payload, current, now=now)
        now += 2.0
    c = p.counts
    assert c["scale_ups"] + c["scale_downs"] + c["holds"] \
        == c["decisions"] == 6
    assert c["backfills"] == 1 and c["no_data"] == 1


# ---------------------------------------------------------------------------
# predictive mode: the load model
# ---------------------------------------------------------------------------

DEVPROF = {"replica-0": {"last": {"rung": 4, "device_time_s": 0.02}},
           "replica-1": {"last": {"rung": 2, "device_time_s": 0.01}}}


def test_predictive_required_is_littles_law_over_rung_capacity():
    p = mk_policy(mode="predictive", target_util=0.6)
    sig = p.signals(dash(queue=1.0, rps=30.0, shed=10.0, lat=0.2,
                         deviceprof=DEVPROF))
    # offered 40/s x 0.2s latency = 8 in flight; capacity 4/0.6 = 6.67
    assert sig["required"] == 2
    assert sig["model"]["offered_rps"] == 40.0
    assert sig["model"]["demand_concurrency"] == 8.0
    assert sig["model"]["rung_batch"] == 4   # largest measured rung


def test_predictive_degrades_to_batch_one_without_profiles():
    p = mk_policy(mode="predictive", target_util=0.5)
    sig = p.signals(dash(queue=1.0, rps=10.0, lat=0.3))
    # no deviceprof: B=1 (conservative), capacity 2 -> ceil(3/2) = 2
    assert sig["required"] == 2
    assert sig["model"]["rung_batch"] is None
    # no latency yet: the model abstains rather than guessing
    sig = p.signals(dash(queue=1.0, rps=10.0))
    assert sig["required"] is None


def test_predictive_up_skips_the_hold_clock():
    p = mk_policy(mode="predictive", up_for_s=1000.0,
                  up_cooldown_s=5.0)
    d = p.decide(dash(queue=1.0, rps=30.0, shed=10.0, lat=0.2,
                      deviceprof=DEVPROF), 1, now=100.0)
    assert (d["action"], d["reason"]) == ("up", "model")
    # cooldown still applies — a model is not a license to thrash
    # (offered 80/s x 0.2s = 16 in flight -> required 3 > current 2)
    d = p.decide(dash(queue=1.0, rps=60.0, shed=20.0, lat=0.2,
                      deviceprof=DEVPROF), 2, now=100.5)
    assert (d["action"], d["reason"]) == ("hold", "up-cooldown")


def test_predictive_down_keeps_reactive_idle_discipline():
    p = mk_policy(mode="predictive", idle_for_s=5.0)
    d = p.decide(dash(**IDLE), 3, now=100.0)
    assert (d["action"], d["reason"]) == ("hold", "idle-hold")


# ---------------------------------------------------------------------------
# controller: actuation, telemetry, giveup backfill
# ---------------------------------------------------------------------------

class _FakeAgg:
    def __init__(self):
        self.payload = dash(**IDLE)

    def dashboard(self, window_s=None, now=None):
        return self.payload


class _FakeRouter:
    def __init__(self):
        self.aggregator = _FakeAgg()
        self.autoscaler = None


class _FakeSupervisor:
    def __init__(self, n):
        self._lock = threading.Lock()
        self.slots = [{"rid": f"replica-{i}", "given_up": False}
                      for i in range(n)]
        self.calls = []

    def add_slot(self):
        with self._lock:
            rid = f"replica-{len(self.slots)}"
            self.slots.append({"rid": rid, "given_up": False})
        self.calls.append(("add", rid))
        return {"rid": rid}

    def remove_slot(self):
        with self._lock:
            slot = self.slots.pop()
        self.calls.append(("remove", slot["rid"]))
        return {"removed": True, "rid": slot["rid"], "drained": True,
                "exit_code": 0}


def test_controller_requires_a_supervisor():
    with pytest.raises(ValueError, match="ReplicaSupervisor"):
        AutoscaleController(_FakeRouter(), None)


def test_controller_ticks_actuate_and_export():
    router = _FakeRouter()
    sup = _FakeSupervisor(1)
    cfg = AutoscaleConfig(min_replicas=1, max_replicas=3,
                          up_for_s=1.0, up_cooldown_s=0.1,
                          idle_for_s=1000.0)
    ctl = AutoscaleController(router, sup, cfg)
    router.aggregator.payload = dash(**PRESSURE)
    e0 = ctl.tick(now=100.0)
    assert e0["action"] == "hold" and e0["actuation"] is None
    e1 = ctl.tick(now=101.5)
    assert e1["action"] == "up"
    assert e1["actuation"] == {"rid": "replica-1"}
    assert sup.calls == [("add", "replica-1")]
    assert ctl.current_replicas() == 2
    snap = monitor.snapshot()
    assert _counter("autoscale.decisions") == 2
    assert _counter("autoscale.scale_ups") == 1
    assert _counter("autoscale.holds") == 1
    assert snap["gauges"]["autoscale.current_replicas"] == 1
    assert snap["gauges"]["autoscale.target_replicas"] == 2
    st = ctl.status()
    assert st["enabled"] and st["ticks"] == 2
    assert st["last_decision"]["action"] == "up"
    sec = ctl.dashboard_section()
    assert sec["mode"] == "reactive" and sec["current_replicas"] == 2
    assert sec["last_decision"]["reason"] == "queue-depth"


def test_controller_backfills_a_given_up_replica():
    router = _FakeRouter()
    sup = _FakeSupervisor(2)
    ctl = AutoscaleController(router, sup, AutoscaleConfig(
        min_replicas=2, max_replicas=3, up_cooldown_s=1000.0))
    sup.slots[0]["given_up"] = True     # dead capacity
    assert ctl.current_replicas() == 1  # given-up doesn't count
    e = ctl.tick(now=100.0)
    assert (e["action"], e["reason"]) == ("up", "backfill")
    assert sup.calls == [("add", "replica-2")]
    assert _counter("autoscale.backfills") == 1


def test_controller_treats_dashboard_crash_as_no_data():
    router = _FakeRouter()
    router.aggregator.dashboard = \
        lambda **kw: (_ for _ in ()).throw(RuntimeError("scrape died"))
    ctl = AutoscaleController(router, _FakeSupervisor(1),
                              AutoscaleConfig())
    e = ctl.tick(now=100.0)
    assert (e["action"], e["reason"]) == ("hold", "no-data")
    assert _counter("autoscale.no_data") == 1


# ---------------------------------------------------------------------------
# scale-down drain semantics: REAL supervised replica subprocesses
# ---------------------------------------------------------------------------

def test_remove_slot_drains_and_add_slot_never_reuses_rids():
    """remove_slot = the full drain handshake (drain-mark -> SIGTERM ->
    deregister-first -> exit 0), LIFO victim; add_slot mints monotonic
    rids so a drained identity never comes back."""
    from paddle_tpu_torch.serving.fleet import ReplicaSupervisor

    with tempfile.TemporaryDirectory(prefix="drain_") as tmp:
        model_dir = _save_mlp(os.path.join(tmp, "m"))
        router = FleetRouter(RouterConfig(probe_interval_s=0.25))
        # generous ttl_s: lease expiry only backs crash detection, and
        # this test asserts ejections stays 0 — a tight TTL can eject a
        # live replica whose heartbeat stalls on a loaded box
        sup = ReplicaSupervisor(
            router, model_dir, n_replicas=2, ttl_s=6.0,
            replica_args=("--max_batch_size=4", "--batch_timeout_ms=1",
                          "--device=cpu"),
            env=_replica_env(), log_dir=tmp)
        router.supervisor = sup
        sup.start()
        try:
            assert sup.wait_all_ready(timeout=180)
            assert sup.live_slots() == 2
            out = sup.remove_slot()
            assert out["removed"] is True
            assert out["rid"] == "replica-1"     # LIFO victim
            assert out["drained"] is True
            assert out["exit_code"] == 0         # clean exit, not kill
            assert sup.live_slots() == 1
            # the replica deregistered itself BEFORE dying: no lease
            # ever expired, the supervisor never "restarted" it
            assert _wait_until(
                lambda: _counter("fleet.deregistrations") == 1)
            assert _counter("fleet.ejections") == 0
            assert _counter("fleet.restarts") == 0
            assert _counter("fleet.slots_removed") == 1
            # grow again: the rid is NEW (monotonic minting)
            added = sup.add_slot()
            assert added["rid"] == "replica-2"
            assert _wait_until(
                lambda: router.replica_ready("replica-2"), timeout=180)
            assert sup.live_slots() == 2
            assert _counter("fleet.slots_added") == 1
            # no removable slot: everything draining/given-up is skipped
            out = sup.remove_slot(rid="replica-99")
            assert out["removed"] is False
        finally:
            sup.stop()
            router.shutdown()


# ---------------------------------------------------------------------------
# slot-aware LM dispatch through the router
# ---------------------------------------------------------------------------

SPEC = LMSpec(vocab_size=31, hidden_size=16, num_layers=2, num_heads=2,
              max_len=32)
WEIGHTS = init_lm_weights(SPEC, seed=3)


def make_lm_engine(**over):
    cfg = dict(max_slots=2, prefill_batch=1, max_prompt_len=8,
               max_new_tokens=6, default_deadline_ms=60000,
               prompt_buckets=[8], batch_buckets=[1])
    cfg.update(over)
    return GenerationEngine(SPEC, WEIGHTS,
                            config=GenerationConfig(**cfg), device="cpu")


@pytest.fixture(scope="module")
def lm_pair():
    """Two live LM replicas behind real HTTP servers (module-scoped:
    every fresh engine pays rung compiles)."""
    engines, servers, urls = [], [], []
    for _ in range(2):
        eng = make_lm_engine()
        server = make_server(eng, port=0)
        threading.Thread(target=server.serve_forever,
                         daemon=True).start()
        engines.append(eng)
        servers.append(server)
        urls.append(f"http://127.0.0.1:{server.server_address[1]}")
    yield engines, urls
    for server, eng in zip(servers, engines):
        server.shutdown()
        server.server_close()
        if not eng.stats()["closed"]:
            eng.shutdown(drain=False)


def _generate_via(url, prompt=(3, 7, 11), stream=False, n=4):
    body = json.dumps({"prompt": list(prompt), "stream": stream,
                       "max_new_tokens": n}).encode()
    req = urllib.request.Request(
        url + "/v1/generate", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, resp.read(), dict(resp.headers)


def test_registrar_advertises_free_slots(lm_pair):
    engines, urls = lm_pair
    assert engines[0].stats()["free_slots"] == 2
    router = FleetRouter(RouterConfig(probe_interval_s=0.05))
    try:
        reg = FleetRegistrar(router.url, "lm-0", urls[0], engines[0],
                             ttl_s=5.0)
        assert reg._payload()["free_slots"] == 2
        reg.start()
        assert _wait_until(lambda: router.replica_ready("lm-0"))
        row = router.status()["replicas"][0]
        assert row["free_slots"] == 2
        reg.stop(deregister=True)
    finally:
        router.shutdown()


def test_generate_routes_to_replicas_with_free_slots(lm_pair):
    """A slot-saturated replica (free_slots=0) is skipped even when it
    is otherwise the least-loaded pick; x-served-by proves it."""
    _, urls = lm_pair
    # slow probes: the advertised slot counts below stay authoritative
    router = FleetRouter(RouterConfig(probe_interval_s=30.0,
                                      probe_timeout_s=2.0))
    try:
        router.register("victim", urls[0], ttl_s=60, free_slots=0)
        router.register("peer", urls[1], ttl_s=60, free_slots=2)
        for rep in router._replicas.values():
            rep.ready = True    # probes are parked — mark routable
        # two picks: the router debits peer's 2 advertised slots; a
        # third would exhaust them and legitimately fall back
        served = set()
        for _ in range(2):
            code, body, hdrs = _generate_via(router.url)
            assert code == 200
            assert json.loads(body)["finish_reason"] in ("length",
                                                         "eos")
            served.add(hdrs["x-served-by"])
        assert served == {"peer"}
        assert _counter("fleet.requests") == 2
    finally:
        router.shutdown()


def test_generate_pick_decrements_slots_optimistically(lm_pair):
    """Two picks between heartbeats must not dogpile one replica: the
    router debits its cached free_slots on dispatch."""
    _, urls = lm_pair
    router = FleetRouter(RouterConfig(probe_interval_s=30.0))
    try:
        router.register("a", urls[0], ttl_s=60, free_slots=1)
        router.register("b", urls[1], ttl_s=60, free_slots=1)
        for rep in router._replicas.values():
            rep.ready = True
        served = []
        for _ in range(2):
            _, _, hdrs = _generate_via(router.url)
            served.append(hdrs["x-served-by"])
        assert sorted(served) == ["a", "b"]
    finally:
        router.shutdown()


def test_generate_falls_back_least_loaded_without_slot_reports(lm_pair):
    """Replicas that never advertised free_slots (pre-slot registrars)
    still serve /v1/generate via the least-loaded path."""
    _, urls = lm_pair
    router = FleetRouter(RouterConfig(probe_interval_s=30.0))
    try:
        router.register("old", urls[0], ttl_s=60)   # no free_slots
        for rep in router._replicas.values():
            rep.ready = True
        code, body, hdrs = _generate_via(router.url)
        assert code == 200 and hdrs["x-served-by"] == "old"
    finally:
        router.shutdown()


def test_generate_streams_through_the_router(lm_pair):
    """stream=true relays chunked NDJSON through the router with the
    fleet headers up front and counts fleet.streams."""
    _, urls = lm_pair
    router = FleetRouter(RouterConfig(probe_interval_s=0.05))
    try:
        router.register("lm", urls[0], ttl_s=60, free_slots=2)
        assert _wait_until(lambda: router.replica_ready("lm"))
        body = json.dumps({"prompt": [3, 7], "stream": True,
                           "max_new_tokens": 4}).encode()
        req = urllib.request.Request(
            router.url + "/v1/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200
            assert resp.headers["x-served-by"] == "lm"
            events = [json.loads(ln) for ln in resp if ln.strip()]
        assert events[-1]["event"] == "done"
        assert events[-1]["finish_reason"] in ("length", "eos")
        assert sum(1 for e in events if e["event"] == "token") \
            == len(events) - 1
        # counted after the terminal chunk is flushed — poll briefly
        assert _wait_until(lambda: _counter("fleet.streams") == 1)
        assert _counter("fleet.stream_upstream_errors") == 0
    finally:
        router.shutdown()


# ---------------------------------------------------------------------------
# client disconnect frees generation slots
# ---------------------------------------------------------------------------

def test_cancel_queued_request_never_takes_a_slot():
    with make_lm_engine(max_slots=1, max_new_tokens=24) as eng:
        a = eng.submit(np.array([3, 7, 11]))
        b = eng.submit(np.array([1, 4]))        # queued behind a
        assert eng.cancel(b) is True
        assert eng.cancel(b) is False           # idempotent
        toks, reason = b.result(timeout=60)
        assert reason == "cancelled" and toks.size == 0
        _, a_reason = a.result(timeout=60)
        assert a_reason in ("length", "eos")
        st = eng.stats()
        assert st["cancelled"] == 1
        assert st["completed"] == 1             # a only — b is NOT one
        assert st["slot_allocs"] == 1           # b never took a slot
        assert st["free_slots"] == 1
        assert _counter("serving_lm.client_disconnects") == 1
        assert eng.cancel(a) is False           # already done


def test_cancel_live_request_frees_the_slot_at_step_boundary():
    with make_lm_engine(max_slots=1, max_new_tokens=24) as eng:
        reason = None
        for _ in range(3):   # cancel races the (fast) decode loop
            s = eng.submit(np.array([3, 7, 11]))
            assert _wait_until(lambda: len(s._tokens) > 0, timeout=60)
            eng.cancel(s)
            _, reason = s.result(timeout=60)
            if reason == "cancelled":
                break
        assert reason == "cancelled"
        st = eng.stats()
        assert st["cancelled"] >= 1
        assert st["free_slots"] == 1            # the slot came back
        assert _counter("serving_lm.client_disconnects") >= 1
        # the engine is not wedged: the next generation runs clean
        _, r = eng.generate(np.array([5]), timeout=60)
        assert r in ("length", "eos")


def test_http_disconnect_mid_stream_cancels_generation():
    """A client that vanishes mid-stream (RST, no FIN) must not pin the
    KV slot for the rest of the generation."""
    with make_lm_engine(max_slots=1, max_new_tokens=24) as eng:
        server = make_server(eng, port=0)
        threading.Thread(target=server.serve_forever,
                         daemon=True).start()
        port = server.server_address[1]
        try:
            cancelled = 0
            for _ in range(3):
                body = json.dumps({"prompt": [3, 7, 11],
                                   "stream": True,
                                   "max_new_tokens": 24}).encode()
                sock = socket.create_connection(("127.0.0.1", port),
                                                timeout=30)
                sock.sendall(
                    b"POST /v1/generate HTTP/1.1\r\n"
                    b"Host: x\r\nContent-Type: application/json\r\n"
                    + f"Content-Length: {len(body)}\r\n\r\n".encode()
                    + body)
                buf = b""
                while b"token" not in buf:      # first streamed token
                    buf += sock.recv(4096)
                # RST on close: the replica's next write gets EPIPE
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                struct.pack("ii", 1, 0))
                sock.close()
                assert _wait_until(
                    lambda: eng.stats()["free_slots"] == 1, timeout=60)
                if _wait_until(lambda: eng.stats()["cancelled"] > 0):
                    cancelled = eng.stats()["cancelled"]
                    break
            assert cancelled >= 1, \
                "no disconnect ever cancelled a generation"
            assert _counter("serving_lm.client_disconnects") >= 1
            # the engine still serves after the rude client
            _, r = eng.generate(np.array([5]), timeout=60)
            assert r in ("length", "eos")
        finally:
            server.shutdown()
            server.server_close()


# ---------------------------------------------------------------------------
# loud supervisor giveup
# ---------------------------------------------------------------------------

def test_giveup_is_loud_counter_gauge_event_and_bundle():
    from paddle_tpu_torch.serving.fleet import ReplicaSupervisor
    env = _replica_env()
    with tempfile.TemporaryDirectory(prefix="giveup_") as tmp:
        pt.flags.reset()
        pt.flags.set_flag("metrics", True)
        pt.flags.set_flag("blackbox_dir", tmp)
        monitor.blackbox.reset()
        router = FleetRouter(RouterConfig(probe_interval_s=0.25))
        sup = ReplicaSupervisor(
            router, os.path.join(tmp, "nonexistent.pdmodel"),
            n_replicas=1, max_consecutive_restarts=0,
            restart_backoff_base_s=0.05, poll_interval_s=0.05,
            env=env, log_dir=tmp)
        sup.start()
        try:
            assert _wait_until(
                lambda: _counter("fleet.replica_giveups") == 1,
                timeout=60)
            assert sup.live_slots() == 0
            snap = monitor.snapshot()
            assert snap["gauges"]["fleet.giveup|replica=replica-0"] == 1
            # flight-recorder event
            evts = [r for r in monitor.blackbox.recorder().records()
                    if r.get("name") == "fleet_replica_giveup"]
            assert evts and evts[0]["replica_id"] == "replica-0"
            # post-mortem bundle with the giveup reason
            bundles = [f for f in os.listdir(tmp)
                       if f.startswith("blackbox-")]
            assert bundles
            with open(os.path.join(tmp, bundles[0])) as f:
                assert json.load(f)["reason"] == "fleet:replica_giveup"
        finally:
            sup.stop()
            router.shutdown()
            pt.flags.reset()


# ---------------------------------------------------------------------------
# shaped load schedules (bench_serving --shape)
# ---------------------------------------------------------------------------

def test_shape_schedules():
    from tools.bench_serving import shape_schedule
    assert shape_schedule("step", 2, 8, 30) == [(0.0, 2), (10.0, 8),
                                                (20.0, 2)]
    diurnal = shape_schedule("diurnal", 2, 10, 80)
    assert len(diurnal) == 8
    counts = [n for _, n in diurnal]
    assert counts[0] < counts[3] == 10      # ramps to peak...
    assert counts[-1] < counts[3]           # ...and back down
    burst = shape_schedule("burst", 1, 9, 100)
    assert [n for _, n in burst] == [1, 9, 1, 9, 1]
    herd = shape_schedule("herd", 3, 12, 40)
    assert herd[0] == (0.0, 0)              # silence, then everyone
    assert herd[1] == (10.0, 12)
    assert shape_schedule("step", 5, 2, 30)[1][1] == 5  # peak >= base
    with pytest.raises(ValueError, match="unknown shape"):
        shape_schedule("sawtooth", 1, 2, 10)


def test_run_shaped_load_records_and_schedule():
    from tools.bench_serving import run_shaped_load
    from paddle_tpu_torch.serving import EngineConfig, InferenceEngine
    specs = [{"name": "x", "dtype": "float32", "shape": [-1, 4]}]
    engine = InferenceEngine(lambda a: [a * 2.0], ["x"], ["y"],
                             input_specs=specs,
                             config=EngineConfig(max_batch_size=4,
                                                 batch_timeout_ms=0.0))
    server = make_server(engine, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        records, schedule = run_shaped_load(
            [url], "step", base_clients=1, peak_clients=2,
            duration_s=0.9, feeds={"x": [[1.0, 2.0, 3.0, 4.0]]},
            deadline_ms=5000, trace_prefix="shape")
        assert [s["clients"] for s in schedule] == [1, 2, 1]
        assert records and all(r["outcome"] == "ok" for r in records)
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown(drain=False)


# ---------------------------------------------------------------------------
# telemetry coverage
# ---------------------------------------------------------------------------

def test_registry_help_covers_autoscale_family():
    from paddle_tpu_torch.monitor.registry import _HELP
    for name in ("autoscale.decisions", "autoscale.scale_ups",
                 "autoscale.scale_downs", "autoscale.holds",
                 "autoscale.backfills", "autoscale.no_data",
                 "autoscale.current_replicas",
                 "autoscale.target_replicas", "fleet.giveup",
                 "fleet.slots_added", "fleet.slots_removed",
                 "fleet.streams", "fleet.stream_upstream_errors",
                 "fleet.client_disconnects",
                 "serving_lm.client_disconnects"):
        assert name in _HELP, name




# ---------------------------------------------------------------------------
# both packages' policies decide alike
# ---------------------------------------------------------------------------

def _script():
    """A scripted day of dashboards: a blind start, a ramp under queue
    pressure and SLO firing, a plateau, a profiled surge, a scrape
    outage, a quiet spell and a trickle, a lost replica (below min)."""
    steps = [(None, 1), (dash(queue=0.0, rps=0.0, lat=None, scrapes=0), 1)]
    steps += [(dash(**PRESSURE), None)] * 5
    steps += [(dash(queue=3.0, rps=40.0, lat=0.05, slo=True), None)] * 3
    steps += [(dash(queue=4.0, rps=30.0, lat=0.05), None)] * 4
    steps += [(dash(queue=1.0, rps=60.0, shed=20.0, lat=0.2,
                    deviceprof=DEVPROF), None)] * 4
    steps += [(None, None)] * 2
    steps += [(dash(**IDLE), None)] * 12
    steps += [(dash(queue=0.0, rps=0.8, lat=0.01), None)] * 4
    steps += [(dash(**IDLE), 0)] + [(dash(**IDLE), None)] * 3
    return steps


@pytest.mark.parametrize("mode", ["reactive", "predictive"])
def test_decisions_equal_the_reference_policy(mode):
    """The same scripted dashboards, fed to the port's and the JAX
    package's AutoscalePolicy with the same config, give exactly the
    same decision sequence (action, reason, target, signals), and the
    same counts."""
    knobs = dict(min_replicas=1, max_replicas=3, mode=mode,
                 interval_s=1.0, signal_window_s=5.0, queue_high=8.0,
                 queue_low=2.0, up_for_s=2.0, idle_rps=1.0,
                 idle_for_s=5.0, up_cooldown_s=3.0, down_cooldown_s=4.0,
                 target_util=0.6)
    runs = []
    for cfg_cls, pol_cls in ((AutoscaleConfig, AutoscalePolicy),
                             (jserving.AutoscaleConfig,
                              jserving.AutoscalePolicy)):
        policy = pol_cls(cfg_cls(**knobs))
        current, now, decisions = 1, 100.0, []
        for payload, forced in _script():
            if forced is not None:
                current = forced
            d = policy.decide(payload, current, now=now)
            decisions.append(d)
            current = d.get("target", current) if d["action"] != "hold" \
                else current
            now += 1.0
        runs.append((decisions, dict(policy.counts)))
    assert runs[0] == runs[1]
    decisions, counts = runs[0]
    actions = [d["action"] for d in decisions]
    # the script reaches every branch of the policy
    assert "up" in actions and "down" in actions
    reasons = {d["reason"] for d in decisions}
    assert {"no-data", "backfill", "idle-hold"} <= reasons
    assert counts["scale_ups"] + counts["scale_downs"] + counts["holds"] \
        == counts["decisions"] == len(_script())
