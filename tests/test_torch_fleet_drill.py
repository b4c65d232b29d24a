"""The fleet chaos drill on the port, in small form, on the CPU.

The twin of the reference drill (tools/check_fleet.py) with real
`python -m paddle_tpu_torch serve --fleet --device cpu` subprocesses:
an in-process port FleetRouter + ReplicaSupervisor run two replicas of a
JAX-written embedded-program artifact under closed-loop HTTP load, and
each phase must end with zero raw client failures, `x-trace-id`
preserved, `fleet.*` counters equal to the injected schedule, and every
reply equal to the serving model's (replicas dispatch one row at a
time, so a reply is bitwise the in-process engine's row):

  kill       SIGKILL one replica: failover, one breaker open, one
             ejection, one restart, readmission after warmup;
  partition  a `fleet_forward` fault window: both breakers open, sheds
             are typed 503 with Retry-After, both close on heal;
  swap       a rolling swap to a second artifact: zero dropped and zero
             typed-errored requests, two swaps, replies from the new
             model afterwards.

Then one LM replica over a JAX-written tiny LM artifact (`serve --fleet`,
greedy tokens equal to the in-process engine's, through the router,
buffered and streamed), and the `route` job: one replica, one request,
exit 0 on SIGTERM.

No test holds a wall-clock budget: every wait polls with a deadline of
30 s or more.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import serving as jserving
from paddle_tpu_torch import flags, monitor
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (EngineConfig, GenerationEngine,
                                      InferenceEngine)
from paddle_tpu_torch.serving.fleet import (FleetRouter, ReplicaSupervisor,
                                            RouterConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 8
ROW = np.linspace(-1.0, 1.0, F, dtype=np.float32)[None]
BODY = json.dumps({"feeds": {"x": ROW.tolist()},
                   "deadline_ms": 20000}).encode()
WAIT_S = 120.0
THINK_S = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's intra-op work in one thread while this file runs: the
    tier-1 run puts several pytest workers on the same cores
    (tests/torch_port_helpers.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"      # six test workers share the cores
    return env


def _counters(*names):
    snap = monitor.snapshot()["counters"]
    return {n: int(snap.get(n, 0)) for n in names}


def _wait(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _export_mlp(path, seed):
    """A softmax MLP exported by the JAX package with its program
    embedded (symbolic batch)."""
    jpt.framework.reset_default_programs()
    main, startup = jpt.Program(), jpt.Program()
    with jpt.program_guard(main, startup):
        x = jpt.layers.data("x", [F], dtype="float32")
        h = jpt.layers.fc(x, 16, act="relu")
        y = jpt.layers.fc(h, 4, act="softmax")
    exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(seed)     # the weights, from the seed
    for name, var in sorted(main.global_block().vars.items()):
        if var.persistable:
            shape = np.shape(scope.get(name))
            scope.set(name, (0.5 * rng.randn(*shape)).astype(np.float32))
    jpt.io.export_inference_artifact(path, ["x"], [y], exe,
                                     main_program=main, scope=scope,
                                     embed_program=True)
    return path


def _model_reply(path):
    """The serving model's reply to ROW: the port engine in process."""
    with InferenceEngine.from_artifact(
            path, config=EngineConfig(max_batch_size=1), device="cpu") as e:
        return e.infer({"x": ROW}, timeout=60)[0].tolist()


class _Load:
    """Closed-loop /v1/infer clients, each pausing THINK_S between its
    requests (so the drill leaves the cores to the other test workers);
    each record keeps what a client saw: outcome ok / typed / raw, the
    trace id echo, the replica, the hop count, Retry-After and the
    outputs."""

    def __init__(self, url, clients, prefix):
        self.records = []
        self.stop = threading.Event()
        self._threads = [threading.Thread(target=self._client,
                                          args=(url, f"{prefix}-{i}"),
                                          daemon=True)
                         for i in range(clients)]
        for t in self._threads:
            t.start()

    def _client(self, url, prefix):
        n = 0
        while not self.stop.is_set():
            tid = f"{prefix}-{n}"
            n += 1
            req = urllib.request.Request(
                url + "/v1/infer", data=BODY,
                headers={"Content-Type": "application/json",
                         "x-trace-id": tid})
            rec = {"trace_id": tid, "t": time.monotonic()}
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    status, hdrs, body = resp.status, resp.headers, \
                        resp.read()
            except urllib.error.HTTPError as e:
                status, hdrs, body = e.code, e.headers, e.read()
            except (OSError, ValueError) as e:
                rec.update(outcome="raw", error=repr(e))
                self.records.append(rec)
                self.stop.wait(THINK_S)
                continue
            try:
                payload = json.loads(body)
            except ValueError:
                payload = {}
            rec.update(status=status,
                       trace_ok=hdrs.get("x-trace-id") == tid,
                       served_by=hdrs.get("x-served-by"),
                       attempts=int(hdrs.get("x-fleet-attempts") or 0),
                       retry_after=hdrs.get("Retry-After"))
            if status == 200:
                rec.update(outcome="ok", outputs=payload["outputs"][0])
            elif status in (429, 503, 504) and payload.get(
                    "error_type") in ("shed", "unavailable", "deadline"):
                rec.update(outcome="typed",
                           error_type=payload["error_type"])
            else:
                rec.update(outcome="raw", error=payload)
            self.records.append(rec)
            self.stop.wait(THINK_S)

    def oks(self, start=0):
        return sum(1 for r in self.records[start:] if r["outcome"] == "ok")

    def finish(self):
        self.stop.set()
        for t in self._threads:
            t.join(timeout=90)
        return list(self.records)


def _summary(records):
    typed = {}
    for r in records:
        if r["outcome"] == "typed":
            typed[r["error_type"]] = typed.get(r["error_type"], 0) + 1
    return {"raw": [r for r in records if r["outcome"] == "raw"],
            "typed": typed,
            "lost_trace": sum(1 for r in records
                              if r["outcome"] != "raw"
                              and not r["trace_ok"]),
            "failovers": sum(1 for r in records if r["outcome"] == "ok"
                             and r["attempts"] > 1),
            "served_by": {r["served_by"] for r in records
                          if r["outcome"] == "ok"}}


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """Two supervised replicas of the first artifact behind a port
    router, and the replies of both artifacts' models."""
    tmp = tmp_path_factory.mktemp("drill")
    m1 = _export_mlp(str(tmp / "m1.pdmodel"), seed=1)
    m2 = _export_mlp(str(tmp / "m2.pdmodel"), seed=2)
    want = {m1: _model_reply(m1), m2: _model_reply(m2)}
    assert want[m1] != want[m2]
    flags.reset()
    flags.set_flag("metrics", True)
    flags.set_flag("faults", "")
    faults.reset()
    monitor.reset()
    monitor.set_enabled(True)
    router = FleetRouter(RouterConfig(
        retry_budget=2, probe_interval_s=0.25, probe_timeout_s=2.0,
        probe_down_after=2, breaker_threshold=2, breaker_cooldown_s=4.0))
    # a restart backoff longer than the ttl keeps the kill schedule
    # ordered: the killed replica's lease expires (one ejection) before
    # its replacement is even spawned; a live replica's heartbeat (every
    # ttl/3) would have to stall 2 s to lose its lease on a loaded box
    sup = ReplicaSupervisor(
        router, m1, n_replicas=2, ttl_s=2.0,
        replica_args=("--max_batch_size=1", "--batch_timeout_ms=0",
                      "--device=cpu"),
        env=_env(), log_dir=str(tmp), restart_backoff_base_s=3.0)
    router.supervisor = sup
    sup.start()
    try:
        _wait(lambda: sup.wait_all_ready(timeout=0.1), "fleet ready")
        yield router, sup, want, (m1, m2), str(tmp)
    finally:
        flags.set_flag("faults", "")
        faults.reset()
        sup.stop()
        router.shutdown()
        flags.reset()
        monitor.reset()
        monitor.set_enabled(False)


def _logs(tmp):
    return "\n".join(f"{n}: {open(os.path.join(tmp, n)).read()[-800:]}"
                     for n in sorted(os.listdir(tmp)) if n.endswith(".log"))


def test_kill_fails_over_and_restarts(drill):
    router, sup, want, (m1, _), tmp = drill
    monitor.reset()
    load = _Load(router.url, clients=4, prefix="kill")
    try:
        _wait(lambda: load.oks() >= 20, "pre-kill traffic")
        sup.procs()["replica-1"].kill()        # SIGKILL: no drain
        _wait(lambda: _counters("fleet.restarts")["fleet.restarts"] >= 1,
              "supervisor restart")
        _wait(lambda: router.replica_ready("replica-1"),
              "restarted replica readmitted")
        n0 = len(load.records)
        _wait(lambda: any(r.get("served_by") == "replica-1"
                          for r in load.records[n0:]),
              "restarted replica serving")
    finally:
        records = load.finish()
    res = _summary(records)
    assert not res["raw"], (res["raw"][:3], _logs(tmp))
    assert not res["typed"], res["typed"]
    assert res["lost_trace"] == 0
    assert res["failovers"] >= 1
    assert res["served_by"] == {"replica-0", "replica-1"}
    assert all(r["outputs"] == want[m1] for r in records
               if r["outcome"] == "ok")
    got = _counters("fleet.breaker_opens", "fleet.ejections",
                    "fleet.restarts", "fleet.registrations",
                    "fleet.failovers", "fleet.deregistrations",
                    "resilience.faults_injected")
    assert got == {"fleet.breaker_opens": 1, "fleet.ejections": 1,
                   "fleet.restarts": 1, "fleet.registrations": 1,
                   "fleet.failovers": res["failovers"],
                   "fleet.deregistrations": 0,
                   "resilience.faults_injected": 0}, got


def test_partition_window_sheds_typed_and_heals(drill):
    router, sup, want, (m1, _), tmp = drill
    _wait(lambda: sup.wait_all_ready(timeout=0.1), "fleet ready")
    monitor.reset()
    load = _Load(router.url, clients=4, prefix="part")
    try:
        _wait(lambda: load.oks() >= 10, "pre-partition traffic")
        n_arm = len(load.records)
        flags.set_flag("faults", "fleet_forward:1:partition(0.6)")
        faults.reset()
        _wait(lambda: _counters("fleet.breaker_closes")
              ["fleet.breaker_closes"] >= 2, "breakers closing")
        n_heal = len(load.records)
        _wait(lambda: load.oks(n_heal) >= 10, "traffic after the heal")
    finally:
        records = load.finish()
        flags.set_flag("faults", "")
        faults.reset()
    res = _summary(records)
    windowed = _summary(records[n_arm:])
    assert not res["raw"], (res["raw"][:3], _logs(tmp))
    assert set(windowed["typed"]) == {"unavailable"}, windowed["typed"]
    assert all(r["retry_after"] for r in records
               if r["outcome"] == "typed")
    assert res["lost_trace"] == 0
    assert all(r["outputs"] == want[m1] for r in records
               if r["outcome"] == "ok")
    got = _counters("fleet.breaker_opens", "fleet.breaker_closes",
                    "fleet.ejections", "fleet.restarts",
                    "resilience.faults_injected")
    assert got == {"fleet.breaker_opens": 2, "fleet.breaker_closes": 2,
                   "fleet.ejections": 0, "fleet.restarts": 0,
                   "resilience.faults_injected": 1}, got


def test_rolling_swap_drops_nothing(drill):
    router, sup, want, (m1, m2), tmp = drill
    _wait(lambda: sup.wait_all_ready(timeout=0.1), "fleet ready")
    monitor.reset()
    load = _Load(router.url, clients=4, prefix="swap")
    try:
        _wait(lambda: load.oks() >= 10, "pre-swap traffic")
        report = sup.rolling_swap(artifact=m2)
        n_done = len(load.records)
        _wait(lambda: load.oks(n_done) >= 10, "traffic after the swap")
    finally:
        records = load.finish()
    assert all(s.get("ready") for s in report), (report, _logs(tmp))
    res = _summary(records)
    assert not res["raw"], res["raw"][:3]
    assert not res["typed"], res["typed"]
    assert res["lost_trace"] == 0
    oks = [r for r in records if r["outcome"] == "ok"]
    assert all(r["outputs"] in (want[m1], want[m2]) for r in oks)
    assert all(r["outputs"] == want[m2] for r in oks[-10:])
    assert all(r["outputs"] == want[m2] for r in records[n_done:]
               if r["outcome"] == "ok")
    got = _counters("fleet.swaps", "fleet.restarts", "fleet.ejections",
                    "fleet.registrations", "fleet.deregistrations")
    assert got == {"fleet.swaps": 2, "fleet.restarts": 0,
                   "fleet.ejections": 0, "fleet.registrations": 2,
                   "fleet.deregistrations": 2}, got


def _post(url, path, body, timeout=60):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.headers, resp.read()


def test_lm_replica_serves_a_jax_artifact_in_the_fleet(tmp_path):
    spec = jserving.LMSpec(31, 16, 2, 2, 32)
    weights = jserving.init_lm_weights(spec, seed=5)
    cfg = jserving.GenerationConfig(max_slots=2, prefill_batch=1,
                                    max_prompt_len=8, max_new_tokens=6,
                                    prompt_buckets=[8], batch_buckets=[1])
    path = str(tmp_path / "lm.pdmodel")
    jpt.io.export_lm_artifact(path, weights, spec, serving=cfg)
    prompt = [3, 7, 11, 2]
    with GenerationEngine.from_artifact(path, device="cpu") as eng:
        want = eng.generate(np.array(prompt), timeout=60)[0].tolist()
    router = FleetRouter(RouterConfig(probe_interval_s=0.25))
    sup = ReplicaSupervisor(router, path, n_replicas=1, ttl_s=5.0,
                            replica_args=("--device=cpu",), env=_env(),
                            log_dir=str(tmp_path))
    router.supervisor = sup
    sup.start()
    try:
        assert sup.wait_all_ready(timeout=WAIT_S), _logs(str(tmp_path))
        row = router.status()["replicas"][0]
        assert row["free_slots"] == 2          # the registrar's report
        status, hdrs, body = _post(router.url, "/v1/generate",
                                   {"prompt": prompt, "stream": False})
        assert status == 200 and hdrs["x-served-by"] == "replica-0"
        assert json.loads(body)["tokens"] == want
        status, hdrs, body = _post(router.url, "/v1/generate",
                                   {"prompt": prompt})
        events = [json.loads(ln) for ln in body.splitlines() if ln]
        assert [e["token"] for e in events if e["event"] == "token"] \
            == want
        assert events[-1]["event"] == "done"
    finally:
        sup.stop()
        router.shutdown()


def test_route_job_answers_and_exits_zero_on_sigterm(tmp_path):
    path = _export_mlp(str(tmp_path / "m.pdmodel"), seed=3)
    want = _model_reply(path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "route",
         f"--artifact={path}", "--replicas=1", "--device=cpu",
         "--port=0", "--max_batch_size=1", "--probe_interval=0.25"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        url = None
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"fleet router on (http://\S+):", line)
            url = m.group(1) if m else url
            if "fleet ready" in line:
                break
        assert url and lines[-1].strip().endswith("fleet ready"), lines
        status, hdrs, body = _post(url, "/v1/infer",
                                   {"feeds": {"x": ROW.tolist()}})
        assert status == 200 and hdrs["x-served-by"] == "replica-0"
        assert json.loads(body)["outputs"][0] == want
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=WAIT_S)
        lines.append(out)
        assert proc.returncode == 0, "".join(lines)
        counters = json.loads(out.split("fleet counters: ", 1)[1]
                              .splitlines()[0])
        assert counters["fleet.requests"] == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
