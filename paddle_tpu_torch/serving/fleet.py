"""Resilient serving fleet: health-checked replica router + supervisor.

The port of `paddle_tpu/serving/fleet.py`, device-free and with the wire
protocol unchanged (paths, JSON fields, the `x-served-by` /
`x-fleet-attempts` / `x-trace-id` / `Retry-After` headers, status codes,
counter names, DASHBOARD_SCHEMA_VERSION): a port replica registers with
either package's router, and either package's replica with this one.
It makes replica death invisible to clients. The shape is a master /
replica cloud runtime (membership, heartbeats, fault-tolerant handoff)
with lease / TTL membership:

  FleetRouter      front-tier HTTP router over N replica processes.
                   Membership is TTL'd self-registration (replicas POST
                   /fleet/register and heartbeat /fleet/heartbeat; a
                   lease that stops being renewed is ejected by the
                   sweep) plus /healthz readiness probing — a replica
                   is routable only when lease-live, `"ready"` (warmed),
                   probe-reachable, not draining, and its circuit
                   breaker admits traffic. Dispatch is least-loaded off
                   each replica's reported queue depth + the router's
                   own in-flight count; /v1/generate dispatch prefers
                   the replica with the most free generation slots.

  circuit breaker  per replica: consecutive forward failures open it
                   (routing skips the replica), a cooldown later it
                   half-opens (exactly one trial request), success
                   closes it. Opens/closes are counted
                   (fleet.breaker_opens/_closes) so recovery is
                   *observable*.

  failover         inference requests are idempotent, so a hop that
                   dies in transport (connection refused/reset/timeout,
                   or an injected PartitionFault at the `fleet_forward`
                   site) retries transparently on a peer under a
                   bounded retry budget that respects the client's
                   remaining `deadline_ms` (each hop forwards only the
                   remaining budget) and preserves `x-trace-id` across
                   hops — one trace id recovers the full multi-hop
                   story from the flight recorder.

  typed shedding   terminal failures are never raw: every live replica
                   saturated -> 429 + Retry-After ("shed"); no routable
                   replica / budget exhausted on failures -> 503 +
                   Retry-After ("unavailable"); deadline lapsed -> 504
                   ("deadline"). A genuine replica 5xx consistent
                   across peers relays as-is (a model bug must surface,
                   not be laundered).

  ReplicaSupervisor
                   spawns `python -m paddle_tpu_torch serve --fleet ...`
                   subprocesses over an artifact file (`--artifact`) or
                   a `save_inference_model` directory (`--model_dir`),
                   restarts crashed ones under an exponential-backoff
                   restart budget (fleet.restarts), and performs rolling
                   model-version swaps with the engine's drain
                   semantics: mark draining at the router -> SIGTERM
                   (the replica deregisters, drains in-flight work,
                   exits 0) -> respawn on the new model -> wait
                   warmed+readmitted -> next replica. Zero dropped
                   requests. Replicas run on the card unless
                   `replica_args` holds `--device=cpu`; one that cannot
                   reach the card exits non-zero, and the restart budget
                   then gives up on it loudly (fleet.replica_giveups).

  FleetRegistrar   the replica-side lease agent the serve CLI runs when
                   --fleet is given: registers after the HTTP server
                   binds, heartbeats ready/queue_depth (and an LM
                   replica's free_slots) every ttl/3, and deregisters
                   before draining so the router stops routing first.

  FleetAggregator  the fleet-wide time-series observatory: scrapes
                   each live replica's /debug/vars on a cadence, merges
                   per-family series (sum for counters/queue depths,
                   max for peaks, weighted quantile merge for latency)
                   into fleet-level windows, evaluates fleet-scope SLO
                   rules (monitor/slo.py), and serves
                   GET /fleet/dashboard — the autoscaler's signal
                   schema (DASHBOARD_SCHEMA_VERSION).

Shell: `python -m paddle_tpu_torch route --model_dir m --replicas 3`
(or `--artifact m.pdmodel`).
"""

from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import threading
import time
from urllib.parse import urlsplit

from .. import monitor
from ..resilience import faults
from .http import (QuietHTTPServer, TimeoutAwareHandler,
                   resolve_trace_id)

__all__ = ["RouterConfig", "FleetRouter", "ReplicaSupervisor",
           "FleetRegistrar", "FleetAggregator", "DASHBOARD_SCHEMA_VERSION"]

_MAX_BODY = 64 << 20       # request cap, matching the replica front end
_MAX_CONTROL_BODY = 1 << 20   # /fleet/* control payloads are tiny


def _finish(span, error=None):
    if span is not None:
        span.finish(error=error)


class RouterConfig:
    """Fleet-router knobs.

      retry_budget        — extra hops (failovers) allowed per request
                            after the first attempt.
      probe_interval_s    — lease sweep + /healthz probe cadence.
      probe_timeout_s     — per-probe HTTP timeout.
      probe_down_after    — consecutive probe failures before a replica
                            is considered down (unroutable) even though
                            its lease has not yet expired.
      breaker_threshold   — consecutive forward failures that open a
                            replica's circuit breaker.
      breaker_cooldown_s  — open -> half-open (single trial) delay.
      forward_timeout_s   — per-hop socket timeout cap (a client
                            deadline tightens it further).
      retry_after_s       — the Retry-After hint on 429/503 replies.
      scrape_interval_s   — fleet aggregation cadence: how often the
                            router scrapes each live replica's
                            /debug/vars into the fleet time-series
                            (0 disables aggregation + /fleet/dashboard
                            windows).
      dashboard_window_s  — default trailing window of the
                            /fleet/dashboard series and the fleet SLO
                            evaluations.
    """

    def __init__(self, retry_budget=2, probe_interval_s=0.5,
                 probe_timeout_s=2.0, probe_down_after=2,
                 breaker_threshold=3, breaker_cooldown_s=5.0,
                 forward_timeout_s=30.0, retry_after_s=1,
                 scrape_interval_s=1.0, dashboard_window_s=30.0):
        if retry_budget < 0:
            raise ValueError("retry_budget must be >= 0")
        if breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        self.retry_budget = int(retry_budget)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.probe_down_after = int(probe_down_after)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.forward_timeout_s = float(forward_timeout_s)
        self.retry_after_s = max(1, int(round(retry_after_s)))
        self.scrape_interval_s = float(scrape_interval_s)
        self.dashboard_window_s = float(dashboard_window_s)


class _Replica:
    """One fleet member's routing state (router-private; guarded by the
    router lock). Breaker state machine lives inline: closed ->
    (threshold consecutive failures) open -> (cooldown) half_open with
    one trial -> closed on success / open on failure."""

    __slots__ = ("replica_id", "url", "seq", "ttl_s", "lease_expires_at",
                 "ready", "draining", "queue_depth", "free_slots",
                 "inflight", "probe_fails", "served", "failed_hops",
                 "brk_state", "brk_fails", "brk_opened_at", "brk_trial",
                 "registered_at")

    def __init__(self, replica_id, url, seq):
        self.replica_id = replica_id
        self.url = url
        self.seq = seq
        self.ttl_s = None
        self.lease_expires_at = None
        self.ready = False
        self.draining = False
        self.queue_depth = 0
        # generation-slot availability (LM replicas only): advertised in
        # register/heartbeat off GenerationEngine stats; None = this
        # replica never reported slots (one-shot inference replica)
        self.free_slots = None
        self.inflight = 0
        self.probe_fails = 0
        self.served = 0
        self.failed_hops = 0
        self.brk_state = "closed"
        self.brk_fails = 0
        self.brk_opened_at = 0.0
        self.brk_trial = False
        self.registered_at = time.monotonic()


class _RouteReply:
    """What the HTTP layer sends back: status + raw body (relayed
    replica bytes, or a router-minted JSON error) + headers."""

    __slots__ = ("status", "body", "content_type", "headers")

    def __init__(self, status, body, content_type="application/json",
                 headers=None):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}


# /fleet/dashboard payload schema — the autoscaler's input contract.
# Bump on breaking shape changes so consumers can gate on it.
DASHBOARD_SCHEMA_VERSION = 1


class FleetAggregator:
    """Fleet-wide time-series: the router's windowed view of its fleet.

    Each scrape tick (RouterConfig.scrape_interval_s, driven from the
    probe loop) GETs every registered replica's `/debug/vars`, feeds
    the embedded metrics snapshot into a per-replica TimeSeriesStore
    (monitor/timeseries.py — the SAME rate/window/quantile math the
    local sampler uses, so the layers cannot disagree), samples the
    router's own registry (the fleet.* typed-reply counters), merges a
    fleet-level tick, and evaluates the fleet-scope SLO rules.

    Merge rules (per metric family, documented in ARCHITECTURE.md):

      counters      per-replica reset-tolerant rates, then SUMMED — a
                    replica restart can never produce a negative or
                    inflated fleet rate
      queue depths  summed across replicas (fleet total)
      peaks (max)   max across replicas
      latency       weighted quantile merge (timeseries.merge_quantiles)
                    over per-replica windowed summaries, weights =
                    per-replica windowed observation counts

    The merged windows are served as `GET /fleet/dashboard` (schema
    DASHBOARD_SCHEMA_VERSION — precisely the autoscaler's future
    inputs) and exported as `fleet.series.*` gauges."""

    def __init__(self, router, scrape_interval_s=1.0, window_s=30.0,
                 timeout_s=2.0):
        from ..monitor import slo as _slo
        from ..monitor import timeseries as _ts
        self.router = router
        self.interval_s = float(scrape_interval_s)
        self.window_s = float(window_s)
        self.timeout_s = float(timeout_s)
        self._ts = _ts
        self._lock = threading.Lock()
        self._replicas = {}     # rid -> {store, url, ok, error, last}
        self._fleet = _ts.TimeSeriesStore()      # merged tick series
        self._router_store = _ts.TimeSeriesStore()
        # manual-tick sampler over this process's registry: fleet.*
        # counters + the router's own histograms (never started as a
        # thread — the probe loop drives it)
        self._router_sampler = _ts.Sampler(
            0, store=self._router_store)
        self.slo_engine = _slo.SloEngine(_slo.merged_rules(
            _slo.default_fleet_rules(),
            _slo.rules_from_flag(scope="fleet")), scope="fleet")
        self._last_scrape = 0.0          # monotonic
        self.scrapes = 0

    # -- scrape -------------------------------------------------------------

    def due(self, now_mono=None):
        if self.interval_s <= 0:
            return False
        if now_mono is None:
            now_mono = time.monotonic()
        return now_mono - self._last_scrape >= self.interval_s

    def scrape(self):
        """One aggregation tick: fetch every registered replica's
        /debug/vars concurrently, ingest, merge, evaluate fleet SLOs."""
        self._last_scrape = time.monotonic()
        reps = self.router._snapshot_replicas()
        results = {}

        def fetch(rep):
            try:
                parts = urlsplit(rep.url)
                conn = http.client.HTTPConnection(
                    parts.hostname, parts.port, timeout=self.timeout_s)
                try:
                    conn.request("GET", "/debug/vars")
                    resp = conn.getresponse()
                    payload = json.loads(resp.read())
                    if resp.status != 200 or \
                            not isinstance(payload, dict):
                        raise ValueError(f"status {resp.status}")
                    results[rep.replica_id] = payload
                finally:
                    conn.close()
            except (OSError, ValueError,
                    http.client.HTTPException) as e:
                results[rep.replica_id] = e

        threads = [threading.Thread(target=fetch, args=(rep,),
                                    daemon=True) for rep in reps]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.timeout_s + 1.0
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        now = time.time()
        for rep in reps:
            self.ingest(rep.replica_id, rep.url,
                        results.get(rep.replica_id), now)
        live = {rep.replica_id for rep in reps}
        with self._lock:
            for rid in [r for r in self._replicas if r not in live]:
                del self._replicas[rid]   # ejected/deregistered: gone
        self._router_sampler.tick(now)
        self._merge_tick(now)
        self.slo_engine.evaluate(self.probe(), now=now)
        self.scrapes += 1

    def ingest(self, replica_id, url, payload, now=None):
        """Feed one replica's /debug/vars payload (or a fetch error)
        into its store. Public so hermetic tests can drive aggregation
        without HTTP."""
        if now is None:
            now = time.time()
        with self._lock:
            ent = self._replicas.get(replica_id)
            if ent is None or ent["url"] != url:
                ent = self._replicas[replica_id] = {
                    "store": self._ts.TimeSeriesStore(), "url": url,
                    "ok": False, "error": None, "last": None,
                    "deviceprof": None, "serving_lm": None}
        if isinstance(payload, dict):
            # sampled device-time attribution (optional section, only
            # when the replica runs with profile_sample_n>0) — stashed
            # verbatim for the dashboard's hot-ops view
            dp = payload.get("deviceprof")
            ent["deviceprof"] = dp if isinstance(dp, dict) else None
            # generative-LM replica (serve --generate): its always-on
            # engine stats ride /debug/vars under "engine" with
            # kind="lm" — stashed for the dashboard's slots/KV view
            eng = payload.get("engine")
            ent["serving_lm"] = (eng if isinstance(eng, dict)
                                 and eng.get("kind") == "lm" else None)
            metrics = payload.get("metrics")
            if isinstance(metrics, dict):
                # a snapshot's histogram summary is process-LIFETIME;
                # when the replica runs its own sampler (serve --fleet
                # defaults it on) its /debug/vars carries the windowed
                # view — use those window-local quantile knots so the
                # fleet latency merge reacts on the window timescale
                ent["store"].append_snapshot(
                    metrics, now,
                    hist_window_summaries=self._ts
                    .window_summaries_from_debug_vars(payload))
                ent["ok"] = True
                ent["error"] = None
                ent["last"] = now
                return
            payload = ValueError("payload carried no metrics section")
        ent["ok"] = False
        ent["error"] = (f"{type(payload).__name__}: {payload}"
                        if payload is not None else "no response")

    def _replica_stores(self):
        with self._lock:
            return {rid: ent["store"]
                    for rid, ent in self._replicas.items()}

    # -- merged tick + probe ------------------------------------------------

    def _shed_rate(self, window_s, now=None):
        """Client-visible shed: the router's own typed replies/s."""
        rates = [self._router_store.rate(n, window_s, now)
                 for n in ("fleet.shed", "fleet.unavailable",
                           "fleet.deadline_exceeded")]
        rates = [r for r in rates if r is not None]
        return sum(rates) if rates else None

    def _merge_tick(self, now):
        """Append one fleet-level point per key series. The short rate
        window (3 ticks) makes the series responsive; the dashboard's
        scalar window view uses the full window_s."""
        short = max(3 * self.interval_s, 1.0)
        with self._lock:
            ok_stores = [ent["store"] for ent in self._replicas.values()
                         if ent["ok"]]
            scraped = len(ok_stores)
        qsum = None
        req = None
        for store in ok_stores:
            st = store.gauge_window("serving.queue_depth", short, now)
            # a freshly-scraped replica that never queued anything has
            # no gauge yet — that IS a queue depth of zero, and the
            # fleet series must exist from the first successful scrape
            qsum = (qsum or 0.0) + (st["last"] if st else 0.0)
            r = store.rate("serving.requests", short, now)
            if r is not None:
                req = (req or 0.0) + r
        lat = self.probe().hist_window("serving.request_latency_s",
                                       self.window_s, now)
        shed = self._shed_rate(short, now)
        snap = {"counters": {}, "gauges": {}, "histograms": {}}
        if qsum is not None:
            snap["gauges"]["queue_depth"] = qsum
        if req is not None:
            snap["gauges"]["requests_per_sec"] = req
        if shed is not None:
            snap["gauges"]["shed_per_sec"] = shed
        if lat is not None and lat.get("p99") is not None:
            snap["gauges"]["latency_p99_s"] = lat["p99"]
        snap["gauges"]["replicas_scraped"] = scraped
        self._fleet.append_snapshot(snap, now)
        # export to the registry (Prometheus / metrics CLI view)
        for name, v in snap["gauges"].items():
            monitor.gauge_set(f"fleet.series.{name}", v)

    def probe(self):
        """The fleet-merged view the SLO engine evaluates: fleet.*
        names resolve against the router's own sampled registry,
        everything else merges across the replica stores."""
        return _FleetProbe(self)

    # -- dashboard ----------------------------------------------------------

    def dashboard(self, window_s=None, now=None):
        """The GET /fleet/dashboard payload — the autoscaler contract
        (schema documented in ARCHITECTURE.md "Time-series & SLOs")."""
        w = float(window_s) if window_s else self.window_s
        if now is None:
            now = time.time()
        probe = self.probe()
        stores = self._replica_stores()
        with self._lock:
            scrape_state = {
                rid: {"scrape_ok": ent["ok"],
                      "scrape_error": ent["error"],
                      "scrape_age_s": (round(now - ent["last"], 3)
                                       if ent["last"] else None)}
                for rid, ent in self._replicas.items()}
            deviceprof = {rid: ent["deviceprof"]
                          for rid, ent in self._replicas.items()
                          if ent.get("deviceprof")}
            serving_lm = {rid: ent["serving_lm"]
                          for rid, ent in self._replicas.items()
                          if ent.get("serving_lm")}
        status = self.router.status()
        replicas = []
        for row in status["replicas"]:
            rid = row["replica_id"]
            store = stores.get(rid)
            extra = dict(scrape_state.get(
                rid, {"scrape_ok": False, "scrape_error": "never scraped",
                      "scrape_age_s": None}))
            if store is not None:
                extra["requests_per_sec"] = store.rate(
                    "serving.requests", w, now)
                extra["shed_per_sec"] = store.rate(
                    "serving.deadline_shed", w, now)
            replicas.append({**row, **extra})
        return {
            "schema_version": DASHBOARD_SCHEMA_VERSION,
            "time": now,
            "window_s": w,
            "scrape_interval_s": self.interval_s,
            "scrapes": self.scrapes,
            "series": {
                "queue_depth": {
                    "fleet": self._fleet.series("queue_depth", w, now),
                    "per_replica": {
                        rid: s.series("serving.queue_depth", w, now)
                        for rid, s in stores.items()}},
                "requests_per_sec": {
                    "fleet": self._fleet.series("requests_per_sec",
                                                w, now)},
                "shed_per_sec": {
                    "fleet": self._fleet.series("shed_per_sec", w, now)},
                "latency_p99_s": {
                    "fleet": self._fleet.series("latency_p99_s",
                                                w, now)},
            },
            "window": {
                "queue_depth": probe.gauge_window(
                    "serving.queue_depth", w, now),
                "requests_per_sec": probe.rate("serving.requests",
                                               w, now),
                "shed_per_sec": self._shed_rate(w, now),
                "latency_s": probe.hist_window(
                    "serving.request_latency_s", w, now),
            },
            "slo": self.slo_engine.table(),
            "replicas": replicas,
            # optional (additive, schema stays v1): per-replica sampled
            # device-time attribution — absent unless some replica runs
            # with profile_sample_n>0
            **({"deviceprof": deviceprof} if deviceprof else {}),
            # optional (additive): per-replica generation-engine stats
            # (slots, KV occupancy, TTFT counters) — absent unless some
            # replica is a serve --generate LM replica
            **({"serving_lm": serving_lm} if serving_lm else {}),
            # optional (additive): the autoscaler's own view — absent
            # unless the route process runs with --autoscale
            **({"autoscale":
                self.router.autoscaler.dashboard_section()}
               if getattr(self.router, "autoscaler", None) is not None
               else {}),
        }


class _FleetProbe:
    """SLO-probe adapter over the aggregator: the TimeSeriesStore read
    signatures, resolved fleet-wide."""

    def __init__(self, agg):
        self._agg = agg

    def rate(self, name, window_s=None, now=None, skip_labels=None):
        if name.startswith("fleet."):
            return self._agg._router_store.rate(
                name, window_s, now, skip_labels=skip_labels)
        vals = [s.rate(name, window_s, now, skip_labels=skip_labels)
                for s in self._agg._replica_stores().values()]
        vals = [v for v in vals if v is not None]
        return sum(vals) if vals else None

    def gauge_window(self, name, window_s=None, now=None,
                     skip_labels=None):
        if name.startswith("fleet."):
            return self._agg._router_store.gauge_window(
                name, window_s, now, skip_labels=skip_labels)
        stats = [s.gauge_window(name, window_s, now,
                                skip_labels=skip_labels)
                 for s in self._agg._replica_stores().values()]
        stats = [s for s in stats if s is not None]
        if not stats:
            return None
        # sum = fleet totals (queue depths); max of maxima = fleet peak
        return {"last": sum(s["last"] for s in stats),
                "min": sum(s["min"] for s in stats),
                "max": max(s["max"] for s in stats),
                "mean": sum(s["mean"] for s in stats),
                "n": sum(s["n"] for s in stats)}

    def hist_window(self, name, window_s=None, now=None,
                    skip_labels=None):
        if name.startswith("fleet."):
            return self._agg._router_store.hist_window(
                name, window_s, now, skip_labels=skip_labels)
        from ..monitor import timeseries as _ts
        parts = []
        count = 0
        total_mass = 0.0
        for s in self._agg._replica_stores().values():
            hw = s.hist_window(name, window_s, now,
                               skip_labels=skip_labels)
            if hw is None or not hw.get("count"):
                continue
            parts.append((hw["count"], hw))
            count += hw["count"]
            if hw.get("mean") is not None:
                total_mass += hw["mean"] * hw["count"]
        if not parts:
            return None
        out = {"count": count,
               "mean": total_mass / count if count else None}
        out.update(_ts.merge_quantiles(parts) or {})
        return out


class FleetRouter:
    """Front-tier router + membership registry + health prober. Binds
    its own ThreadingHTTPServer (port=0 = ephemeral; read `.url`)."""

    def __init__(self, config=None, host="127.0.0.1", port=0,
                 supervisor=None, start=True, read_timeout_s=None):
        self.config = config or RouterConfig()
        self.supervisor = supervisor
        # set by the route CLI when --autoscale is on: an
        # AutoscaleController (serving/autoscale.py). GET
        # /fleet/autoscale and the dashboard's `autoscale` section
        # read it; None = manual fleet sizing.
        self.autoscaler = None
        self._lock = threading.Lock()
        self._replicas = {}
        self._seq = 0
        self._rr = 0                      # tie-break rotation
        self._stop = threading.Event()
        self._prober = None
        self._scraper = None
        self.membership_events = []       # (t, event, replica_id)
        self.aggregator = FleetAggregator(
            self, scrape_interval_s=self.config.scrape_interval_s,
            window_s=self.config.dashboard_window_s,
            timeout_s=self.config.probe_timeout_s)
        self._server = QuietHTTPServer((host, port), _RouterHandler)
        self._server.router = self
        if read_timeout_s is None:
            from .. import flags
            read_timeout_s = flags.get("serving_read_timeout_s")
        self._server.read_timeout_s = float(read_timeout_s) or None
        self.host = host
        self.port = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._http_thread = None
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self._http_thread is None:
            self._http_thread = threading.Thread(
                target=self._server.serve_forever,
                name="paddle-tpu-torch-router-http", daemon=True)
            self._http_thread.start()
            self._prober = threading.Thread(
                target=self._probe_loop,
                name="paddle-tpu-torch-router-probe",
                daemon=True)
            self._prober.start()
            # aggregation scrapes run on their OWN thread: a hung
            # replica's /debug/vars fetch (timeout_s of blocking join)
            # must not delay the health prober's down-detection and
            # lease sweeps — the exact moment the prober matters most
            if self.config.scrape_interval_s > 0:
                self._scraper = threading.Thread(
                    target=self._scrape_loop,
                    name="paddle-tpu-torch-router-scrape", daemon=True)
                self._scraper.start()
        return self

    def _scrape_loop(self):
        import sys
        while not self._stop.wait(self.config.scrape_interval_s):
            try:
                self.aggregator.scrape()
            except Exception as e:   # noqa: BLE001 — must survive, but
                # NEVER silently: a persistently-failing scrape means a
                # frozen dashboard and un-evaluated fleet SLOs — say so
                print(f"fleet aggregation scrape failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)

    def shutdown(self):
        self._stop.set()
        if self._http_thread is not None:
            # BaseServer.shutdown() handshakes with serve_forever —
            # calling it on a never-started server would wait forever
            self._server.shutdown()
        self._server.server_close()
        if self._prober is not None:
            self._prober.join(timeout=10)
        if self._scraper is not None:
            self._scraper.join(timeout=10)
        return self

    # -- membership ---------------------------------------------------------

    def _event(self, kind, replica_id):
        self.membership_events.append((time.time(), kind, replica_id))

    def register(self, replica_id, url, ttl_s=None, ready=None,
                 queue_depth=None, free_slots=None):
        """A replica joins (or re-joins after a restart: a new url under
        a known id is a new incarnation — fresh breaker/probe state).
        Re-registering an unchanged member just renews the lease."""
        replica_id = str(replica_id)
        url = str(url)
        if not replica_id or len(replica_id) > 128 \
                or not replica_id.isprintable():
            return {"status": "error", "detail": "bad replica_id"}
        try:
            parts = urlsplit(url)
            port = parts.port     # raises ValueError on a garbage port
        except ValueError:
            parts, port = None, None
        if parts is None or parts.scheme != "http" \
                or not parts.hostname or not port:
            return {"status": "error",
                    "detail": f"url must be http://host:port, got {url!r}"}
        # every field here is network input: conversion failures must be
        # a clean error reply, never a traceback-and-dropped-connection
        try:
            if ttl_s is not None:
                ttl_s = float(ttl_s)
                if not ttl_s > 0 or ttl_s != ttl_s:
                    raise ValueError
            if queue_depth is not None:
                queue_depth = int(queue_depth)
            if free_slots is not None:
                free_slots = int(free_slots)
        except (TypeError, ValueError):
            return {"status": "error",
                    "detail": "ttl_s must be a positive number and "
                              "queue_depth/free_slots integers"}
        with self._lock:
            rep = self._replicas.get(replica_id)
            fresh = rep is None or rep.url != url
            if fresh:
                self._seq += 1
                rep = _Replica(replica_id, url, self._seq)
                self._replicas[replica_id] = rep
                monitor.counter_inc("fleet.registrations")
                self._event("register", replica_id)
            rep.ttl_s = ttl_s
            rep.lease_expires_at = (time.monotonic() + ttl_s
                                    if ttl_s is not None else None)
            rep.draining = False
            rep.probe_fails = 0        # the beat itself proves reach
            if ready is not None:
                rep.ready = bool(ready)
            if queue_depth is not None:
                rep.queue_depth = queue_depth
            if free_slots is not None:
                rep.free_slots = free_slots
        self._update_gauges()
        return {"status": "ok", "fresh": fresh}

    def heartbeat(self, replica_id, ready=None, queue_depth=None,
                  free_slots=None):
        """Lease renewal. Unknown ids (ejected / router restarted) get
        `{"status": "unknown"}` so the registrar falls back to a full
        register (re-register on a lost lease)."""
        try:
            queue_depth = (int(queue_depth) if queue_depth is not None
                           else None)
            free_slots = (int(free_slots) if free_slots is not None
                          else None)
        except (TypeError, ValueError):
            return {"status": "error",
                    "detail": "queue_depth/free_slots must be integers"}
        with self._lock:
            rep = self._replicas.get(str(replica_id))
            if rep is None:
                return {"status": "unknown"}
            if rep.ttl_s is not None:
                rep.lease_expires_at = time.monotonic() + rep.ttl_s
            rep.probe_fails = 0
            if ready is not None:
                rep.ready = bool(ready)
            if queue_depth is not None:
                rep.queue_depth = queue_depth
            if free_slots is not None:
                rep.free_slots = free_slots
        return {"status": "ok"}

    def deregister(self, replica_id):
        """Graceful leave (drain path): NOT an ejection."""
        with self._lock:
            rep = self._replicas.pop(str(replica_id), None)
        if rep is not None:
            monitor.counter_inc("fleet.deregistrations")
            self._event("deregister", rep.replica_id)
        self._update_gauges()
        return {"status": "ok", "known": rep is not None}

    def begin_drain(self, replica_id):
        """Stop routing NEW requests to a replica (rolling swap step 1);
        in-flight hops finish normally. Cleared by its next register."""
        with self._lock:
            rep = self._replicas.get(str(replica_id))
            if rep is not None:
                rep.draining = True
        return {"status": "ok", "known": rep is not None}

    def replica_ready(self, replica_id):
        """Is this member currently routable? (The supervisor's rolling
        swap gates readmission on this.)"""
        now = time.monotonic()
        with self._lock:
            rep = self._replicas.get(str(replica_id))
            return bool(rep is not None and self._routable(rep, now))

    # -- selection / breaker (call with self._lock held) --------------------

    def _routable(self, rep, now):
        if rep.draining or not rep.ready:
            return False
        if rep.lease_expires_at is not None and now > rep.lease_expires_at:
            return False
        if rep.probe_fails >= self.config.probe_down_after:
            return False
        if rep.brk_state == "open":
            if now - rep.brk_opened_at < self.config.breaker_cooldown_s:
                return False
            rep.brk_state = "half_open"      # cooldown over: one trial
            rep.brk_trial = False
        if rep.brk_state == "half_open" and rep.brk_trial:
            return False                     # a trial is already out
        return True

    def _pick(self, tried, lm=False):
        now = time.monotonic()
        with self._lock:
            cands = [r for r in self._replicas.values()
                     if r.replica_id not in tried
                     and self._routable(r, now)]
            if not cands:
                return None
            self._rr += 1
            rr = self._rr
            if lm:
                # slot-aware LM dispatch: a generation occupies a KV
                # slot for its whole lifetime, so the right load signal
                # is free generation slots, not the one-shot queue
                # depth. Prefer the most-free replica; when NO replica
                # reports slots (pre-slot replicas, or all saturated)
                # fall back to least-loaded so requests still flow and
                # the engine's own 429 admission does the shedding.
                slotted = [r for r in cands
                           if r.free_slots is not None
                           and r.free_slots > 0]
                if slotted:
                    slotted.sort(key=lambda r: (
                        -r.free_slots, r.queue_depth + r.inflight,
                        (r.seq + rr) % (self._seq + 1)))
                    rep = slotted[0]
                    # optimistic decrement: concurrent picks between
                    # heartbeats must not all dogpile the same replica
                    rep.free_slots -= 1
                    if rep.brk_state == "half_open":
                        rep.brk_trial = True
                    rep.inflight += 1
                    return rep
            cands.sort(key=lambda r: (r.queue_depth + r.inflight,
                                      (r.seq + rr) % (self._seq + 1)))
            rep = cands[0]
            if rep.brk_state == "half_open":
                rep.brk_trial = True         # consume the single trial
            rep.inflight += 1
            return rep

    def _hop_done(self, rep, failed, served=False):
        with self._lock:
            rep.inflight -= 1
            if failed:
                rep.failed_hops += 1
                if rep.brk_state == "half_open":
                    rep.brk_state = "open"   # trial failed: re-open
                    rep.brk_opened_at = time.monotonic()
                    rep.brk_trial = False
                    monitor.counter_inc("fleet.breaker_opens")
                else:
                    rep.brk_fails += 1
                    if (rep.brk_state == "closed"
                            and rep.brk_fails
                            >= self.config.breaker_threshold):
                        rep.brk_state = "open"
                        rep.brk_opened_at = time.monotonic()
                        monitor.counter_inc("fleet.breaker_opens")
            else:
                if served:        # a real 200, not a 429/4xx answer
                    rep.served += 1
                rep.brk_fails = 0
                rep.brk_trial = False
                # only a HALF-OPEN trial closes the breaker: a success
                # that lands while open (an in-flight hop admitted
                # before the open) is not evidence the partition healed,
                # and closing on it would let the same window re-open
                # the breaker — miscounting recovery
                if rep.brk_state == "half_open":
                    rep.brk_state = "closed"
                    monitor.counter_inc("fleet.breaker_closes")

    # -- routing ------------------------------------------------------------

    def _typed(self, status, error_type, msg, trace_id, attempts):
        body = {"error": msg, "error_type": error_type,
                "trace_id": trace_id}
        headers = {"x-fleet-attempts": str(attempts)}
        if status in (429, 503):
            headers["Retry-After"] = str(self.config.retry_after_s)
        counter = {429: "fleet.shed", 503: "fleet.unavailable",
                   504: "fleet.deadline_exceeded"}[status]
        monitor.counter_inc(counter)
        return _RouteReply(status, json.dumps(body).encode(),
                           headers=headers)

    def _forward(self, rep, body, trace_id, timeout):
        """One hop. The `fleet_forward` fault site fires BEFORE the
        connection opens: an injected PartitionFault models the router
        losing the network to its replicas."""
        faults.fire("fleet_forward")
        parts = urlsplit(rep.url)
        conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                          timeout=timeout)
        try:
            conn.request("POST", "/v1/infer", body=body,
                         headers={"Content-Type": "application/json",
                                  "x-trace-id": trace_id})
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, data, (resp.getheader("Content-Type")
                                       or "application/json")
        finally:
            conn.close()

    def route(self, body_bytes, inbound_trace_id=None):
        """Route one /v1/infer body: pick the least-loaded routable
        replica, fail over on transport/5xx failures within the retry
        budget and the client's remaining deadline, shed typed when the
        fleet can't take the request. Returns a _RouteReply."""
        trace_id = resolve_trace_id(inbound_trace_id)
        monitor.counter_inc("fleet.requests")
        arrived = time.monotonic()
        try:
            req = json.loads(body_bytes)
            if not isinstance(req, dict):
                req = None
        except (ValueError, UnicodeDecodeError):
            req = None       # the replica will answer the 400
        deadline_at = None
        if req is not None and req.get("deadline_ms") is not None:
            try:
                deadline_at = arrived + float(req["deadline_ms"]) / 1e3
            except (TypeError, ValueError):
                deadline_at = None
        root = monitor.start_span("fleet/route", trace_id=trace_id)
        tried = set()
        attempts = 0
        transport_failures = 0
        replica_5xx = 0
        saw_saturated = False
        last_5xx = None
        try:
            while attempts <= self.config.retry_budget:
                now = time.monotonic()
                if deadline_at is not None and now >= deadline_at:
                    return self._typed(
                        504, "deadline",
                        "deadline exceeded while routing "
                        f"(after {attempts} attempts)", trace_id,
                        attempts)
                rep = self._pick(tried)
                if rep is None:
                    break
                tried.add(rep.replica_id)
                attempts += 1
                monitor.counter_inc("fleet.hops")
                if attempts > 1:
                    monitor.counter_inc("fleet.retries")
                hop_body = body_bytes
                timeout = self.config.forward_timeout_s
                if deadline_at is not None:
                    remaining = deadline_at - now
                    timeout = min(timeout, remaining + 1.0)
                    if req is not None:
                        # the hop gets only the REMAINING budget: a
                        # failed-over request must not restart its clock
                        hop_body = json.dumps(
                            {**req, "deadline_ms":
                             max(1.0, remaining * 1e3)}).encode()
                hop_span = monitor.start_span(
                    "fleet/hop", parent=root, trace_id=trace_id,
                    attrs={"replica": rep.replica_id,
                           "attempt": attempts, "url": rep.url})
                t0 = time.perf_counter()
                try:
                    status, data, ctype = self._forward(
                        rep, hop_body, trace_id, timeout)
                except BaseException as e:   # noqa: BLE001 — any failure
                    # to complete the hop (refused/reset/timeout,
                    # injected PartitionFault, protocol garbage) is a
                    # hop failure. BaseException so an injected
                    # SimulatedCrash still settles the hop accounting
                    # (inflight, half-open trial) before unwinding —
                    # otherwise the replica would look loaded (or keep
                    # an un-returnable trial token) forever.
                    transport_failures += 1
                    self._hop_done(rep, failed=True)
                    _finish(hop_span, error=e)
                    monitor.histogram_observe("fleet.hop_latency_s",
                                              time.perf_counter() - t0)
                    if not isinstance(e, Exception):
                        raise         # crash faults unwind as designed
                    continue
                monitor.histogram_observe("fleet.hop_latency_s",
                                          time.perf_counter() - t0)
                if status == 200:
                    self._hop_done(rep, failed=False, served=True)
                    _finish(hop_span)
                    if transport_failures or replica_5xx:
                        monitor.counter_inc("fleet.failovers")
                    return _RouteReply(
                        200, data, content_type=ctype,
                        headers={"x-served-by": rep.replica_id,
                                 "x-fleet-attempts": str(attempts)})
                if status == 429:
                    # healthy-but-saturated: not a breaker failure
                    saw_saturated = True
                    self._hop_done(rep, failed=False)
                    _finish(hop_span)
                    continue
                if status == 504:
                    # the replica shed on deadline: the budget is
                    # global, a peer cannot beat the same clock
                    self._hop_done(rep, failed=False)
                    _finish(hop_span)
                    monitor.counter_inc("fleet.deadline_exceeded")
                    return _RouteReply(
                        504, data, content_type=ctype,
                        headers={"x-served-by": rep.replica_id,
                                 "x-fleet-attempts": str(attempts)})
                if 400 <= status < 500:
                    # the CLIENT's fault: relay verbatim, never retried
                    self._hop_done(rep, failed=False)
                    _finish(hop_span)
                    return _RouteReply(
                        status, data, content_type=ctype,
                        headers={"x-served-by": rep.replica_id,
                                 "x-fleet-attempts": str(attempts)})
                # 5xx: breaker failure; idempotent, retry on a peer
                replica_5xx += 1
                last_5xx = (status, data, ctype, rep.replica_id)
                self._hop_done(rep, failed=True)
                _finish(hop_span,
                        error=RuntimeError(f"replica {rep.replica_id} "
                                           f"answered {status}"))
            # budget / candidates exhausted
            if deadline_at is not None and time.monotonic() >= deadline_at:
                return self._typed(504, "deadline",
                                   "deadline exceeded while routing "
                                   f"(after {attempts} attempts)",
                                   trace_id, attempts)
            if last_5xx is not None and transport_failures == 0:
                # every hop REACHED a replica and each answered 5xx: a
                # consistent model/batch failure must surface raw
                status, data, ctype, rid = last_5xx
                return _RouteReply(
                    status, data, content_type=ctype,
                    headers={"x-served-by": rid,
                             "x-fleet-attempts": str(attempts)})
            if saw_saturated and not transport_failures and not replica_5xx:
                return self._typed(
                    429, "shed",
                    "every routable replica is saturated "
                    f"(tried {attempts})", trace_id, attempts)
            return self._typed(
                503, "unavailable",
                "no routable replica could take the request "
                f"(tried {attempts}, "
                f"{transport_failures} transport failures)",
                trace_id, attempts)
        finally:
            if root is not None:
                root.set_attr("attempts", attempts)
            _finish(root)

    def route_generate(self, body_bytes, handler, inbound_trace_id=None):
        """Route one streaming /v1/generate body: slot-aware pick (the
        replica with free generation slots, falling back to
        least-loaded), then relay the replica's chunked token stream to
        the client as it arrives. Failover is allowed only BEFORE the
        upstream stream opens — once tokens have flowed, a replica
        failure surfaces as an in-band error event (a generation is not
        idempotent mid-stream). Returns a _RouteReply for buffered
        outcomes (errors, sheds) or None when the stream was already
        written to `handler`."""
        trace_id = resolve_trace_id(inbound_trace_id)
        monitor.counter_inc("fleet.requests")
        arrived = time.monotonic()
        try:
            req = json.loads(body_bytes)
            if not isinstance(req, dict):
                req = None
        except (ValueError, UnicodeDecodeError):
            req = None       # the replica will answer the 400
        deadline_at = None
        if req is not None and req.get("deadline_ms") is not None:
            try:
                deadline_at = arrived + float(req["deadline_ms"]) / 1e3
            except (TypeError, ValueError):
                deadline_at = None
        root = monitor.start_span("fleet/route_generate",
                                  trace_id=trace_id)
        tried = set()
        attempts = 0
        transport_failures = 0
        replica_5xx = 0
        saw_saturated = False
        last_5xx = None
        try:
            while attempts <= self.config.retry_budget:
                now = time.monotonic()
                if deadline_at is not None and now >= deadline_at:
                    return self._typed(
                        504, "deadline",
                        "deadline exceeded while routing "
                        f"(after {attempts} attempts)", trace_id,
                        attempts)
                rep = self._pick(tried, lm=True)
                if rep is None:
                    break
                tried.add(rep.replica_id)
                attempts += 1
                monitor.counter_inc("fleet.hops")
                if attempts > 1:
                    monitor.counter_inc("fleet.retries")
                hop_body = body_bytes
                timeout = self.config.forward_timeout_s
                if deadline_at is not None:
                    remaining = deadline_at - now
                    timeout = min(timeout, remaining + 1.0)
                    if req is not None:
                        hop_body = json.dumps(
                            {**req, "deadline_ms":
                             max(1.0, remaining * 1e3)}).encode()
                hop_span = monitor.start_span(
                    "fleet/hop", parent=root, trace_id=trace_id,
                    attrs={"replica": rep.replica_id,
                           "attempt": attempts, "url": rep.url})
                t0 = time.perf_counter()
                faults.fire("fleet_forward")
                parts = urlsplit(rep.url)
                conn = http.client.HTTPConnection(
                    parts.hostname, parts.port, timeout=timeout)
                try:
                    conn.request(
                        "POST", "/v1/generate", body=hop_body,
                        headers={"Content-Type": "application/json",
                                 "x-trace-id": trace_id})
                    resp = conn.getresponse()
                except BaseException as e:   # noqa: BLE001 — as in
                    # route(): any failure before the status line is a
                    # retryable hop failure; BaseException so injected
                    # crash faults still settle the hop accounting
                    conn.close()
                    transport_failures += 1
                    self._hop_done(rep, failed=True)
                    _finish(hop_span, error=e)
                    monitor.histogram_observe(
                        "fleet.hop_latency_s", time.perf_counter() - t0)
                    if not isinstance(e, Exception):
                        raise
                    continue
                status = resp.status
                ctype = resp.getheader("Content-Type") \
                    or "application/json"
                if status == 200 and resp.getheader("Content-Length") \
                        is None:
                    # the token stream: relay chunk-by-chunk
                    monitor.histogram_observe(
                        "fleet.hop_latency_s", time.perf_counter() - t0)
                    return self._relay_stream(
                        rep, conn, resp, handler, hop_span, ctype,
                        trace_id, attempts,
                        transport_failures or replica_5xx)
                # buffered reply: same taxonomy as route()
                try:
                    data = resp.read()
                except (OSError, http.client.HTTPException) as e:
                    conn.close()
                    transport_failures += 1
                    self._hop_done(rep, failed=True)
                    _finish(hop_span, error=e)
                    monitor.histogram_observe(
                        "fleet.hop_latency_s", time.perf_counter() - t0)
                    continue
                conn.close()
                monitor.histogram_observe("fleet.hop_latency_s",
                                          time.perf_counter() - t0)
                if status == 200:
                    self._hop_done(rep, failed=False, served=True)
                    _finish(hop_span)
                    if transport_failures or replica_5xx:
                        monitor.counter_inc("fleet.failovers")
                    return _RouteReply(
                        200, data, content_type=ctype,
                        headers={"x-served-by": rep.replica_id,
                                 "x-fleet-attempts": str(attempts)})
                if status == 429:
                    saw_saturated = True
                    self._hop_done(rep, failed=False)
                    _finish(hop_span)
                    continue
                if status == 504:
                    self._hop_done(rep, failed=False)
                    _finish(hop_span)
                    monitor.counter_inc("fleet.deadline_exceeded")
                    return _RouteReply(
                        504, data, content_type=ctype,
                        headers={"x-served-by": rep.replica_id,
                                 "x-fleet-attempts": str(attempts)})
                if 400 <= status < 500:
                    self._hop_done(rep, failed=False)
                    _finish(hop_span)
                    return _RouteReply(
                        status, data, content_type=ctype,
                        headers={"x-served-by": rep.replica_id,
                                 "x-fleet-attempts": str(attempts)})
                replica_5xx += 1
                last_5xx = (status, data, ctype, rep.replica_id)
                self._hop_done(rep, failed=True)
                _finish(hop_span,
                        error=RuntimeError(f"replica {rep.replica_id} "
                                           f"answered {status}"))
            if deadline_at is not None \
                    and time.monotonic() >= deadline_at:
                return self._typed(504, "deadline",
                                   "deadline exceeded while routing "
                                   f"(after {attempts} attempts)",
                                   trace_id, attempts)
            if last_5xx is not None and transport_failures == 0:
                status, data, ctype, rid = last_5xx
                return _RouteReply(
                    status, data, content_type=ctype,
                    headers={"x-served-by": rid,
                             "x-fleet-attempts": str(attempts)})
            if saw_saturated and not transport_failures \
                    and not replica_5xx:
                return self._typed(
                    429, "shed",
                    "every routable replica is saturated "
                    f"(tried {attempts})", trace_id, attempts)
            return self._typed(
                503, "unavailable",
                "no routable replica could take the request "
                f"(tried {attempts}, "
                f"{transport_failures} transport failures)",
                trace_id, attempts)
        finally:
            if root is not None:
                root.set_attr("attempts", attempts)
            _finish(root)

    def _relay_stream(self, rep, conn, resp, handler, hop_span, ctype,
                      trace_id, attempts, failed_over):
        """Relay an open upstream token stream to the client handler as
        chunked transfer, one newline-delimited event per chunk. Always
        returns None (the reply is written here)."""
        streamed = False
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", ctype)
            handler.send_header("Transfer-Encoding", "chunked")
            handler.send_header("x-served-by", rep.replica_id)
            handler.send_header("x-fleet-attempts", str(attempts))
            handler.send_header("x-trace-id", trace_id)
            handler.end_headers()
            while True:
                try:
                    line = resp.readline()
                except (OSError, ValueError,
                        http.client.HTTPException):
                    # upstream died MID-stream: the generation is not
                    # idempotent, so no failover — surface an in-band
                    # error event and end the stream cleanly
                    err = json.dumps(
                        {"event": "error",
                         "error": "replica lost mid-stream",
                         "error_type": "unavailable",
                         "trace_id": trace_id}).encode() + b"\n"
                    handler.wfile.write(
                        f"{len(err):X}\r\n".encode() + err + b"\r\n")
                    handler.wfile.write(b"0\r\n\r\n")
                    conn.close()
                    self._hop_done(rep, failed=True)
                    _finish(hop_span,
                            error=RuntimeError("upstream lost"))
                    monitor.counter_inc("fleet.stream_upstream_errors")
                    return None
                if not line:
                    break
                streamed = True
                handler.wfile.write(
                    f"{len(line):X}\r\n".encode() + line + b"\r\n")
                handler.wfile.flush()
            handler.wfile.write(b"0\r\n\r\n")
        except (ConnectionError, TimeoutError, OSError) as e:
            # the CLIENT went away: close the upstream connection so
            # the replica sees the broken pipe and cancels the
            # generation at the next decode-step boundary (freeing its
            # KV slot), and drop this client connection
            handler.close_connection = True
            conn.close()
            self._hop_done(rep, failed=False)
            _finish(hop_span, error=e)
            monitor.counter_inc("fleet.client_disconnects")
            return None
        self._hop_done(rep, failed=False, served=True)
        _finish(hop_span)
        if failed_over:
            monitor.counter_inc("fleet.failovers")
        if streamed:
            monitor.counter_inc("fleet.streams")
        conn.close()
        return None

    # -- probing / lease sweep ----------------------------------------------

    def _probe_loop(self):
        while not self._stop.wait(self.config.probe_interval_s):
            try:
                self._sweep_leases()
                # probe CONCURRENTLY: one blackholed replica must not
                # stall lease sweeps and readiness updates for the whole
                # fleet by probe_timeout_s per dead member
                threads = [threading.Thread(target=self._probe,
                                            args=(rep,), daemon=True)
                           for rep in self._snapshot_replicas()]
                for t in threads:
                    t.start()
                deadline = time.monotonic() + \
                    self.config.probe_timeout_s + 1.0
                for t in threads:
                    t.join(timeout=max(0.0,
                                       deadline - time.monotonic()))
                self._update_gauges()
            except Exception:   # noqa: BLE001 — the prober must survive
                pass

    def _snapshot_replicas(self):
        with self._lock:
            return list(self._replicas.values())

    def _sweep_leases(self):
        now = time.monotonic()
        expired = []
        with self._lock:
            for rid, rep in list(self._replicas.items()):
                if (rep.lease_expires_at is not None
                        and now > rep.lease_expires_at):
                    del self._replicas[rid]
                    expired.append(rid)
        for rid in expired:
            monitor.counter_inc("fleet.ejections")
            self._event("eject", rid)

    def _probe(self, rep):
        """Readiness probe: any HTTP answer proves liveness; only a 200
        (status "ready") makes the replica routable. Transport failure
        counts toward probe_down_after."""
        try:
            faults.fire("fleet_probe")
            parts = urlsplit(rep.url)
            conn = http.client.HTTPConnection(
                parts.hostname, parts.port,
                timeout=self.config.probe_timeout_s)
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                payload = {}
                try:
                    payload = json.loads(resp.read())
                except ValueError:
                    pass
                with self._lock:
                    if self._replicas.get(rep.replica_id) is rep:
                        rep.probe_fails = 0
                        rep.ready = resp.status == 200
                        if isinstance(payload.get("queue_depth"), int):
                            rep.queue_depth = payload["queue_depth"]
                        if isinstance(payload.get("free_slots"), int):
                            rep.free_slots = payload["free_slots"]
            finally:
                conn.close()
        except (OSError, http.client.HTTPException):
            with self._lock:
                if self._replicas.get(rep.replica_id) is rep:
                    rep.probe_fails += 1

    def _update_gauges(self):
        if not monitor.enabled():
            return
        now = time.monotonic()
        with self._lock:
            live = len(self._replicas)
            ready = sum(1 for r in self._replicas.values()
                        if self._routable(r, now))
        monitor.gauge_set("fleet.live_replicas", live)
        monitor.gauge_set("fleet.ready_replicas", ready)

    # -- introspection ------------------------------------------------------

    def status(self):
        now = time.monotonic()
        with self._lock:
            reps = []
            for rep in self._replicas.values():
                reps.append({
                    "replica_id": rep.replica_id, "url": rep.url,
                    "ready": rep.ready, "draining": rep.draining,
                    "routable": self._routable(rep, now),
                    "queue_depth": rep.queue_depth,
                    "free_slots": rep.free_slots,
                    "inflight": rep.inflight,
                    "probe_fails": rep.probe_fails,
                    "lease_remaining_s": (
                        None if rep.lease_expires_at is None
                        else round(rep.lease_expires_at - now, 3)),
                    "breaker": {"state": rep.brk_state,
                                "consecutive_failures": rep.brk_fails},
                    "served": rep.served,
                    "failed_hops": rep.failed_hops,
                })
        return {"url": self.url, "replicas": reps,
                "routable": sum(1 for r in reps if r["routable"]),
                "retry_budget": self.config.retry_budget,
                "breaker_threshold": self.config.breaker_threshold,
                "breaker_cooldown_s": self.config.breaker_cooldown_s}


class _RouterHandler(TimeoutAwareHandler):
    # HTTP/1.1 + quiet logging + read-timeout wiring inherited from
    # the shared serving handler base (http.py)

    def _reply(self, code, payload, content_type="application/json",
               headers=None):
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):   # noqa: N802
        router = self.server.router
        path = self.path.partition("?")[0]
        if path == "/healthz":
            st = router.status()
            self._reply(200, {"status": ("ready" if st["routable"]
                                         else "empty"),
                              "routable": st["routable"],
                              "replicas": len(st["replicas"])})
        elif path == "/fleet/status":
            self._reply(200, router.status())
        elif path == "/fleet/autoscale":
            ctl = getattr(router, "autoscaler", None)
            self._reply(200, {"enabled": False} if ctl is None
                        else ctl.status())
        elif path == "/fleet/dashboard":
            from urllib.parse import parse_qs
            q = parse_qs(self.path.partition("?")[2])
            try:
                window = float(q["window"][0]) if "window" in q else None
                if window is not None and not window > 0:
                    raise ValueError
            except (ValueError, TypeError):
                self._reply(400, {"error": "window must be a positive "
                                           "number of seconds"})
                return
            self._reply(200, router.aggregator.dashboard(
                window_s=window))
        elif path == "/metrics":
            snap = monitor.snapshot()
            if "format=json" in self.path:
                self._reply(200, snap)
            else:
                self._reply(200, monitor.format_prometheus(snap).encode(),
                            content_type="text/plain; version=0.0.4")
        else:
            self._reply(404, {"error": f"no route {path!r}"})

    def do_POST(self):   # noqa: N802
        router = self.server.router
        path = self.path.partition("?")[0]
        if path == "/v1/infer":
            trace_id = resolve_trace_id(self.headers.get("x-trace-id"))
            try:
                body = self._read_body(_MAX_BODY)
            except TimeoutError:
                self.close_connection = True
                self._reply(408, {"error": "timed out reading the "
                                           "request body",
                                  "error_type": "timeout",
                                  "trace_id": trace_id})
                return
            except ValueError as e:
                self._reply(400, {"error": f"bad request: {e}",
                                  "trace_id": trace_id})
                return
            reply = router.route(body, inbound_trace_id=trace_id)
            self._reply(reply.status, reply.body,
                        content_type=reply.content_type,
                        headers={**reply.headers, "x-trace-id": trace_id})
            return
        if path == "/v1/generate":
            trace_id = resolve_trace_id(self.headers.get("x-trace-id"))
            try:
                body = self._read_body(_MAX_BODY)
            except TimeoutError:
                self.close_connection = True
                self._reply(408, {"error": "timed out reading the "
                                           "request body",
                                  "error_type": "timeout",
                                  "trace_id": trace_id})
                return
            except ValueError as e:
                self._reply(400, {"error": f"bad request: {e}",
                                  "trace_id": trace_id})
                return
            reply = router.route_generate(body, self,
                                          inbound_trace_id=trace_id)
            if reply is not None:   # buffered outcome (stream already
                self._reply(reply.status, reply.body,   # written else)
                            content_type=reply.content_type,
                            headers={**reply.headers,
                                     "x-trace-id": trace_id})
            return
        if path in ("/fleet/register", "/fleet/heartbeat",
                    "/fleet/deregister", "/fleet/drain", "/fleet/swap"):
            try:
                raw = self._read_body(_MAX_CONTROL_BODY)
            except TimeoutError:
                # mid-body stall: the half-read body can't be resynced,
                # so the connection must close with the 408 (leaving it
                # open would parse the leftover bytes as the next
                # request on this keep-alive stream)
                self.close_connection = True
                self._reply(408, {"error": "timed out reading the "
                                           "request body",
                                  "error_type": "timeout"})
                return
            except ValueError as e:   # bad length: body unread, closed
                self._reply(400, {"error": f"bad request: {e}"})
                return
            try:
                req = json.loads(raw)
                if not isinstance(req, dict):
                    raise ValueError("control payload must be an object")
            except ValueError as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            if path == "/fleet/register":
                out = router.register(req.get("replica_id"),
                                      req.get("url"),
                                      ttl_s=req.get("ttl_s"),
                                      ready=req.get("ready"),
                                      queue_depth=req.get("queue_depth"),
                                      free_slots=req.get("free_slots"))
            elif path == "/fleet/heartbeat":
                out = router.heartbeat(req.get("replica_id"),
                                       ready=req.get("ready"),
                                       queue_depth=req.get("queue_depth"),
                                       free_slots=req.get("free_slots"))
            elif path == "/fleet/deregister":
                out = router.deregister(req.get("replica_id"))
            elif path == "/fleet/drain":
                out = router.begin_drain(req.get("replica_id"))
            else:   # /fleet/swap
                if router.supervisor is None:
                    self._reply(409, {"error": "no supervisor attached "
                                               "(router-only mode)"})
                    return
                artifact = req.get("artifact")
                threading.Thread(
                    target=router.supervisor.rolling_swap,
                    kwargs={"artifact": artifact},
                    name="paddle-tpu-torch-rolling-swap",
                    daemon=True).start()
                out = {"status": "started", "artifact": artifact}
            code = 200 if out.get("status") in ("ok", "started",
                                                "unknown") else 400
            self._reply(code, out)
            return
        self.close_connection = True
        self._reply(404, {"error": f"no route {path!r}"})


# ---------------------------------------------------------------------------
# replica-side lease agent (the serve CLI runs one when --fleet is set)
# ---------------------------------------------------------------------------

class FleetRegistrar:
    """Registers this replica with a FleetRouter and keeps the lease
    alive: heartbeat every ttl/3 carrying ready + queue_depth. An
    `unknown` heartbeat answer (ejected, or the router restarted)
    triggers a full re-register. `stop(deregister=True)` is the drain
    handshake: the router stops routing BEFORE the engine drains."""

    def __init__(self, router_url, replica_id, my_url, engine,
                 ttl_s=5.0, interval_s=None):
        try:
            parts = urlsplit(router_url)
            port = parts.port     # raises ValueError on a garbage port
        except ValueError:
            parts, port = None, None
        if parts is None or parts.scheme != "http" \
                or not parts.hostname or not port:
            raise ValueError("--fleet must be http://host:port, got "
                             f"{router_url!r}")
        self._host, self._port = parts.hostname, port
        self.replica_id = str(replica_id)
        self.my_url = my_url
        self.engine = engine
        self.ttl_s = float(ttl_s)
        self._interval = float(interval_s) if interval_s else \
            max(0.2, self.ttl_s / 3.0)
        self._stop = threading.Event()
        self._thread = None
        self.registered = False

    def _post(self, path, payload):
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=3.0)
        try:
            conn.request("POST", path, body=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return json.loads(resp.read())
        finally:
            conn.close()

    def _payload(self):
        stats = self.engine.stats()
        payload = {"replica_id": self.replica_id, "url": self.my_url,
                   "ttl_s": self.ttl_s,
                   "ready": stats.get("ready", True),
                   "queue_depth": stats.get("queue_depth", 0)}
        # LM replicas advertise generation-slot availability so the
        # router's /v1/generate dispatch is slot-aware
        if stats.get("free_slots") is not None:
            payload["free_slots"] = stats["free_slots"]
        return payload

    def _beat(self):
        payload = self._payload()
        try:
            if not self.registered:
                out = self._post("/fleet/register", payload)
                self.registered = out.get("status") == "ok"
                return
            out = self._post("/fleet/heartbeat",
                             {k: payload[k] for k in
                              ("replica_id", "ready", "queue_depth",
                               "free_slots") if k in payload})
            if out.get("status") == "unknown":
                self.registered = False     # re-register next round
                self._beat()
        except (OSError, ValueError, http.client.HTTPException):
            pass    # router briefly away: the next beat retries

    def start(self):
        if self._thread is None:
            self._beat()     # register before traffic, best-effort
            self._thread = threading.Thread(
                target=self._loop,
                name="paddle-tpu-torch-fleet-registrar",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self._interval):
            self._beat()

    def notify(self):
        """Push the current ready/queue state now (e.g. right after
        warmup completes) instead of waiting for the next beat."""
        self._beat()

    def stop(self, deregister=True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if deregister:
            try:
                self._post("/fleet/deregister",
                           {"replica_id": self.replica_id})
            except (OSError, ValueError, http.client.HTTPException):
                pass


# ---------------------------------------------------------------------------
# replica supervisor: spawn / restart / rolling swap
# ---------------------------------------------------------------------------

class ReplicaSupervisor:
    """Spawns N `python -m paddle_tpu_torch serve --fleet ...` replica
    subprocesses and keeps the fleet at strength. `artifact` is what the
    replicas serve: an artifact file (`--artifact`) or a
    `save_inference_model` directory (`--model_dir`), picked by
    `os.path.isdir`; the same holds for `rolling_swap(artifact=...)` and
    `add_slot(artifact=...)`.


      * a replica that EXITS unexpectedly (SIGKILL, crash) is respawned
        under an exponential-backoff restart budget; each respawn
        counts fleet.restarts, and a replica that keeps dying is given
        up on after max_consecutive_restarts (fleet.replica_giveups).
      * `rolling_swap(artifact=...)` replaces replicas one at a time
        with the engine's drain semantics: router drain mark -> SIGTERM
        (deregister + drain + exit 0) -> respawn on the new artifact ->
        wait until the router readmits it as ready -> next. Counts
        fleet.swaps per replaced replica.
    """

    def __init__(self, router, artifact, n_replicas, host="127.0.0.1",
                 ttl_s=3.0, replica_args=(), env=None, log_dir=None,
                 python=None,
                 restart_backoff_base_s=0.5, restart_backoff_max_s=10.0,
                 max_consecutive_restarts=5, poll_interval_s=0.15,
                 drain_timeout_s=60.0, ready_timeout_s=180.0):
        self.router = router
        self.artifact = artifact
        self.host = host
        self.ttl_s = float(ttl_s)
        self.replica_args = list(replica_args)
        # no compilation cache to share: the kernels build once into
        # build/paddle_tpu_torch/ (safe across processes) and each
        # replica captures its rung graphs in its own warmup
        self.env = dict(env) if env is not None else dict(os.environ)
        # replicas must import paddle_tpu_torch: make sure the package
        # root is importable even when the supervisor runs from elsewhere
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        path = self.env.get("PYTHONPATH", "")
        if pkg_root not in path.split(os.pathsep):
            self.env["PYTHONPATH"] = (pkg_root + os.pathsep + path
                                      if path else pkg_root)
        self.log_dir = log_dir
        self.python = python or sys.executable
        self.restart_backoff_base_s = float(restart_backoff_base_s)
        self.restart_backoff_max_s = float(restart_backoff_max_s)
        self.max_consecutive_restarts = int(max_consecutive_restarts)
        self.poll_interval_s = float(poll_interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.ready_timeout_s = float(ready_timeout_s)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread = None
        self.slots = [{"rid": f"replica-{i}", "proc": None,
                       "artifact": artifact, "consecutive": 0,
                       "next_spawn_at": 0.0, "swapping": False,
                       "given_up": False, "spawned_at": 0.0}
                      for i in range(int(n_replicas))]
        # monotonic rid minting for autoscale add_slot(): a drained-
        # away replica's id is never reused, so a stale lease can't be
        # confused with its successor
        self._next_idx = int(n_replicas)

    # -- spawning -----------------------------------------------------------

    def _argv(self, slot):
        source = str(slot["artifact"])
        flag = "--model_dir" if os.path.isdir(source) else "--artifact"
        return [self.python, "-m", "paddle_tpu_torch", "serve",
                f"{flag}={source}", "--port=0",
                f"--host={self.host}", f"--fleet={self.router.url}",
                f"--replica_id={slot['rid']}",
                f"--fleet_ttl={self.ttl_s}", *self.replica_args]

    def _spawn(self, slot):
        out = subprocess.DEVNULL
        if self.log_dir:
            out = open(os.path.join(self.log_dir,
                                    f"{slot['rid']}.log"), "ab")
        slot["proc"] = subprocess.Popen(
            self._argv(slot), env=self.env, stdout=out,
            stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL)
        if out is not subprocess.DEVNULL:
            out.close()      # the child holds its own fd now
        slot["spawned_at"] = time.monotonic()

    def start(self):
        if self._thread is None:
            for slot in self.slots:
                self._spawn(slot)
            self._thread = threading.Thread(
                target=self._loop,
                name="paddle-tpu-torch-replica-supervisor",
                daemon=True)
            self._thread.start()
        return self

    def procs(self):
        """rid -> live Popen (the chaos drill's SIGKILL target)."""
        with self._lock:
            return {s["rid"]: s["proc"] for s in self.slots
                    if s["proc"] is not None}

    def live_slots(self):
        """Count of slots still being supervised (not given up) — the
        autoscaler's notion of current fleet size: a given-up replica
        is dead capacity and does NOT count toward min_replicas."""
        with self._lock:
            return sum(1 for s in self.slots if not s["given_up"])

    # -- elastic slots (autoscaler actuation) -------------------------------

    def add_slot(self, artifact=None):
        """Grow the fleet by one replica slot (autoscale scale-up or
        giveup backfill). Returns {"rid": ...}."""
        with self._lock:
            rid = f"replica-{self._next_idx}"
            self._next_idx += 1
            slot = {"rid": rid, "proc": None,
                    "artifact": artifact or self.artifact,
                    "consecutive": 0, "next_spawn_at": 0.0,
                    "swapping": False, "given_up": False,
                    "spawned_at": 0.0}
            self._spawn(slot)
            self.slots.append(slot)
        monitor.counter_inc("fleet.slots_added")
        return {"rid": rid}

    def remove_slot(self, rid=None):
        """Shrink the fleet by one replica via the drain handshake
        (router drain-mark -> SIGTERM -> the replica deregisters FIRST,
        drains admitted in-flight work, exits 0). Victim is the
        newest live slot unless `rid` names one. Returns a report;
        {"removed": False} when no slot can be removed."""
        with self._lock:
            cands = [s for s in self.slots
                     if not s["swapping"] and not s["given_up"]
                     and s["proc"] is not None
                     and s["proc"].poll() is None]
            if rid is not None:
                cands = [s for s in cands if s["rid"] == rid]
            if not cands:
                return {"removed": False, "reason": "no removable slot"}
            slot = cands[-1]          # LIFO: newest capacity goes first
            slot["swapping"] = True   # restart loop must not respawn it
            proc = slot["proc"]
        t0 = time.monotonic()
        self.router.begin_drain(slot["rid"])
        proc.terminate()         # serve: deregister, drain, exit 0
        drained = True
        try:
            proc.wait(timeout=self.drain_timeout_s)
        except subprocess.TimeoutExpired:
            drained = False
            proc.kill()
            proc.wait(timeout=10)
        # the replica deregisters itself on the drain path; this is the
        # idempotent backstop for one that died too hard to say goodbye
        self.router.deregister(slot["rid"])
        with self._lock:
            if slot in self.slots:
                self.slots.remove(slot)
        monitor.counter_inc("fleet.slots_removed")
        return {"removed": True, "rid": slot["rid"], "drained": drained,
                "exit_code": proc.returncode,
                "drain_s": round(time.monotonic() - t0, 3)}

    # -- crash-restart loop -------------------------------------------------

    def _loop(self):
        while not self._stop.wait(self.poll_interval_s):
            now = time.monotonic()
            # snapshot: add_slot/remove_slot mutate self.slots
            # concurrently with this sweep
            for slot in list(self.slots):
                with self._lock:
                    if (slot["swapping"] or slot["given_up"]
                            or slot["proc"] is None
                            or slot not in self.slots):
                        continue
                    rc = slot["proc"].poll()
                    if rc is None:
                        # stable + readmitted: forgive past crashes
                        if (slot["consecutive"]
                                and now - slot["spawned_at"] > 5.0
                                and self.router.replica_ready(
                                    slot["rid"])):
                            slot["consecutive"] = 0
                        continue
                    # unexpected exit: schedule a backoff respawn
                    if slot["next_spawn_at"] <= slot["spawned_at"]:
                        slot["consecutive"] += 1
                        if (slot["consecutive"]
                                > self.max_consecutive_restarts):
                            slot["given_up"] = True
                            self._giveup(slot, rc)
                            continue
                        backoff = min(
                            self.restart_backoff_max_s,
                            self.restart_backoff_base_s
                            * (2 ** (slot["consecutive"] - 1)))
                        slot["next_spawn_at"] = now + backoff
                    if now >= slot["next_spawn_at"]:
                        self._spawn(slot)
                        monitor.counter_inc("fleet.restarts")

    def _giveup(self, slot, exit_code):
        """A replica exhausted its restart budget. Give up LOUDLY: the
        fleet just lost capacity permanently and silence here means an
        undersized fleet nobody notices — flight-recorder event, one
        blackbox bundle, and a per-replica gauge the SLO engine can
        alert on. The autoscaler backfills the slot (a given-up replica
        does not count toward min_replicas)."""
        monitor.counter_inc("fleet.replica_giveups")
        monitor.gauge_set(f"fleet.giveup|replica={slot['rid']}", 1)
        monitor.blackbox.note_event(
            "fleet_replica_giveup", replica_id=slot["rid"],
            consecutive=slot["consecutive"], exit_code=exit_code,
            artifact=str(slot["artifact"]))
        monitor.blackbox.maybe_dump(
            "fleet:replica_giveup",
            extra={"replica_id": slot["rid"],
                   "consecutive": slot["consecutive"],
                   "exit_code": exit_code})

    # -- rolling swap -------------------------------------------------------

    def rolling_swap(self, artifact=None):
        """Replace every replica, one at a time, draining each first.
        Returns a per-replica report; raises nothing mid-fleet (a
        replica that fails to come back ready is reported and the swap
        continues — the fleet must not be left drained)."""
        report = []
        for slot in self.slots:
            with self._lock:
                if slot["given_up"] or slot["proc"] is None:
                    report.append({"rid": slot["rid"],
                                   "skipped": "not running"})
                    continue
                slot["swapping"] = True
                proc = slot["proc"]
            t0 = time.monotonic()
            self.router.begin_drain(slot["rid"])
            proc.terminate()            # serve: deregister, drain, exit 0
            try:
                proc.wait(timeout=self.drain_timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
            with self._lock:
                if artifact:
                    slot["artifact"] = artifact
                self._spawn(slot)
                slot["consecutive"] = 0
            ready = self._wait_ready(slot["rid"], self.ready_timeout_s)
            with self._lock:
                slot["swapping"] = False
            monitor.counter_inc("fleet.swaps")
            report.append({"rid": slot["rid"], "ready": ready,
                           "swap_s": round(time.monotonic() - t0, 2)})
        if artifact:
            self.artifact = artifact
        return report

    def _wait_ready(self, rid, timeout):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.router.replica_ready(rid):
                return True
            if self._stop.is_set():
                return False
            time.sleep(0.1)
        return False

    def wait_all_ready(self, timeout=180.0):
        """Block until every (non-given-up) replica is routable."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(s["given_up"] or self.router.replica_ready(s["rid"])
                   for s in self.slots):
                return True
            time.sleep(0.1)
        return False

    def stop(self, timeout=30.0):
        """SIGTERM every replica (graceful drain) and stop supervising."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        with self._lock:
            procs = [s["proc"] for s in self.slots
                     if s["proc"] is not None]
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
