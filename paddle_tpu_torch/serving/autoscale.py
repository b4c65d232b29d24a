"""Autoscale controller: the fleet sizes itself off its own dashboard.

The port of `paddle_tpu/serving/autoscale.py` (device-free; the same
decisions on the same dashboards). Every signal the controller consumes
is the `GET /fleet/dashboard` payload (DASHBOARD_SCHEMA_VERSION — no
side channels into router internals), and every actuation goes through
ReplicaSupervisor's drain-safe slot operations, so scaling reuses
exactly the machinery the chaos drills already proved.

  AutoscalePolicy   the pure decision function: decide(dashboard,
                    current_replicas, now) -> {"action": "up"|"down"|
                    "hold", "reason", "target", "signals"}. State is
                    only the structural-hysteresis bookkeeping
                    (monitor/slo.py discipline, restated here):

                      * separate breach/clear surfaces — scale-up
                        pressure is the `fleet-shed-rate` SLO firing or
                        the windowed queue depth above `queue_high`;
                        scale-down needs a DIFFERENT, stricter surface
                        (rps at/below `idle_rps`, queue at/below
                        `queue_low`, zero shed, no SLO firing)
                      * hold clocks — pressure must persist `up_for_s`
                        before an up; idle must persist `idle_for_s`
                        before a down; the opposing clock resets the
                        moment its condition breaks
                      * no-data freezes state — a dashboard with no
                        scrapes or no windowed signals resets BOTH
                        clocks and holds; a blind controller must never
                        act on staleness
                      * per-direction cooldowns + min/max bounds —
                        `up_cooldown_s` / `down_cooldown_s` rate-limit
                        actuation, and a down additionally waits out
                        the up-cooldown (scale-up is the more recent
                        evidence)

                    Exactly one of scale_ups/scale_downs/holds is
                    counted per decide() call, so
                    `ups + downs + holds == decisions` is an invariant
                    the drill asserts — a decision that isn't one of
                    the three is a bug, not a rounding error.

  predictive mode   the load-model alternative ("autoscale_mode"
                    flag): instead of waiting out the up hold clock,
                    compute the replicas the offered load NEEDS and
                    jump. Demand is Little's law over the dashboard
                    window (in-system concurrency = offered rps x mean
                    latency, where offered includes the shed rate —
                    shed requests are demand the fleet failed to
                    carry); per-replica capacity comes from the sampled
                    `serving.device_time|rung=` family (the dashboard's
                    per-replica `deviceprof` sections): the largest
                    measured batch rung B is the parallelism one
                    replica retires per dispatch, derated by
                    `target_util`. required = ceil(demand / (B /
                    target_util)). No profiling data degrades to B=1
                    (conservative: scales up EARLIER, never later).
                    Scale-down keeps the reactive sustained-idle
                    discipline in both modes — removing a replica costs
                    a drain, so it stays deliberate.

  AutoscaleController
                    the loop that runs inside the `route` process:
                    every `interval_s` it takes one dashboard
                    (window_s = `signal_window_s` so signals react on
                    the controller's timescale, not the 30 s human
                    one), asks the policy, and actuates through
                    `supervisor.add_slot()` / `supervisor
                    .remove_slot()` (drain handshake: router drain-mark
                    -> SIGTERM -> replica deregisters first -> exit 0 —
                    in-flight requests never die). A given-up replica
                    (supervisor exhausted its restart budget) does not
                    count toward `min_replicas`, so the next tick
                    backfills the lost slot. Exposes `autoscale.*`
                    counters/gauges, `GET /fleet/autoscale`, and the
                    dashboard's `autoscale` section.

Shell: `python -m paddle_tpu_torch route --model_dir m --replicas 1
--autoscale --min_replicas 1 --max_replicas 4`.
"""

from __future__ import annotations

import collections
import math
import threading
import time

from .. import monitor

__all__ = ["AutoscaleConfig", "AutoscalePolicy", "AutoscaleController"]


class AutoscaleConfig:
    """Autoscaler knobs. Defaults resolve from the `autoscale_*` flags
    via `from_flags()`; the constructor takes explicit values (tests,
    drills).

      min_replicas / max_replicas — fleet size bounds (live, non-given-
                          up slots; a given-up replica is backfilled).
      mode              — "reactive" (hysteresis over queue/SLO
                          signals) or "predictive" (load-model ups,
                          reactive downs).
      interval_s        — controller decision cadence.
      signal_window_s   — dashboard window the controller reads
                          (short: signals must move on the decision
                          timescale, not the human 30 s one).
      queue_high        — fleet queue depth (latest sample) above which
                          scale-up pressure exists.
      queue_low         — queue depth at/below which the fleet can be
                          idle (the separate clear surface).
      up_for_s          — pressure hold before a reactive scale-up.
      idle_rps          — fleet request rate at/below which the fleet
                          can be idle.
      idle_for_s        — idle hold before a scale-down.
      up_cooldown_s / down_cooldown_s — per-direction actuation
                          rate limits.
      target_util       — predictive derate: fraction of measured
                          per-replica capacity the model plans to.
      slo_rule          — the dashboard SLO whose "firing" state is
                          scale-up pressure.
    """

    def __init__(self, min_replicas=1, max_replicas=4, mode="reactive",
                 interval_s=1.0, signal_window_s=10.0, queue_high=8.0,
                 queue_low=2.0, up_for_s=3.0, idle_rps=1.0,
                 idle_for_s=15.0, up_cooldown_s=10.0,
                 down_cooldown_s=30.0, target_util=0.6,
                 slo_rule="fleet-shed-rate"):
        if not 1 <= int(min_replicas) <= int(max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}")
        if mode not in ("reactive", "predictive"):
            raise ValueError(f"mode must be reactive|predictive, "
                             f"got {mode!r}")
        if not 0.0 < float(target_util) <= 1.0:
            raise ValueError("target_util must be in (0, 1]")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.mode = mode
        self.interval_s = float(interval_s)
        self.signal_window_s = float(signal_window_s)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.up_for_s = float(up_for_s)
        self.idle_rps = float(idle_rps)
        self.idle_for_s = float(idle_for_s)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.target_util = float(target_util)
        self.slo_rule = str(slo_rule)

    @classmethod
    def from_flags(cls, **overrides):
        """Resolve every knob from the `autoscale_*` flags, then apply
        non-None overrides (the route CLI's explicit arguments win)."""
        from .. import flags
        kw = dict(
            min_replicas=flags.get("autoscale_min_replicas"),
            max_replicas=flags.get("autoscale_max_replicas"),
            mode=flags.get("autoscale_mode"),
            interval_s=flags.get("autoscale_interval_s"),
            signal_window_s=flags.get("autoscale_window_s"),
            queue_high=flags.get("autoscale_queue_high"),
            queue_low=flags.get("autoscale_queue_low"),
            up_for_s=flags.get("autoscale_up_for_s"),
            idle_rps=flags.get("autoscale_idle_rps"),
            idle_for_s=flags.get("autoscale_idle_for_s"),
            up_cooldown_s=flags.get("autoscale_up_cooldown_s"),
            down_cooldown_s=flags.get("autoscale_down_cooldown_s"),
            target_util=flags.get("autoscale_target_util"))
        kw.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**kw)

    def summary(self):
        return {k: getattr(self, k) for k in (
            "min_replicas", "max_replicas", "mode", "interval_s",
            "signal_window_s", "queue_high", "queue_low", "up_for_s",
            "idle_rps", "idle_for_s", "up_cooldown_s",
            "down_cooldown_s", "target_util", "slo_rule")}


class AutoscalePolicy:
    """The pure decision function (no registry writes, no actuation —
    the controller owns both, and the drill runs a second instance as a
    shadow judge). See the module docstring for the semantics."""

    def __init__(self, config=None):
        self.config = config or AutoscaleConfig()
        self._up_since = None       # pressure hold clock
        self._down_since = None     # idle hold clock
        self._last_up_at = None     # cooldown anchors
        self._last_down_at = None
        self.counts = collections.Counter(
            decisions=0, scale_ups=0, scale_downs=0, holds=0,
            backfills=0, no_data=0)

    # -- signal extraction --------------------------------------------------

    def signals(self, dashboard):
        """The decision inputs, read off one dashboard payload. Every
        field may be None — consumers must treat absence as no-data,
        never as zero."""
        sig = {"queue": None, "rps": None, "shed": None,
               "latency_mean": None, "slo_firing": False,
               "no_data": True, "required": None, "model": None}
        if not isinstance(dashboard, dict) or not dashboard.get("scrapes"):
            return sig
        win = dashboard.get("window") or {}
        q = win.get("queue_depth")
        if isinstance(q, dict) and q.get("last") is not None:
            sig["queue"] = float(q["last"])
        if win.get("requests_per_sec") is not None:
            sig["rps"] = float(win["requests_per_sec"])
        if win.get("shed_per_sec") is not None:
            sig["shed"] = float(win["shed_per_sec"])
        lat = win.get("latency_s")
        if isinstance(lat, dict) and lat.get("mean") is not None:
            sig["latency_mean"] = float(lat["mean"])
        for row in dashboard.get("slo") or ():
            if (row.get("rule") == self.config.slo_rule
                    and row.get("state") == "firing"):
                sig["slo_firing"] = True
        sig["no_data"] = sig["queue"] is None and sig["rps"] is None
        if self.config.mode == "predictive" and not sig["no_data"]:
            sig["required"], sig["model"] = self._required(dashboard, sig)
        return sig

    def _required(self, dashboard, sig):
        """Predictive load model: replicas the offered load needs.
        Demand = Little's law over the window (offered rps x mean
        latency = in-system concurrency; offered includes the shed rate
        — requests the fleet is ALREADY failing to carry are demand,
        not noise). Per-replica capacity = the largest measured
        device-time batch rung B (the parallelism one replica retires
        per dispatch), derated by target_util. Returns (required,
        model-detail) or (None, reason) when the window has no
        rate/latency yet."""
        if sig["rps"] is None or sig["latency_mean"] is None:
            return None, "window has no rate/latency yet"
        offered = sig["rps"] + (sig["shed"] or 0.0)
        demand = offered * sig["latency_mean"]
        rung_b, rung_t = None, None
        for sec in (dashboard.get("deviceprof") or {}).values():
            last = (sec or {}).get("last") or {}
            try:
                b = int(last["rung"])
                t = float(last["device_time_s"])
            except (KeyError, TypeError, ValueError):
                continue
            if t > 0 and (rung_b is None or b > rung_b):
                rung_b, rung_t = b, t
        capacity = max(rung_b or 1, 1) / self.config.target_util
        required = max(1, math.ceil(demand / capacity))
        return required, {
            "offered_rps": round(offered, 3),
            "demand_concurrency": round(demand, 3),
            "rung_batch": rung_b, "rung_device_time_s": rung_t,
            "per_replica_capacity": round(capacity, 3)}

    # -- the decision -------------------------------------------------------

    def decide(self, dashboard, current, now=None):
        """One decision over one dashboard payload. `current` is the
        live (non-given-up) replica slot count. Exactly one of
        scale_ups / scale_downs / holds is counted per call."""
        cfg = self.config
        if now is None:
            now = time.monotonic()
        self.counts["decisions"] += 1
        sig = self.signals(dashboard)

        def hold(reason):
            self.counts["holds"] += 1
            return {"action": "hold", "reason": reason,
                    "current": current, "target": current,
                    "signals": sig}

        def up(reason, target=None, backfill=False):
            self.counts["scale_ups"] += 1
            if backfill:
                self.counts["backfills"] += 1
            self._last_up_at = now
            self._up_since = None
            self._down_since = None
            return {"action": "up", "reason": reason,
                    "current": current,
                    "target": target if target is not None
                    else current + 1,
                    "backfill": backfill, "signals": sig}

        def down(reason):
            self.counts["scale_downs"] += 1
            self._last_down_at = now
            self._up_since = None
            self._down_since = None
            return {"action": "down", "reason": reason,
                    "current": current, "target": current - 1,
                    "signals": sig}

        # a given-up replica counts against min_replicas: backfill the
        # lost slot immediately, regardless of signal quality — a blind
        # controller may never GROW on staleness, but restoring the
        # configured floor is not growth
        if current < cfg.min_replicas:
            return up("backfill", target=current + 1, backfill=True)

        if sig["no_data"]:
            # freeze: reset both hold clocks — partial evidence from
            # before the blindness must not mature into an action
            self.counts["no_data"] += 1
            self._up_since = None
            self._down_since = None
            return hold("no-data")

        in_up_cooldown = (self._last_up_at is not None
                          and now - self._last_up_at < cfg.up_cooldown_s)

        # predictive: the load model names the target directly; the
        # hold clock is the thing this mode exists to skip. Cooldown
        # and bounds still apply.
        if (cfg.mode == "predictive" and sig["required"] is not None
                and sig["required"] > current):
            self._down_since = None
            if current >= cfg.max_replicas:
                return hold("at-max")
            if in_up_cooldown:
                return hold("up-cooldown")
            return up("model")

        pressure = None
        if sig["slo_firing"]:
            pressure = f"slo:{cfg.slo_rule}"
        elif sig["queue"] is not None and sig["queue"] > cfg.queue_high:
            pressure = "queue-depth"
        if pressure is not None:
            self._down_since = None
            if current >= cfg.max_replicas:
                # can't act: don't let the clock mature a phantom up
                self._up_since = None
                return hold("at-max")
            if self._up_since is None:
                self._up_since = now
            if now - self._up_since < cfg.up_for_s:
                return hold("up-hold")
            if in_up_cooldown:
                return hold("up-cooldown")
            return up(pressure)
        self._up_since = None

        idle = (sig["rps"] is not None and sig["rps"] <= cfg.idle_rps
                and (sig["queue"] or 0.0) <= cfg.queue_low
                and (sig["shed"] or 0.0) <= 1e-9
                and not sig["slo_firing"])
        if idle:
            if self._down_since is None:
                self._down_since = now
            if now - self._down_since < cfg.idle_for_s:
                return hold("idle-hold")
            if current <= cfg.min_replicas:
                return hold("at-min")
            if in_up_cooldown or (
                    self._last_down_at is not None
                    and now - self._last_down_at < cfg.down_cooldown_s):
                return hold("down-cooldown")
            return down("idle")
        self._down_since = None
        return hold("steady")


class AutoscaleController:
    """The policy loop inside the `route` process: dashboard in,
    supervisor slot operations out. Attach as `router.autoscaler` so
    GET /fleet/autoscale and the dashboard's `autoscale` section find
    it."""

    def __init__(self, router, supervisor, config=None, policy=None):
        if supervisor is None:
            raise ValueError("the autoscaler needs a ReplicaSupervisor "
                             "(spawn mode) — a --targets fleet is "
                             "externally managed")
        self.router = router
        self.supervisor = supervisor
        self.config = config or AutoscaleConfig()
        self.policy = policy or AutoscalePolicy(self.config)
        self._stop = threading.Event()
        self._thread = None
        self._lock = threading.Lock()
        self.history = collections.deque(maxlen=256)
        self.last_decision = None
        self.ticks = 0

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="paddle-tpu-torch-autoscale",
                daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        return self

    def _loop(self):
        import sys
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception as e:   # noqa: BLE001 — the loop must
                # survive, but never silently: a dead autoscaler means
                # a fleet frozen at its current size
                print(f"autoscale tick failed: {type(e).__name__}: {e}",
                      file=sys.stderr)

    # -- one decision + actuation -------------------------------------------

    def current_replicas(self):
        """Live slot count — given-up replicas are dead capacity and do
        NOT count toward min_replicas (that is what triggers the
        backfill)."""
        sup = self.supervisor
        with sup._lock:
            return sum(1 for s in sup.slots if not s["given_up"])

    def tick(self, now=None):
        if now is None:
            now = time.monotonic()
        try:
            dashboard = self.router.aggregator.dashboard(
                window_s=self.config.signal_window_s)
        except Exception:   # noqa: BLE001 — an unreadable dashboard is
            dashboard = None            # no-data, not a crashed loop
        current = self.current_replicas()
        decision = self.policy.decide(dashboard, current, now=now)
        actuation = None
        if decision["action"] == "up":
            actuation = self.supervisor.add_slot()
        elif decision["action"] == "down":
            # synchronous drain: the controller blocks through the
            # handshake (router drain-mark -> SIGTERM -> deregister ->
            # exit 0). The down cooldown more than covers the stall,
            # and a controller that overlaps drains can strand the
            # fleet below min.
            actuation = self.supervisor.remove_slot()
        self._export(decision, current)
        entry = {"t": time.time(), "action": decision["action"],
                 "reason": decision["reason"],
                 "current": current, "target": decision["target"],
                 "signals": decision["signals"],
                 "actuation": actuation}
        with self._lock:
            self.history.append(entry)
            self.last_decision = entry
            self.ticks += 1
        return entry

    def _export(self, decision, current):
        monitor.counter_inc("autoscale.decisions")
        monitor.counter_inc({"up": "autoscale.scale_ups",
                             "down": "autoscale.scale_downs",
                             "hold": "autoscale.holds"}
                            [decision["action"]])
        if decision.get("backfill"):
            monitor.counter_inc("autoscale.backfills")
        if decision["reason"] == "no-data":
            monitor.counter_inc("autoscale.no_data")
        monitor.gauge_set("autoscale.current_replicas", current)
        monitor.gauge_set("autoscale.target_replicas",
                          decision["target"])

    # -- introspection ------------------------------------------------------

    def status(self):
        """The GET /fleet/autoscale payload: config, counts, and the
        recent decision history."""
        with self._lock:
            history = list(self.history)[-32:]
            last = self.last_decision
            ticks = self.ticks
        return {"enabled": True, "config": self.config.summary(),
                "current_replicas": self.current_replicas(),
                "ticks": ticks,
                "counts": dict(self.policy.counts),
                "last_decision": last, "history": history}

    def dashboard_section(self):
        """The compact `autoscale` section of the fleet dashboard
        (additive — schema stays v1)."""
        with self._lock:
            last = self.last_decision
        return {"mode": self.config.mode,
                "min_replicas": self.config.min_replicas,
                "max_replicas": self.config.max_replicas,
                "current_replicas": self.current_replicas(),
                "counts": dict(self.policy.counts),
                "last_decision": (
                    None if last is None else
                    {k: last[k] for k in ("t", "action", "reason",
                                          "current", "target")})}
