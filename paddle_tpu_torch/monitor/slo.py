"""Declarative SLO rules + burn-rate alerting over the time-series.

The port's own copy of `paddle_tpu/monitor/slo.py`, with the same
rules, default packs and JSON grammar over the same metric names.

The sampler (monitor/timeseries.py) turns counters into windowed rates
and histograms into windowed quantiles; this module turns those windows
into DECISIONS. A rule is declarative data:

    SloRule("serving-p99-latency", "serving.request_latency_s",
            ">", 0.5, window_s=30, for_s=5, agg="p99",
            clear_threshold=0.4)

and is evaluated once per sampler tick against a probe (a
TimeSeriesStore, or the fleet aggregator's merged view) with
hysteresis:

  * `for_s`  — the breach must HOLD this long before the alert fires
               (a one-tick spike never pages);
  * `clear_threshold` — a firing alert clears only once the value
               crosses a SEPARATE, better threshold (held for
               `clear_for_s`), so a value oscillating around the fire
               threshold cannot flap the alert.

Firing is observable through every channel the repo already has: an
`slo.firing|rule=<name>` gauge (1 firing / 0 clear), `slo.fired` /
`slo.cleared` counters, a flight-recorder event, ONE blackbox bundle
per firing episode (reason `slo:<rule>` — the edge triggers the dump,
so a rule that stays firing for an hour writes one bundle, not 3600),
and a stderr log line.

`BurnRateRule` covers the error-budget spelling: over a good/total
counter pair, burn = error_rate / (1 - objective) — burn 1.0 spends
the budget exactly at the objective's pace, 14 means a page.

Default packs (serving / training / fleet) ship conservative
thresholds; users extend or override via the `slo_rules` flag — a JSON
file of rule dicts (`rules_from_json` grammar).
"""

from __future__ import annotations

import json
import sys
import time

from . import registry as _registry

__all__ = ["SloRule", "BurnRateRule", "SloEngine",
           "default_serving_rules", "default_lm_serving_rules",
           "default_training_rules", "default_fleet_rules",
           "default_rules", "rules_from_json", "rules_from_flag"]

_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}

_AGGS = ("last", "min", "max", "mean", "rate", "p50", "p95", "p99",
         "spike")


class SloRule:
    """One declarative alert rule. `metric` is a registry name (or a
    tuple of counter names whose rates sum, for agg='rate'); `agg`
    picks the windowed derivation the threshold applies to:

      rate             counter per-second rate over window_s
      last/min/max/mean gauge window stats
      p50/p95/p99      histogram windowed quantiles
      spike            gauge last / windowed min (a ratio: 2.0 = the
                       value doubled inside the window — the loss-EMA
                       spike detector)

    `skip_labels` drops labeled series variants from resolution (e.g.
    {"device": "cpu-smoke"} keeps the MFU floor honest off-chip: no
    data -> no evaluation -> no noise)."""

    kind = "threshold"

    def __init__(self, name, metric, op, threshold, window_s=30.0,
                 for_s=0.0, agg="last", clear_threshold=None,
                 clear_for_s=0.0, scope="local", skip_labels=None,
                 description=""):
        if not name or not str(name).isprintable():
            raise ValueError(f"bad rule name {name!r}")
        if op not in _OPS:
            raise ValueError(f"rule {name}: op must be one of "
                             f"{sorted(_OPS)}, got {op!r}")
        if agg not in _AGGS:
            raise ValueError(f"rule {name}: agg must be one of "
                             f"{_AGGS}, got {agg!r}")
        if isinstance(metric, (list, tuple)):
            metric = tuple(str(m) for m in metric)
            if agg != "rate":
                raise ValueError(f"rule {name}: a metric LIST only "
                                 "makes sense for agg='rate' (rates "
                                 "sum; windows of unlike gauges don't)")
        else:
            metric = str(metric)
        if not float(window_s) > 0:
            raise ValueError(f"rule {name}: window_s must be > 0")
        self.name = str(name)
        self.metric = metric
        self.op = op
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.for_s = float(for_s)
        self.agg = agg
        self.clear_threshold = (float(clear_threshold)
                                if clear_threshold is not None
                                else self.threshold)
        self.clear_for_s = float(clear_for_s)
        self.scope = str(scope)
        self.skip_labels = dict(skip_labels) if skip_labels else None
        self.description = str(description)
        # the clear threshold must sit on the GOOD side of the fire
        # threshold (or equal it): hysteresis that clears while still
        # breaching would flap by construction
        if _OPS[op](self.clear_threshold, self.threshold) \
                and self.clear_threshold != self.threshold:
            raise ValueError(
                f"rule {name}: clear_threshold {self.clear_threshold} "
                f"is on the breaching side of '{op} {self.threshold}'")

    def value(self, probe, now=None):
        """The windowed value the thresholds apply to, or None when the
        probe has no data for the metric (no data never fires AND never
        clears — a scrape hiccup must not flap an alert)."""
        if self.agg == "rate":
            metrics = (self.metric if isinstance(self.metric, tuple)
                       else (self.metric,))
            rates = [probe.rate(m, self.window_s, now,
                                skip_labels=self.skip_labels)
                     for m in metrics]
            rates = [r for r in rates if r is not None]
            return sum(rates) if rates else None
        if self.agg in ("p50", "p95", "p99"):
            hw = probe.hist_window(self.metric, self.window_s, now,
                                   skip_labels=self.skip_labels)
            return None if hw is None else hw.get(self.agg)
        st = probe.gauge_window(self.metric, self.window_s, now,
                                skip_labels=self.skip_labels)
        if st is None:
            return None
        if self.agg == "spike":
            base = st["min"]
            if base is None or base <= 0:
                return None
            return st["last"] / base
        return st[self.agg]

    def to_dict(self):
        return {"name": self.name, "kind": self.kind,
                "metric": (list(self.metric)
                           if isinstance(self.metric, tuple)
                           else self.metric),
                "op": self.op, "threshold": self.threshold,
                "window_s": self.window_s, "for_s": self.for_s,
                "agg": self.agg,
                "clear_threshold": self.clear_threshold,
                "clear_for_s": self.clear_for_s, "scope": self.scope,
                "description": self.description}


class BurnRateRule(SloRule):
    """Error-budget burn rate over a good/total counter pair.

    error_rate = 1 - rate(good)/rate(total) over the window;
    burn = error_rate / (1 - objective). Burn 1.0 spends the error
    budget exactly at the objective's pace; the default threshold (14,
    Google SRE workbook's fast-burn page for a 1h window scaled down)
    means "at this pace the budget is gone in hours, not weeks"."""

    kind = "burn_rate"

    def __init__(self, name, good, total, objective=0.999,
                 threshold=14.0, window_s=60.0, for_s=0.0,
                 clear_threshold=None, clear_for_s=0.0, scope="local",
                 description=""):
        if not 0.0 < float(objective) < 1.0:
            raise ValueError(f"rule {name}: objective must be in "
                             f"(0, 1), got {objective}")
        super().__init__(
            name, str(total), ">", threshold, window_s=window_s,
            for_s=for_s, agg="rate",
            clear_threshold=(clear_threshold if clear_threshold
                             is not None else float(threshold) / 2.0),
            clear_for_s=clear_for_s, scope=scope,
            description=description)
        self.good = str(good)
        self.total = str(total)
        self.objective = float(objective)

    def value(self, probe, now=None):
        total = probe.rate(self.total, self.window_s, now)
        if total is None or total <= 0:
            return None
        good = probe.rate(self.good, self.window_s, now) or 0.0
        error_rate = min(1.0, max(0.0, 1.0 - good / total))
        return error_rate / (1.0 - self.objective)

    def to_dict(self):
        out = super().to_dict()
        out.update(good=self.good, total=self.total,
                   objective=self.objective)
        return out


# ---------------------------------------------------------------------------
# the engine: per-rule hysteresis state + firing side effects
# ---------------------------------------------------------------------------

class _AlertState:
    __slots__ = ("state", "breach_since", "clear_since", "firing_since",
                 "episodes", "last_value", "last_eval")

    def __init__(self):
        self.state = "ok"            # ok | firing
        self.breach_since = None
        self.clear_since = None
        self.firing_since = None
        self.episodes = 0
        self.last_value = None
        self.last_eval = None


class SloEngine:
    """Evaluates a rule set against a probe once per tick. The probe is
    anything exposing rate()/gauge_window()/hist_window() with the
    TimeSeriesStore signatures — the local store, or the fleet
    aggregator's merged view."""

    def __init__(self, rules=(), scope="local", emit=True):
        self.scope = str(scope)
        self.emit = bool(emit)     # False: pure evaluation (tests)
        self._rules = {}
        self._states = {}
        for r in rules:
            self.add_rule(r)

    def add_rule(self, rule):
        if rule.name in self._rules:
            raise ValueError(f"duplicate SLO rule name {rule.name!r}")
        self._rules[rule.name] = rule
        self._states[rule.name] = _AlertState()
        if self.emit:
            _registry.gauge_set("slo.rules", len(self._rules))
        return rule

    def rules(self):
        return list(self._rules.values())

    def evaluate(self, probe, now=None):
        """One evaluation pass; returns the list of firing rule names.
        A rule whose value() raises is skipped for the tick (counted as
        slo.rule_errors) — one broken rule must not kill the sampler or
        starve the others."""
        if now is None:
            now = time.time()
        firing = []
        for name, rule in self._rules.items():
            st = self._states[name]
            try:
                v = rule.value(probe, now)
            except Exception as e:   # noqa: BLE001 — isolate the rule
                _registry.counter_inc("slo.rule_errors")
                print(f"[slo] rule {name} evaluation failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
                v = None
            st.last_eval = now
            if v is None:
                # no data: neither progress toward firing nor toward
                # clearing — a scrape hiccup must not flap the alert.
                # The hold clocks RESET: for_s means a breach SUSTAINED
                # through for_s of observations, so outage time (two
                # isolated spikes bridging a 60s data gap) must not
                # count as held breach (nor as held clearance)
                st.breach_since = None
                st.clear_since = None
                if st.state == "firing":
                    firing.append(name)
                continue
            st.last_value = v
            breaching = _OPS[rule.op](v, rule.threshold)
            if st.state == "ok":
                if breaching:
                    if st.breach_since is None:
                        st.breach_since = now
                    if now - st.breach_since >= rule.for_s:
                        self._fire(rule, st, v, now)
                else:
                    st.breach_since = None
            else:   # firing
                if self._strictly_better(rule, v):
                    if st.clear_since is None:
                        st.clear_since = now
                    if now - st.clear_since >= rule.clear_for_s:
                        self._clear(rule, st, v, now)
                else:
                    st.clear_since = None
            if st.state == "firing":
                firing.append(name)
        return firing

    @staticmethod
    def _strictly_better(rule, v):
        """Is `v` on the good side of the clear threshold? (For op '>'
        that means v < clear_threshold; for '<', v > clear_threshold —
        i.e. the breach comparison against the clear threshold fails
        AND v is not sitting exactly on it.)"""
        return not _OPS[rule.op](v, rule.clear_threshold) \
            and v != rule.clear_threshold

    # -- transitions --------------------------------------------------------

    def _alert_dict(self, rule, st, v, now):
        return {"rule": rule.name, "scope": self.scope,
                "value": v, "threshold": rule.threshold,
                "op": rule.op, "agg": rule.agg,
                "window_s": rule.window_s, "for_s": rule.for_s,
                "clear_threshold": rule.clear_threshold,
                "episodes": st.episodes,
                "firing_since": st.firing_since,
                "description": rule.description}

    def _fire(self, rule, st, v, now):
        st.state = "firing"
        st.firing_since = now
        st.breach_since = None
        st.clear_since = None
        st.episodes += 1
        if not self.emit:
            return
        from . import blackbox
        _registry.gauge_set(f"slo.firing|rule={rule.name}", 1.0)
        _registry.counter_inc("slo.fired")
        info = self._alert_dict(rule, st, v, now)
        blackbox.note_event("slo_firing", **info)
        # ONE bundle per firing episode: the edge triggers the dump
        blackbox.maybe_dump(f"slo:{rule.name}",
                            extra={"slo": {"alert": info,
                                           "table": self.table()}})
        print(f"[slo] FIRING {rule.name} ({self.scope}): "
              f"{rule.agg}({rule.metric}) = {v:.6g} {rule.op} "
              f"{rule.threshold:.6g} over {rule.window_s:g}s "
              f"(held {rule.for_s:g}s)", file=sys.stderr, flush=True)

    def _clear(self, rule, st, v, now):
        held = now - (st.firing_since or now)
        st.state = "ok"
        st.firing_since = None
        st.breach_since = None
        st.clear_since = None
        if not self.emit:
            return
        from . import blackbox
        _registry.gauge_set(f"slo.firing|rule={rule.name}", 0.0)
        _registry.counter_inc("slo.cleared")
        blackbox.note_event("slo_cleared", rule=rule.name,
                            scope=self.scope, value=v,
                            firing_duration_s=held)
        print(f"[slo] cleared {rule.name} ({self.scope}): "
              f"{v:.6g} crossed {rule.clear_threshold:.6g} "
              f"after {held:.1f}s firing", file=sys.stderr, flush=True)

    # -- introspection ------------------------------------------------------

    def table(self):
        """The dashboard's SLO table: one row per rule with its live
        state, last value, and episode count."""
        out = []
        for name, rule in self._rules.items():
            st = self._states[name]
            out.append({
                "rule": name, "scope": self.scope,
                "state": st.state, "value": st.last_value,
                "op": rule.op, "threshold": rule.threshold,
                "clear_threshold": rule.clear_threshold,
                "agg": rule.agg,
                "metric": (list(rule.metric)
                           if isinstance(rule.metric, tuple)
                           else rule.metric),
                "window_s": rule.window_s, "for_s": rule.for_s,
                "firing_since": st.firing_since,
                "episodes": st.episodes,
                "description": rule.description})
        return out

    def firing(self):
        return [n for n, st in self._states.items()
                if st.state == "firing"]


# ---------------------------------------------------------------------------
# default rule packs + user config
# ---------------------------------------------------------------------------

def default_serving_rules():
    """Per-replica serving SLOs (evaluated by the replica's own
    sampler). Thresholds are deliberately generous defaults — tighten
    per deployment via the `slo_rules` flag."""
    return [
        SloRule("serving-p99-latency", "serving.request_latency_s",
                ">", 0.5, window_s=30.0, for_s=5.0, agg="p99",
                clear_threshold=0.4,
                description="windowed request p99 above 500 ms"),
        SloRule("serving-shed-rate",
                ("serving.rejected", "serving.deadline_shed"),
                ">", 1.0, window_s=30.0, for_s=5.0, agg="rate",
                clear_threshold=0.2,
                description="requests shed (queue-full rejects + "
                            "deadline sheds) above 1/s"),
        SloRule("serving-queue-depth", "serving.queue_depth",
                ">", 96.0, window_s=10.0, for_s=5.0, agg="mean",
                clear_threshold=64.0,
                description="admission queue sustained above 96 "
                            "(3/4 of the default queue_limit)"),
    ]


def default_lm_serving_rules():
    """Generative-LM serving SLOs (serving/lm.py replicas): the two
    latencies a streaming reader actually feels — time to first token
    and the inter-token cadence — plus the same shed-rate guard the
    one-shot pack carries. Generous defaults; tighten per deployment
    via `slo_rules`."""
    return [
        SloRule("serving-lm-ttft", "serving_lm.ttft_s",
                ">", 1.0, window_s=30.0, for_s=5.0, agg="p99",
                clear_threshold=0.8,
                description="windowed time-to-first-token p99 above "
                            "1 s (queue wait + prefill)"),
        SloRule("serving-lm-inter-token", "serving_lm.inter_token_s",
                ">", 0.2, window_s=30.0, for_s=5.0, agg="p99",
                clear_threshold=0.15,
                description="windowed inter-token p99 above 200 ms — "
                            "the stream is stuttering"),
        SloRule("serving-lm-shed-rate",
                ("serving_lm.rejected", "serving_lm.deadline_shed"),
                ">", 1.0, window_s=30.0, for_s=5.0, agg="rate",
                clear_threshold=0.2,
                description="generations shed (queue-full rejects + "
                            "deadline sheds) above 1/s"),
        SloRule("serving-lm-kv-occupancy",
                "serving_lm.kv_pages_occupancy",
                ">", 0.9, window_s=30.0, for_s=10.0, agg="mean",
                clear_threshold=0.75,
                description="KV page pool sustained above 90% full — "
                            "admissions are about to queue on pages; "
                            "scale out or shrink max_new_tokens"),
    ]


def default_training_rules():
    """Training-side SLOs: MFU floor (skipped off-chip — the cpu-smoke
    label is a formula check, not a perf claim), feed-stall rate, and
    a loss-EMA spike."""
    return [
        SloRule("train-mfu-floor", "perf.mfu", "<", 0.05,
                window_s=120.0, for_s=60.0, agg="mean",
                clear_threshold=0.08,
                skip_labels={"device": "cpu-smoke"},
                description="sustained MFU below 5% on-chip"),
        SloRule("train-feed-stall-rate", "feed.stalls", ">", 2.0,
                window_s=30.0, for_s=10.0, agg="rate",
                clear_threshold=0.5,
                description="input pipeline starving the step loop "
                            "(>2 stalls/s)"),
        SloRule("train-loss-spike", "health.loss_ema", ">", 2.0,
                window_s=120.0, for_s=0.0, agg="spike",
                clear_threshold=1.5,
                description="loss EMA doubled inside the window"),
    ]


def default_rules():
    return (default_serving_rules() + default_lm_serving_rules()
            + default_training_rules())


def default_fleet_rules():
    """Fleet-scope SLOs the router's aggregator evaluates over the
    merged replica series + its own typed-reply counters."""
    return [
        SloRule("fleet-shed-rate", ("fleet.shed", "fleet.unavailable"),
                ">", 0.5, window_s=5.0, for_s=0.5, agg="rate",
                clear_threshold=0.1, scope="fleet",
                description="router-minted 429/503 typed replies "
                            "above 0.5/s — clients are being shed"),
        SloRule("fleet-queue-depth", "serving.queue_depth",
                ">", 192.0, window_s=10.0, for_s=5.0, agg="mean",
                clear_threshold=128.0, scope="fleet",
                description="fleet-total admission queue sustained "
                            "above 192"),
        SloRule("fleet-p99-latency", "serving.request_latency_s",
                ">", 0.5, window_s=30.0, for_s=5.0, agg="p99",
                clear_threshold=0.4, scope="fleet",
                description="merged fleet request p99 above 500 ms"),
    ]


_RULE_KEYS = {"name", "metric", "op", "threshold", "window_s", "for_s",
              "agg", "clear_threshold", "clear_for_s", "scope",
              "skip_labels", "description"}
_BURN_KEYS = {"name", "good", "total", "objective", "threshold",
              "window_s", "for_s", "clear_threshold", "clear_for_s",
              "scope", "description"}


def rules_from_json(data):
    """Parse user rules: a JSON list (or already-parsed list) of rule
    dicts. A dict carrying `good`/`total` is a BurnRateRule; anything
    else is an SloRule. Unknown keys are an error (a typo'd threshold
    key must not silently fall back to the default)."""
    if isinstance(data, str):
        data = json.loads(data)
    if not isinstance(data, list):
        raise ValueError("slo rules must be a JSON LIST of rule "
                         f"objects, got {type(data).__name__}")
    out = []
    for i, item in enumerate(data):
        if not isinstance(item, dict):
            raise ValueError(f"slo rule #{i} must be an object, got "
                             f"{type(item).__name__}")
        if "good" in item or "total" in item:
            unknown = set(item) - _BURN_KEYS
            if unknown:
                raise ValueError(f"slo rule #{i}: unknown keys "
                                 f"{sorted(unknown)} (burn-rate rules "
                                 f"take {sorted(_BURN_KEYS)})")
            out.append(BurnRateRule(**item))
        else:
            unknown = set(item) - _RULE_KEYS
            if unknown:
                raise ValueError(f"slo rule #{i}: unknown keys "
                                 f"{sorted(unknown)} (rules take "
                                 f"{sorted(_RULE_KEYS)})")
            out.append(SloRule(**item))
    return out


def merged_rules(defaults, user):
    """Default pack + user rules, where a user rule REPLACES a
    same-named default (the documented override spelling: re-declare
    `serving-p99-latency` in the slo_rules file to tighten it) — the
    engine itself still rejects duplicates, so merge BEFORE
    construction."""
    by_name = {r.name: r for r in defaults}
    for r in user:
        by_name[r.name] = r
    return list(by_name.values())


def rules_from_flag(scope="local"):
    """Rules from the `slo_rules` flag file, filtered to `scope`.
    A missing/invalid file warns and contributes nothing — a typo'd
    rules path must not take the sampler (or the router) down."""
    from .. import flags
    path = flags.get("slo_rules")
    if not path:
        return []
    try:
        with open(path) as f:
            rules = rules_from_json(f.read())
    except (OSError, ValueError) as e:
        print(f"[slo] ignoring slo_rules file {path!r}: {e}",
              file=sys.stderr)
        return []
    return [r for r in rules if r.scope == scope]
