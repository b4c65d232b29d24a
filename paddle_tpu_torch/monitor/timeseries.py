"""Windowed time-series over the metrics registry: the sampler layer.

The port's own copy of `paddle_tpu/monitor/timeseries.py`.

Every export surface so far (`/debug/vars`, `/metrics`, `stats()`) is a
point-in-time snapshot — it can say what a counter is *now*, never
"what was serving p99 over the last 30 s" or "is the shed rate rising".
This module adds that axis: a background sampler thread snapshots the
registry at a configurable cadence (`metrics_sample_s` flag, default
off → zero threads, zero overhead) into bounded per-metric ring
buffers, and every derivation is computed ON READ, never on write:

  * counters    -> `rate()` per second over a trailing window,
                   monotonic and reset-tolerant: a decrease means the
                   producing process restarted and the counter rebooted
                   from zero, so the new value itself is the delta —
                   a replica restart cannot produce a negative or
                   inflated fleet rate.
  * gauges      -> windowed min/max/mean/last.
  * histograms  -> windowed quantiles: each tick taps the fresh raw
                   samples since the previous tick (bounded per tick),
                   so a window's p99 is a nearest-rank quantile over
                   exactly the window's observations. When raw samples
                   are unavailable (scraped remote snapshots carry only
                   summaries) the window falls back to a weighted
                   quantile merge over per-tick summaries — the same
                   `merge_quantiles` the fleet router uses to merge
                   per-replica latency, so the two layers cannot
                   disagree.

The pure window math (`counter_rate`, `window_stats`,
`merge_quantiles`) is module-level: one formula per derivation, the
same as the JAX package's, so a reader of either package's
`/debug/vars` windows computes the same numbers.

The sampler also owns the local SLO engine (monitor/slo.py): rules are
evaluated once per tick against the store, with hysteresis. Lifecycle
is flag-driven: resolving/setting `metrics_sample_s` calls
`configure(interval)` (flags.py side effect); 0 stops the thread.
"""

from __future__ import annotations

import collections
import sys
import threading
import time

from . import registry as _registry

__all__ = ["counter_rate", "window_stats", "merge_quantiles",
           "TimeSeriesStore", "Sampler", "configure", "store",
           "sampler", "sampler_running", "stats", "reset",
           "window_summaries_from_debug_vars", "SAMPLER_THREAD_NAME"]


def window_summaries_from_debug_vars(payload):
    """The source's own WINDOWED histogram summaries out of a
    /debug/vars payload (its sampler's `timeseries.window.histograms`
    section), or None — the `hist_window_summaries` override every
    scraper of remote snapshots (fleet aggregator, `top`) should pass
    to append_snapshot so windowed quantiles stay window-local."""
    if not isinstance(payload, dict):
        return None
    tsec = payload.get("timeseries")
    if not isinstance(tsec, dict):
        return None
    win = tsec.get("window")
    if isinstance(win, dict) and isinstance(win.get("histograms"),
                                            dict):
        return win["histograms"]
    return None

SAMPLER_THREAD_NAME = "paddle-tpu-torch-metrics-sampler"

# points kept per metric ring: at the default 1 s cadence this is ~8.5
# minutes of lookback, bounded at a few MB for a busy registry
_DEFAULT_CAPACITY = 512
# raw histogram samples kept per tick (per histogram): bounds ring
# memory on hot latency histograms; the subsample stays a uniform tap
_MAX_TICK_SAMPLES = 256


# ---------------------------------------------------------------------------
# pure window math (shared: local store, fleet merge, top, --watch)
# ---------------------------------------------------------------------------

def _window_slice(points, window_s, now, keep_baseline=False):
    """Trailing-window view of ascending (t, ...) tuples. With
    `keep_baseline` the last point BEFORE the window start is included
    (cumulative-delta math needs the value at the window's edge)."""
    pts = list(points)
    if window_s is None or not pts:
        return pts
    if now is None:
        now = pts[-1][0]
    start = now - float(window_s)
    idx = len(pts)
    for i, p in enumerate(pts):
        if p[0] >= start:
            idx = i
            break
    if keep_baseline and idx > 0:
        idx -= 1
    return pts[idx:]


def _increase(pts):
    """THE reset-tolerant accumulation: sum of adjacent increases,
    where a DECREASE means the producing process restarted and its
    counter rebooted from zero, so the post-reset value itself is the
    delta (the observations lost between the crash and the first
    post-restart sample are honestly dropped, never negated). The one
    loop counter_rate and counter_delta share."""
    total = 0.0
    for (_, v0), (_, v1) in zip(pts, pts[1:]):
        d = v1 - v0
        total += v1 if d < 0 else d
    return total


def counter_rate(points, window_s=None, now=None):
    """Per-second rate of a monotonic counter over the trailing window
    (`points` is an ascending [(t, value)] series), reset-tolerant via
    `_increase`. Returns None with fewer than two points or a
    degenerate time span."""
    pts = _window_slice(points, window_s, now, keep_baseline=True)
    if len(pts) < 2:
        return None
    elapsed = pts[-1][0] - pts[0][0]
    if elapsed <= 0:
        return None
    return _increase(pts) / elapsed


def counter_delta(points, window_s=None, now=None):
    """Reset-tolerant total increase over the trailing window (the
    numerator of counter_rate). None with fewer than two points."""
    pts = _window_slice(points, window_s, now, keep_baseline=True)
    if len(pts) < 2:
        return None
    return _increase(pts)

def window_stats(points, window_s=None, now=None):
    """{'last','min','max','mean','n'} over a gauge's trailing window
    (arithmetic mean over samples — the sampler's fixed cadence makes
    that the time-weighted mean up to one tick of edge error). None
    when the window holds no points."""
    vals = [p[1] for p in _window_slice(points, window_s, now)
            if p[1] is not None]
    if not vals:
        return None
    return {"last": vals[-1], "min": min(vals), "max": max(vals),
            "mean": sum(vals) / len(vals), "n": len(vals)}


# the quantile knots a registry summary carries, ascending
_QKEYS = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


def merge_quantiles(parts, qs=(50, 95, 99)):
    """Weighted quantile merge over per-source summaries — THE merge
    rule for latency across replicas (fleet) and across ticks (a
    scraped store's window).

    `parts` is [(weight, summary)] where summary carries p50/p95/p99
    (a registry Histogram.summary() or compatible dict) and weight is
    the source's observation count over the window. Each summary is
    expanded into weighted CDF knots (p50 puts half the source's mass
    at <= that value, and so on; the tail mass above the last knot sits
    AT the last knot's value — the merge under-reads extreme tails
    rather than inventing them), then the pooled knots answer
    nearest-rank queries. Exact when every source reports the same
    summary; approximate otherwise (bounded by the knot spacing).
    Returns {"p50": ..., ...} or None with no usable parts."""
    knots = []
    for weight, summ in parts:
        if not summ or not weight or weight <= 0:
            continue
        named = [(frac, summ.get(key)) for key, frac in _QKEYS
                 if summ.get(key) is not None]
        if not named:
            continue
        prev = 0.0
        for frac, val in named:
            knots.append((float(val), (frac - prev) * weight))
            prev = frac
        knots.append((float(named[-1][1]), (1.0 - prev) * weight))
    if not knots:
        return None
    knots.sort()
    total = sum(m for _, m in knots)
    out = {}
    for q in qs:
        target = q / 100.0 * total
        acc = 0.0
        res = knots[-1][0]
        for val, mass in knots:
            acc += mass
            if acc >= target - 1e-12:
                res = val
                break
        out[f"p{q:g}"] = res
    return out


# ---------------------------------------------------------------------------
# the store: bounded per-metric rings, derivations on read
# ---------------------------------------------------------------------------

class TimeSeriesStore:
    """Per-metric ring buffers of registry snapshots.

    Counters and gauges ring (t, value); histograms ring
    (t, cum_count, cum_sum, summary, fresh_samples) where
    `fresh_samples` are the raw observations that arrived since the
    previous tick (empty for scraped remote snapshots — the window
    quantiles then merge per-tick summaries instead). Thread-safe;
    reads copy under the lock and compute outside it."""

    def __init__(self, capacity=_DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        self._hists = {}
        self.ticks = 0
        self.last_tick = None

    def _ring(self, table, name):
        ring = table.get(name)
        if ring is None:
            ring = table[name] = collections.deque(maxlen=self.capacity)
        return ring

    def append_snapshot(self, snap, now=None, hist_samples=None,
                        hist_window_summaries=None):
        """Record one registry snapshot (registry.snapshot() shape) at
        time `now`; `hist_samples` maps histogram name -> fresh raw
        samples since the previous append (registry.tap_histograms).

        `hist_window_summaries` optionally overrides the per-tick
        quantile knots per histogram name: a scraped snapshot's
        summary is process-LIFETIME (it moves as slowly as the whole
        reservoir), so a scraper that also has the source's own
        windowed view (a replica's /debug/vars `timeseries` section)
        passes it here — the tick then carries window-local quantiles
        and this store's windowed merges react on the window's
        timescale, not the process's. Cumulative count/sum still come
        from the snapshot (they weight the merge)."""
        if now is None:
            now = time.time()
        hist_samples = hist_samples or {}
        hist_window_summaries = hist_window_summaries or {}
        with self._lock:
            for name, v in snap.get("counters", {}).items():
                self._ring(self._counters, name).append((now, float(v)))
            for name, v in snap.get("gauges", {}).items():
                if v is not None:
                    self._ring(self._gauges, name).append((now, float(v)))
            for name, s in snap.get("histograms", {}).items():
                fresh = tuple(hist_samples.get(name, ()))
                if len(fresh) > _MAX_TICK_SAMPLES:
                    fresh = fresh[-_MAX_TICK_SAMPLES:]
                knots = hist_window_summaries.get(name)
                if not isinstance(knots, dict):
                    knots = s
                self._ring(self._hists, name).append(
                    (now, int(s.get("count", 0) or 0),
                     float(s.get("sum", 0.0) or 0.0),
                     {k: knots.get(k) for k, _ in _QKEYS}, fresh))
            self.ticks += 1
            self.last_tick = now

    # -- name resolution ----------------------------------------------------

    def _matching(self, table, name, skip_labels=None):
        """Rings for `name`: the exact registry name, or — when the
        registry stores labeled variants (`name|k=v`) — every variant
        of that base name, minus the `skip_labels` ones."""
        with self._lock:
            exact = table.get(name)
            if exact is not None:
                return [list(exact)]
            out = []
            for full, ring in table.items():
                base, labels = _registry._split_labels(full)
                if base != name:
                    continue
                if skip_labels and any(
                        skip_labels.get(k) == v for k, v in labels):
                    continue
                out.append(list(ring))
            return out

    def points(self, name):
        """Raw ascending [(t, ...)] points for an exact metric name
        (counters/gauges: (t, v); histograms: the 5-tuple entries)."""
        with self._lock:
            for table in (self._counters, self._gauges, self._hists):
                ring = table.get(name)
                if ring is not None:
                    return list(ring)
        return []

    def names(self):
        with self._lock:
            return {"counters": sorted(self._counters),
                    "gauges": sorted(self._gauges),
                    "histograms": sorted(self._hists)}

    # -- derivations (the probe interface the SLO engine consumes) ----------

    def rate(self, name, window_s=None, now=None, skip_labels=None):
        """Summed per-second rate over every matching counter ring
        (labeled variants sum — a family's fleet-of-labels is one
        logical counter). None when nothing matches."""
        rates = [counter_rate(pts, window_s, now)
                 for pts in self._matching(self._counters, name,
                                           skip_labels)]
        rates = [r for r in rates if r is not None]
        return sum(rates) if rates else None

    def gauge_window(self, name, window_s=None, now=None,
                     skip_labels=None):
        """window_stats over matching gauge rings; labeled variants
        combine conservatively for alerting: last/mean/min sum across
        variants (totals), max is the max of the variants' maxima."""
        stats = [window_stats(pts, window_s, now)
                 for pts in self._matching(self._gauges, name,
                                           skip_labels)]
        stats = [s for s in stats if s is not None]
        if not stats:
            return None
        if len(stats) == 1:
            return stats[0]
        return {"last": sum(s["last"] for s in stats),
                "min": sum(s["min"] for s in stats),
                "max": max(s["max"] for s in stats),
                "mean": sum(s["mean"] for s in stats),
                "n": sum(s["n"] for s in stats)}

    def hist_window(self, name, window_s=None, now=None,
                    skip_labels=None):
        """Windowed {'count','mean','p50','p95','p99'} for a histogram:
        exact nearest-rank over the window's raw samples when the ticks
        carry them, else a weighted merge_quantiles over per-tick
        summaries (the scraped-remote shape). None when the window saw
        no observations."""
        rings = self._matching(self._hists, name, skip_labels)
        count = 0
        total = 0.0
        samples = []
        summary_parts = []
        for pts in rings:
            win = _window_slice(pts, window_s, now, keep_baseline=True)
            if not win:
                continue
            if len(win) >= 2:
                # adjacent-increase accumulation (_increase), NOT the
                # endpoint delta: a mid-window counter reset (replica
                # restart) must count both incarnations' observations,
                # never go negative — the same reset law counters use
                count += _increase([(e[0], e[1]) for e in win])
                total += _increase([(e[0], e[2]) for e in win])
            for prev, cur in zip(win, win[1:]):
                if cur[4]:
                    samples.extend(cur[4])
                else:
                    dd = cur[1] - prev[1]
                    w = cur[1] if dd < 0 else dd
                    if w > 0:
                        summary_parts.append((w, cur[3]))
        if count <= 0:
            return None
        out = {"count": int(count),
               "mean": (total / count) if count else None}
        if samples:
            samples.sort()
            for key, _ in _QKEYS:
                out[key] = _registry._nearest_rank(
                    samples, int(key[1:]))
        else:
            merged = merge_quantiles(summary_parts) or {}
            out.update(merged)
        return out

    def window(self, window_s=None, now=None):
        """Whole-store windowed view (debug_vars / `top` payload):
        {"counters": {name: {"rate","delta","total"}}, "gauges":
        {name: window_stats}, "histograms": {name: hist_window}}."""
        with self._lock:
            counters = {n: list(r) for n, r in self._counters.items()}
            gauges = {n: list(r) for n, r in self._gauges.items()}
            hist_names = list(self._hists)
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, pts in sorted(counters.items()):
            rate = counter_rate(pts, window_s, now)
            if rate is None and not pts:
                continue
            out["counters"][name] = {
                "rate": rate,
                "delta": counter_delta(pts, window_s, now),
                "total": pts[-1][1] if pts else None}
        for name, pts in sorted(gauges.items()):
            st = window_stats(pts, window_s, now)
            if st is not None:
                out["gauges"][name] = st
        for name in sorted(hist_names):
            hw = self.hist_window(name, window_s, now)
            if hw is not None:
                out["histograms"][name] = hw
        return out

    def series(self, name, window_s=None, now=None):
        """[[t, v]] display series for a counter/gauge (histograms:
        per-tick p99) over the trailing window."""
        with self._lock:
            if name in self._counters:
                pts = list(self._counters[name])
                kind = "counter"
            elif name in self._gauges:
                pts = list(self._gauges[name])
                kind = "gauge"
            elif name in self._hists:
                pts = list(self._hists[name])
                kind = "hist"
            else:
                return []
        pts = _window_slice(pts, window_s, now)
        if kind == "hist":
            return [[round(p[0], 3), p[3].get("p99")] for p in pts]
        return [[round(p[0], 3), p[1]] for p in pts]

    def clear(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self.ticks = 0
            self.last_tick = None


# ---------------------------------------------------------------------------
# the sampler thread
# ---------------------------------------------------------------------------

class Sampler:
    """Background registry sampler: one tick = snapshot + histogram tap
    into the store, then one SLO evaluation. `tick()` is public so
    tests and the fleet aggregator can drive time explicitly."""

    def __init__(self, interval_s, store=None, registry=None,
                 slo_engine=None):
        self.interval_s = float(interval_s)
        self.store = store if store is not None else TimeSeriesStore()
        self._registry = registry
        self.slo_engine = slo_engine
        self._hstates = {}
        self._stop = threading.Event()
        self._thread = None

    def tick(self, now=None):
        if now is None:
            now = time.time()
        reg = self._registry or _registry.global_registry()
        snap = reg.snapshot()
        fresh, self._hstates = reg.tap_histograms(
            self._hstates, cap=_MAX_TICK_SAMPLES)
        self.store.append_snapshot(snap, now, hist_samples=fresh)
        _registry.counter_inc("monitor.samples")
        if self.slo_engine is not None:
            self.slo_engine.evaluate(self.store, now=now)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:   # noqa: BLE001 — must survive
                print(f"metrics sampler tick failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name=SAMPLER_THREAD_NAME, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        return self

    def running(self):
        return self._thread is not None and self._thread.is_alive()


# ---------------------------------------------------------------------------
# module-level lifecycle (flag-driven)
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_store = TimeSeriesStore()
_sampler: Sampler | None = None


def store() -> TimeSeriesStore:
    """The process-global store the flag-configured sampler fills."""
    return _store


def sampler():
    return _sampler


def sampler_running():
    s = _sampler
    return bool(s is not None and s.running())


def configure(interval_s):
    """Start/stop/retune the global sampler — the `metrics_sample_s`
    flag side effect (flags.py). 0/None stops the thread (and is the
    default: an unconfigured process runs ZERO sampler threads and the
    registry write path is untouched). Idempotent for an unchanged
    interval. Returns the active Sampler or None."""
    global _sampler
    try:
        interval_s = float(interval_s or 0.0)
    except (TypeError, ValueError):
        interval_s = 0.0
    with _lock:
        old = _sampler
        if (old is not None and old.running()
                and abs(old.interval_s - interval_s) < 1e-9):
            return old
        _sampler = None
    if old is not None:
        old.stop()
    if interval_s <= 0:
        return None
    from . import slo as _slo
    engine = _slo.SloEngine(_slo.merged_rules(
        _slo.default_rules(), _slo.rules_from_flag(scope="local")))
    fresh = Sampler(interval_s, store=_store, slo_engine=engine)
    fresh.start()
    with _lock:
        _sampler = fresh
    return fresh


def stats(window_s=30.0):
    """The /debug/vars `timeseries` section: sampler state + the
    windowed store view + the SLO table. None when no sampler runs
    (the section is then absent — zero cost stays zero)."""
    s = _sampler
    if s is None or not s.running():
        return None
    out = {"interval_s": s.interval_s, "window_s": float(window_s),
           "ticks": s.store.ticks, "window": s.store.window(window_s)}
    if s.slo_engine is not None:
        out["slo"] = s.slo_engine.table()
    return out


def reset():
    """Tests: stop the sampler and empty the global store."""
    configure(0)
    _store.clear()
