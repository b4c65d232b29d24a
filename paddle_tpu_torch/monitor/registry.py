"""Structured metrics registry: counters, gauges, histograms.

The port's own copy of the registry core of `paddle_tpu/monitor/
registry.py`: the instruments the LM server records into, a snapshot
dict for `GET /metrics?format=json`, and the Prometheus text exposition
for `GET /metrics`. Recording is thread-safe (one registry lock). When
telemetry is disabled (the default; flag `metrics`, env
`PADDLE_TPU_METRICS`), the module-level helpers return before touching
the registry.
"""

from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "enabled",
           "set_enabled", "counter_inc", "gauge_set", "histogram_observe",
           "snapshot", "reset", "format_prometheus"]


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name, lock):
        self.name = name
        self.value = 0
        self._lock = lock

    def inc(self, n=1):
        with self._lock:
            self.value += n
        return self


class Gauge:
    """Last-value-wins instrument."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name, lock):
        self.name = name
        self.value = None
        self._lock = lock

    def set(self, v):
        with self._lock:
            self.value = float(v)
        return self


# A histogram that outgrows this many raw samples keeps every other one
# (count/sum/min/max stay exact; percentiles become a uniform subsample)
_HIST_MAX_SAMPLES = 65536


def _nearest_rank(sorted_samples, q):
    """Nearest-rank percentile (q in [0, 100]) of an ascending list."""
    if not sorted_samples:
        return None
    n = len(sorted_samples)
    rank = max(1, -(-int(q) * n // 100))
    return sorted_samples[min(rank, n) - 1]


class Histogram:
    """Streaming distribution with nearest-rank percentile summaries."""

    __slots__ = ("name", "count", "total", "min", "max", "_samples",
                 "_stride", "_skip", "_lock")

    def __init__(self, name, lock):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._samples = []
        self._stride = 1
        self._skip = 0
        self._lock = lock

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self._skip += 1
            if self._skip >= self._stride:
                self._skip = 0
                self._samples.append(v)
                if len(self._samples) >= _HIST_MAX_SAMPLES:
                    self._samples = self._samples[::2]
                    self._stride *= 2
        return self

    def summary(self):
        with self._lock:
            n, total = self.count, self.total
            mn, mx = self.min, self.max
            samples = sorted(self._samples)
        return {"count": n, "sum": total, "min": mn, "max": mx,
                "mean": total / n if n else None,
                "p50": _nearest_rank(samples, 50),
                "p95": _nearest_rank(samples, 95),
                "p99": _nearest_rank(samples, 99)}


class MetricsRegistry:
    """Name -> instrument table; creation and recording are locked."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        self._histograms = {}

    def counter(self, name):
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name,
                                                            self._lock))
        return c

    def gauge(self, name):
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name, self._lock))
        return g

    def histogram(self, name):
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, Histogram(name, self._lock))
        return h

    def snapshot(self):
        """{"counters": {name: int}, "gauges": {name: float},
        "histograms": {name: summary dict}}."""
        # Histogram.summary() re-takes the (non-reentrant) lock, so it
        # runs on the copy outside the critical section
        with self._lock:
            counters = {n: c.value for n, c in
                        sorted(self._counters.items())}
            gauges = {n: g.value for n, g in sorted(self._gauges.items())}
            hists = sorted(self._histograms.items())
        return {"counters": counters, "gauges": gauges,
                "histograms": {n: h.summary() for n, h in hists}}

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


def _prom_name(name):
    """Dotted registry names -> Prometheus [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def _split_labels(name):
    """`base|k=v;k2=v2` -> (base, [(k, v), ...])."""
    base, _, rest = name.partition("|")
    labels = []
    for item in rest.split(";") if rest else ():
        if item:
            k, _, v = item.partition("=")
            labels.append((k.strip(), v))
    return base, labels


def _escape_label_value(v):
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels):
    if not labels:
        return ""
    return ("{" + ",".join(f'{_prom_name(k)}="{_escape_label_value(v)}"'
                           for k, v in labels) + "}")


# HELP text for the serving_lm families; anything unlisted gets a
# generic line
_HELP = {
    "serving_lm.requests": "generation requests admitted to the queue",
    "serving_lm.rejected": "generation requests rejected at admission "
                           "(queue at queue_limit)",
    "serving_lm.deadline_shed": "generation requests shed because their "
                                "deadline lapsed while queued or between "
                                "decode steps",
    "serving_lm.completed": "generations finished (eos or length cap)",
    "serving_lm.client_disconnects": "generations cancelled because the "
                                     "streaming client vanished",
    "serving_lm.errors": "generations failed by a scheduler/step error",
    "serving_lm.tokens": "tokens decoded and streamed to clients",
    "serving_lm.prefills": "prefill dispatches",
    "serving_lm.decode_steps": "fused decode steps",
    "serving_lm.ttft_s": "time to first token: submit -> first token",
    "serving_lm.inter_token_s": "gap between consecutive streamed tokens "
                                "of one request",
    "serving_lm.request_latency_s": "generation submit -> finish seconds",
    "serving_lm.prefill_s": "prefill dispatch seconds",
    "serving_lm.decode_step_s": "one fused decode-step dispatch in "
                                "seconds",
    "serving_lm.prefill_batch_size": "prompts per prefill dispatch",
    "serving_lm.queue_depth": "generation requests waiting for a slot",
    "serving_lm.live_slots": "KV-cache slots currently decoding",
    "serving_lm.kv_occupancy": "filled fraction of the KV cache",
    "serving_lm.kv_cache_bytes": "bytes of the preallocated KV planes",
    "serving_lm.admitted_mid_flight": "prompts admitted into an in-flight "
                                      "decode batch",
    "serving_lm.warmup_s": "per-rung warmup seconds (rung= label)",
    "serving_lm.kv_pages_free": "KV pages on the pool free list",
    "serving_lm.kv_pages_live": "KV pages referenced by live sequences",
    "serving_lm.kv_pages_cached": "KV pages held only by the prefix cache",
    "serving_lm.kv_pages_reserved": "free pages promised to live "
                                    "sequences' worst-case growth",
    "serving_lm.kv_pages_occupancy": "in-use fraction of the KV page pool",
    "serving_lm.prefix_hits": "admissions that reused cached prefix pages",
    "serving_lm.prefix_hit_rate": "prefix-cache hit fraction",
    "serving_lm.prefix_tokens_saved": "prompt tokens whose prefill was "
                                      "skipped via prefix-cache hits",
    "serving_lm.cow_splits": "copy-on-write page copies",
}


def format_prometheus(snap):
    """Prometheus text exposition 0.0.4 of a snapshot dict: one HELP +
    TYPE header per family; histograms render as summaries."""
    lines = []

    def emit(section, mtype, render):
        items = sorted((_split_labels(n) + (v,) for n, v in section.items()),
                       key=lambda t: (t[0], t[1]))
        last = None
        for base, labels, v in items:
            pn = _prom_name(base)
            if pn != last:
                last = pn
                text = _HELP.get(base, "paddle_tpu_torch metric " + base)
                lines.append(f"# HELP {pn} {text}")
                lines.append(f"# TYPE {pn} {mtype}")
            render(pn, labels, v)

    def scalar(pn, labels, v):
        lines.append(f"{pn}{_label_str(labels)} {v}")

    def summary(pn, labels, s):
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            if s.get(key) is not None:
                lines.append(f"{pn}{_label_str(labels + [('quantile', q)])}"
                             f" {s[key]}")
        ls = _label_str(labels)
        lines.append(f"{pn}_count{ls} {s.get('count', 0)}")
        lines.append(f"{pn}_sum{ls} {s.get('sum', 0.0)}")

    emit(snap.get("counters", {}), "counter", scalar)
    emit({n: v for n, v in snap.get("gauges", {}).items() if v is not None},
         "gauge", scalar)
    emit(snap.get("histograms", {}), "summary", summary)
    return "\n".join(lines) + "\n"


_REGISTRY = MetricsRegistry()

# None = not yet resolved from the `metrics` flag
_ENABLED = None


def set_enabled(on):
    global _ENABLED
    _ENABLED = bool(on)
    return _ENABLED


def enabled():
    """Is telemetry recording on? Resolves the `metrics` flag once."""
    if _ENABLED is None:
        from .. import flags
        set_enabled(flags.get("metrics"))
    return _ENABLED


def counter_inc(name, n=1):
    if not (_ENABLED if _ENABLED is not None else enabled()):
        return
    _REGISTRY.counter(name).inc(n)


def gauge_set(name, v):
    if not (_ENABLED if _ENABLED is not None else enabled()):
        return
    _REGISTRY.gauge(name).set(v)


def histogram_observe(name, v):
    if not (_ENABLED if _ENABLED is not None else enabled()):
        return
    _REGISTRY.histogram(name).observe(v)


def snapshot():
    return _REGISTRY.snapshot()


def reset():
    _REGISTRY.reset()
