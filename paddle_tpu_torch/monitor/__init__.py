"""Unified telemetry for the port: metrics registry, correlated spans,
Chrome-trace export, flight recorder, time series and SLOs, model
health, device introspection and per-op device attribution.

The port's own copy of `paddle_tpu/monitor`, with the same names, flags
and payloads (the device-facing modules read `torch.cuda` and
`torch.profiler` where the reference reads PJRT and XLA):

    from paddle_tpu_torch import monitor
    monitor.counter_inc("serving_lm.tokens")
    monitor.histogram_observe("serving_lm.ttft_s", dt)
    with monitor.span("serving_lm/prefill", attrs={...}):
        ...
    sp = monitor.start_span("serving_lm/request", trace_id=tid)
    monitor.blackbox.maybe_dump("nan_guard", err)  # post-mortem bundle
    monitor.introspect.debug_vars(engine)          # /debug/vars payload
    monitor.snapshot() / monitor.format_prometheus(snap)   # /metrics

Enablement: flag `metrics` (env PADDLE_TPU_METRICS=1) gates the
registry, the spans and the flight recorder; flag `trace_path`
(PADDLE_TPU_TRACE_PATH=/tmp/t.json) starts an ambient host trace
written at exit (spans also record while it runs); flag `blackbox_dir`
(PADDLE_TPU_BLACKBOX_DIR=...) makes escalation paths dump
blackbox-<ts>.json bundles; flag `metrics_sample_s` runs the
time-series sampler and the SLO engine; flag `profile_sample_n` makes
the one-shot engine sample its dispatches (monitor/deviceprof.py).
Every one is off by default.
"""

from __future__ import annotations

from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       counter_inc, dump_json, dump_jsonl, enabled,
                       format_prometheus, format_snapshot, format_table,
                       gauge_set, global_registry, histogram_observe,
                       reset, set_enabled, snapshot)
from .trace import TraceBuilder, instant
from .spans import (Span, SpanContext, attach, current_context,
                    new_trace_id, span, start_span)
from . import (blackbox, deviceprof, health, introspect, slo, spans,
               timeseries, trace)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "counter_inc", "gauge_set", "histogram_observe",
           "enabled", "set_enabled", "global_registry",
           "snapshot", "reset", "dump_jsonl", "dump_json",
           "format_table", "format_snapshot", "format_prometheus",
           "TraceBuilder", "trace", "span", "instant", "maybe_dump",
           "Span", "SpanContext", "start_span", "attach",
           "current_context", "new_trace_id",
           "spans", "blackbox", "introspect", "health",
           "timeseries", "slo", "deviceprof"]


def maybe_dump():
    """Write the registry to the `metrics_path` flag destination (JSON
    snapshot; a .jsonl suffix selects JSON lines). No-op when the flag
    is empty or telemetry is off. The serve CLI calls this on exit."""
    from .. import flags
    if not enabled():
        return None
    path = flags.get("metrics_path")
    if not path:
        return None
    if path.endswith(".jsonl"):
        return dump_jsonl(path)
    return dump_json(path)
