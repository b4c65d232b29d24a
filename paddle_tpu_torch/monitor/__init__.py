"""Telemetry for the port: metrics registry and correlated spans.

The slice of `paddle_tpu/monitor` the LM server calls:

    from paddle_tpu_torch import monitor
    monitor.counter_inc("serving_lm.tokens")
    monitor.histogram_observe("serving_lm.ttft_s", dt)
    with monitor.span("serving_lm/prefill", attrs={...}):
        ...
    sp = monitor.start_span("serving_lm/request", trace_id=tid)
    monitor.snapshot() / monitor.format_prometheus(snap)   # /metrics

Enablement: flag `metrics` (env PADDLE_TPU_METRICS=1) gates the
registry and the spans. `blackbox.maybe_dump` is a documented no-op
until the flight recorder is ported.
"""

from __future__ import annotations

from . import blackbox, registry, spans
from .registry import (counter_inc, enabled, format_prometheus, gauge_set,
                       histogram_observe, reset, set_enabled, snapshot)
from .spans import Span, new_trace_id, span, start_span

__all__ = ["counter_inc", "gauge_set", "histogram_observe", "enabled",
           "set_enabled", "snapshot", "reset", "format_prometheus",
           "span", "start_span", "new_trace_id", "Span", "blackbox",
           "registry", "spans"]
