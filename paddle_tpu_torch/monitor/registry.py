"""Structured metrics registry: counters, gauges, histograms.

The port's own copy of `paddle_tpu/monitor/registry.py`, whole: the
same instruments, snapshot dict, JSON / JSON-lines dumps, pretty table
and Prometheus exposition (summaries plus native `_hist` buckets), and
the same HELP text for every family both packages record, so one
dashboard reads either package's replica.

  * Counter    — monotonically increasing tally. `inc(n)`.
  * Gauge      — last-written value (samples/sec, queue depth). `set(v)`.
  * Histogram  — streaming distribution with p50/p95/p99 summaries
                 (step time, checkpoint durations). `observe(v)`.

Recording is thread-safe (one registry lock; the executor and the device
pipeline's worker thread record concurrently). When telemetry is
disabled (the default — flag `metrics` / env `PADDLE_TPU_METRICS`), the
module-level helpers return before touching the registry: no metric
objects are created, no lock is taken, nothing allocates.
"""

from __future__ import annotations

import contextlib
import json
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "global_registry", "enabled", "set_enabled",
           "counter_inc", "gauge_set", "histogram_observe",
           "snapshot", "reset", "dump_jsonl", "dump_json",
           "format_table", "format_snapshot", "format_prometheus"]


class Counter:
    """Monotonic counter. Use through the registry for thread safety."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name, lock):
        self.name = name
        self.value = 0
        self._lock = lock

    def inc(self, n=1):
        with self._lock:
            self.value += n
        return self

    def get(self):
        return self.value


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

    def get(self):
        return self.value


# When a histogram outgrows this many raw samples it is compacted by
# keeping every other observation (count/sum/min/max stay exact; the
# percentiles become a uniform 2x/4x/... subsample — fine for the
# step-time distributions this exists for, and it bounds memory on
# million-step runs).
_HIST_MAX_SAMPLES = 65536


def _nearest_rank(sorted_samples, q):
    """Nearest-rank percentile (q in [0, 100]) of an ascending list —
    the ONE formula percentile() and summary() share."""
    if not sorted_samples:
        return None
    n = len(sorted_samples)
    rank = max(1, -(-int(q) * n // 100))     # ceil(q/100 * n)
    return sorted_samples[min(rank, n) - 1]


# Prometheus native-histogram bucket ladder: the client-library default
# (5 ms .. 10 s, latency-shaped — this registry's histograms are
# dominated by durations), extended upward by powers of ten until the
# ladder covers the observed maximum so no real sample lands only in
# +Inf.
_BUCKET_BASE = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0)


def _cum_buckets(sorted_samples, count):
    """Cumulative le-bucket counts for the Prometheus histogram view:
    [[le, cum], ...] over the (possibly subsampled) sample stream,
    scaled back to the true observation count — `_count` and the
    largest finite bucket stay consistent by construction."""
    if not sorted_samples or not count:
        return []
    import bisect
    ladder = list(_BUCKET_BASE)
    top = sorted_samples[-1]
    while ladder[-1] < top and len(ladder) < 40:
        ladder.append(ladder[-1] * 10.0)
    scale = count / len(sorted_samples)
    return [[le, int(round(
        bisect.bisect_right(sorted_samples, le) * scale))]
        for le in ladder]


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
        self._stride = 1      # record every _stride-th observation
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

    def percentile(self, q):
        """Nearest-rank percentile of the (possibly subsampled) stream;
        q in [0, 100]. None when empty."""
        with self._lock:
            samples = sorted(self._samples)
        return _nearest_rank(samples, q)

    def summary(self):
        with self._lock:
            n, total = self.count, self.total
            mn, mx = self.min, self.max
            samples = sorted(self._samples)   # one sort for all ranks
        return {"count": n, "sum": total, "min": mn, "max": mx,
                "mean": total / n if n else None,
                "p50": _nearest_rank(samples, 50),
                "p95": _nearest_rank(samples, 95),
                "p99": _nearest_rank(samples, 99),
                # native cumulative buckets for the Prometheus
                # exposition ([[le, cum_count], ...]): computed from the
                # sample tap, scaled back to the true count when the
                # stream has been subsampled
                "buckets": _cum_buckets(samples, n)}

    def tap(self, state):
        """Fresh raw samples since the previous tap (the time-series
        sampler's per-tick feed). `state` is an opaque (stride, length)
        cursor from the prior call; None starts a cursor AT the current
        position (no backfill). When the stream was compacted between
        taps the exact increment is unrecoverable — the cursor is
        rescaled onto the new stride and the (uniform) subsample tail
        is returned instead, which keeps windowed quantiles honest at
        reduced resolution."""
        with self._lock:
            n, stride = len(self._samples), self._stride
            if state is None:
                return (stride, n), []
            s0, n0 = state
            if s0 == stride and n0 <= n:
                return (stride, n), list(self._samples[n0:])
            factor = stride // s0 if (s0 and stride > s0
                                      and stride % s0 == 0) else 1
            return (stride, n), list(self._samples[n0 // factor:])


class MetricsRegistry:
    """Name -> instrument table; creation and recording are locked."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        self._histograms = {}

    # -- instrument access (create on first use) ---------------------------
    def counter(self, name) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name,
                                              Counter(name, self._lock))
        return c

    def gauge(self, name) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name, self._lock))
        return g

    def histogram(self, name) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, Histogram(name, self._lock))
        return h

    def remove_gauge(self, name):
        """Drop a gauge (bounded-cardinality callers evicting a labeled
        series must also stop exporting it)."""
        with self._lock:
            self._gauges.pop(name, None)

    def tap_histograms(self, states=None, cap=256):
        """Fresh raw samples per histogram since the previous tap (the
        time-series sampler's per-tick feed): returns
        ({name: samples}, new_states). Pass the returned states back on
        the next call; histograms created between taps start their
        cursor at the current position. Each histogram's per-tap yield
        is capped at the newest `cap` samples."""
        states = states or {}
        with self._lock:
            hists = list(self._histograms.items())
        fresh, new_states = {}, {}
        # Histogram.tap takes the shared registry lock itself, so it
        # must run OUTSIDE the critical section above (same pattern as
        # snapshot() running summary() on the copy)
        for name, h in hists:
            new_states[name], samples = h.tap(states.get(name))
            if samples:
                fresh[name] = samples[-int(cap):]
        return fresh, new_states

    # -- export ------------------------------------------------------------
    def snapshot(self):
        """Plain-dict view: {"counters": {name: int}, "gauges":
        {name: float}, "histograms": {name: summary dict}}."""
        # copy under the lock: a recording thread creating a first-seen
        # metric mid-export must not blow up the dict iteration.
        # Histogram.summary() re-takes the same (non-reentrant) lock, so
        # it runs on the copy outside the critical section.
        with self._lock:
            counters = {n: c.value for n, c in
                        sorted(self._counters.items())}
            gauges = {n: g.value for n, g in sorted(self._gauges.items())}
            hists = sorted(self._histograms.items())
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {n: h.summary() for n, h in hists},
        }

    def dump_jsonl(self, fileobj):
        """One JSON object per line: {"type", "name", ...payload}."""
        snap = self.snapshot()
        for name, v in snap["counters"].items():
            fileobj.write(json.dumps(
                {"type": "counter", "name": name, "value": v}) + "\n")
        for name, v in snap["gauges"].items():
            fileobj.write(json.dumps(
                {"type": "gauge", "name": name, "value": v}) + "\n")
        for name, s in snap["histograms"].items():
            fileobj.write(json.dumps(
                {"type": "histogram", "name": name, **s}) + "\n")

    def format_table(self):
        """Human-readable dump (cli.py `metrics` without --json)."""
        return format_snapshot(self.snapshot())

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


def format_snapshot(snap):
    """Render a snapshot dict (live, or reloaded from a dump file) as
    the pretty table — ONE formatter for both views, so live and file
    renderings cannot drift."""
    fmt = lambda x: "-" if x is None else f"{x:.6g}"   # noqa: E731
    lines = ["== counters =="]
    for n, v in sorted(snap.get("counters", {}).items()):
        lines.append(f"  {n:<44}{v:>16}")
    lines.append("== gauges ==")
    for n, v in sorted(snap.get("gauges", {}).items()):
        lines.append(f"  {n:<44}{v!s:>16}")
    lines.append("== histograms ==")
    for n, s in sorted(snap.get("histograms", {}).items()):
        lines.append(
            f"  {n:<44} count={s.get('count')} "
            f"mean={fmt(s.get('mean'))} p50={fmt(s.get('p50'))} "
            f"p95={fmt(s.get('p95'))} p99={fmt(s.get('p99'))} "
            f"max={fmt(s.get('max'))}")
    return "\n".join(lines)


def _prom_name(name):
    """Metric names here are dotted (serving.queue_depth); Prometheus
    names are [a-zA-Z_:][a-zA-Z0-9_:]* — dots and dashes map to '_'."""
    out = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def _split_labels(name):
    """Registry names may carry labels after '|' as k=v pairs joined by
    ';' (e.g. `device.mem_in_use_bytes|device=TPU_0`): the registry
    stays a flat name->instrument table while the Prometheus view gets
    real labeled series. Returns (base_name, [(key, value), ...])."""
    base, _, rest = name.partition("|")
    labels = []
    if rest:
        for item in rest.split(";"):
            if not item:
                continue
            k, _, v = item.partition("=")
            labels.append((k.strip(), v))
    return base, labels


def _escape_label_value(v):
    """Prometheus text-format label-value escaping: backslash, double
    quote, and line feed (in that order — the backslash first so the
    other escapes are not double-escaped)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text):
    """# HELP escaping: backslash and line feed only (quotes are legal)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(labels):
    if not labels:
        return ""
    return ("{" + ",".join(
        f'{_prom_name(k)}="{_escape_label_value(v)}"'
        for k, v in labels) + "}")


# HELP text for the well-known metric families; anything unlisted gets a
# generic line (the spec wants *a* HELP line, not literature).
_HELP = {
    "executor.runs": "Executor.run invocations",
    "executor.cache_hit": "executor compile-cache hits",
    "executor.cache_miss": "executor compile-cache misses (trace+build)",
    "executor.compile_time_s": "program trace+build seconds",
    "executor.compile_last_s": "last trace+build seconds per signature",
    "executor.run_time_s": "per-run wall seconds through fetch",
    "executor.feed_bytes": "bytes fed to the executor",
    "executor.nan_guard_trips": "check_nan_inf guard trips",
    "executor.compiled_signatures": "compile-stats table admissions "
                                    "(evicted signatures recount)",
    "executor.compile_source": "XLA compiles by origin: source="
                               "persistent = executable loaded from "
                               "the compile_cache_dir persistent "
                               "cache, source=fresh = compiled now "
                               "(and written for the next boot)",
    "trainer.step_time_s": "supervised train-step wall seconds",
    "trainer.pass_time_s": "training pass wall seconds",
    "trainer.samples_per_sec": "instantaneous training throughput",
    "serving.requests": "requests admitted",
    "serving.queue_depth": "requests waiting in the admission queue",
    "serving.batch_size": "formed batch sizes (rows)",
    "serving.batch_latency_s": "batch formation+dispatch seconds",
    "serving.request_latency_s": "request enqueue->fulfill seconds",
    "serving.padding_waste": "padded fraction of dispatched rows",
    "serving.warmup_s": "per-rung warmup seconds (rung= label; AOT "
                        "rungs deserialize in ~ms, fresh compiles in "
                        "seconds — the cold-start signature)",
    "fleet.requests": "requests accepted by the fleet router",
    "fleet.hops": "request forwards attempted (includes retries)",
    "fleet.retries": "extra hops after a failed forward",
    "fleet.failovers": "requests that succeeded after >=1 failed hop",
    "fleet.shed": "429 replies: every routable replica saturated",
    "fleet.unavailable": "503 replies: no routable replica / retry "
                         "budget exhausted on failures",
    "fleet.deadline_exceeded": "504 replies: deadline lapsed while "
                               "routing",
    "fleet.breaker_opens": "circuit-breaker closed/half-open -> open "
                           "transitions",
    "fleet.breaker_closes": "circuit-breaker half-open -> closed "
                            "recoveries",
    "fleet.ejections": "replicas ejected on lease expiry",
    "fleet.registrations": "replica joins (not heartbeats)",
    "fleet.deregistrations": "graceful replica leaves",
    "fleet.restarts": "crashed replicas respawned by the supervisor",
    "fleet.replica_giveups": "replicas abandoned after exhausting the "
                             "consecutive-restart budget",
    "fleet.swaps": "replicas replaced by a rolling version swap",
    "fleet.live_replicas": "lease-live registered replicas",
    "fleet.ready_replicas": "replicas currently routable",
    "fleet.hop_latency_s": "per-forward wall seconds",
    "fleet.giveup": "1 while the replica= slot is abandoned (restart "
                    "budget exhausted) — alertable via slo_rules; the "
                    "autoscaler backfills the lost capacity",
    "fleet.slots_added": "replica slots added by autoscale scale-ups "
                         "and giveup backfills",
    "fleet.slots_removed": "replica slots removed by drain-safe "
                           "autoscale scale-downs",
    "fleet.streams": "completed /v1/generate stream relays through "
                     "the router",
    "fleet.stream_upstream_errors": "token streams whose replica died "
                                    "mid-stream (relayed as an in-band "
                                    "error event — a generation is not "
                                    "idempotent, so no failover)",
    "fleet.client_disconnects": "token-stream clients that vanished "
                                "mid-relay (the router closes the "
                                "upstream hop so the replica cancels "
                                "the generation)",
    "autoscale.decisions": "autoscale controller ticks (every tick is "
                           "exactly one of scale_ups / scale_downs / "
                           "holds: the counts always sum to this)",
    "autoscale.scale_ups": "decisions that added a replica slot",
    "autoscale.scale_downs": "decisions that drain-removed a replica "
                             "slot",
    "autoscale.holds": "decisions that kept the fleet size (includes "
                       "hold-clock waits, cooldowns, bounds, and "
                       "no-data freezes)",
    "autoscale.backfills": "scale-ups that replaced a given-up "
                           "replica's lost capacity (bypass the hold "
                           "clock: restoring min_replicas is not "
                           "growth)",
    "autoscale.no_data": "ticks frozen because the dashboard carried "
                         "no usable signals (hold clocks reset — a "
                         "blind controller never acts on staleness)",
    "autoscale.current_replicas": "live (non-given-up) replica slots "
                                  "under supervision",
    "autoscale.target_replicas": "replica count the last autoscale "
                                 "decision wanted",
    "feed.batches": "batches delivered by the device input pipeline",
    "feed.bytes": "host->device bytes shipped by the input pipeline",
    "feed.bytes_per_sec": "achieved input-pipeline bandwidth since its "
                          "first delivered batch",
    "feed.queue_depth": "converted batches waiting in the host staging "
                        "buffer (ahead of device_put)",
    "feed.device_queue_depth": "device-resident batches queued ahead "
                               "of the consumer",
    "feed.staging_time_s": "per-batch host convert/cast seconds "
                           "(worker stage)",
    "feed.device_put_time_s": "per-batch device_put dispatch seconds "
                              "(device stage)",
    "feed.wait_time_s": "consumer wait-for-data seconds per batch",
    "feed.stalls": "consumer arrivals that found the device queue "
                   "empty (feed-bound steps; excludes the first fill)",
    "feed.workers": "convert worker threads of the active input "
                    "pipeline (0 = synchronous fallback)",
    "device.mem_in_use_bytes": "device memory in use (per device)",
    "device.mem_peak_bytes": "peak device memory in use (per device)",
    "device.mem_in_use_bytes_total": "device memory in use, all devices",
    "monitor.spans": "spans recorded by the flight recorder",
    "health.grad_norm": "global L2 norm over all gradients (in-graph)",
    "health.param_norm": "global L2 norm over post-update parameters",
    "health.update_ratio": "per-parameter update ratio ||dw||/||w||",
    "health.update_ratio_max": "largest per-parameter update ratio",
    "health.update_ratio_mean": "mean per-parameter update ratio",
    "health.loss_ema": "exponential moving average of the training loss",
    "health.steps": "steps observed by the health monitor",
    "perf.mfu": "model FLOP utilization: Program-op FLOPs / (step time "
                "x peak FLOPs); device label 'cpu-smoke' = formula "
                "check only, not a binding on-chip number",
    "perf.flops_per_sec": "Program-op FLOP tally over measured step "
                          "time",
    "perf.step_flops": "static Program-op FLOP tally per step",
    "perf.peak_flops": "peak FLOP/s of the detected device (denominator "
                       "of perf.mfu)",
    "quant.quantized_ops": "ops rewritten to int8 quant_* twins in the "
                           "active quantized model",
    "quant.dequant_ops": "quantized ops executing via weight dequant at "
                         "the op boundary (conv/embedding/stack planes; "
                         "matmuls on the CPU fold-to-f32 core)",
    "quant.bytes_saved": "weight bytes saved by int8 quantization "
                         "(f32 minus int8+scales)",
    "quant.artifacts_loaded": "quantized artifacts loaded by serving "
                              "(meta carried a quant section)",
    "quant.fallback_ops": "quantized ops this runtime could not execute "
                          "and dequantized back to f32 at load "
                          "(foreign quantizer kernel — warn, never "
                          "crash the boot)",
    "monitor.samples": "time-series sampler ticks (registry snapshots "
                       "taken into the windowed ring buffers)",
    "slo.firing": "1 while the rule= SLO alert is firing, 0 once it "
                  "has cleared (hysteresis: fires only after the "
                  "breach holds for_s, clears only past the separate "
                  "clear threshold)",
    "slo.fired": "SLO alert firing transitions (episodes started)",
    "slo.cleared": "SLO alert clear transitions (episodes ended)",
    "slo.rules": "SLO rules installed in this process's engine",
    "slo.rule_errors": "SLO rule evaluations that raised and were "
                       "skipped for the tick (the rule is isolated, "
                       "the sampler survives)",
    "serving.deadline_shed": "requests shed because their deadline "
                             "lapsed while queued or at dispatch "
                             "(never computed)",
    "serving.rejected": "requests rejected at admission "
                        "(queue at queue_limit)",
    "serving.errors": "requests failed by a batch execution error",
    "serving.compiled_shapes": "distinct dispatch shapes the engine "
                               "has compiled (should equal warmed "
                               "buckets)",
    "fleet.series.queue_depth": "fleet-total admission queue depth "
                                "(sum of every scraped replica's "
                                "serving.queue_depth)",
    "fleet.series.requests_per_sec": "fleet-total admitted request "
                                     "rate (sum of per-replica "
                                     "reset-tolerant rates)",
    "fleet.series.shed_per_sec": "router-minted typed-reply rate "
                                 "(429 shed + 503 unavailable + 504 "
                                 "deadline) — the client-visible shed",
    "fleet.series.latency_p99_s": "fleet-merged windowed request p99 "
                                  "(weighted quantile merge across "
                                  "replicas)",
    "fleet.series.replicas_scraped": "replicas whose /debug/vars the "
                                     "last aggregation tick scraped "
                                     "successfully",
    "serving.device_time": "sampled dispatch device time in seconds "
                           "(1-in-profile_sample_n batches, CUDA "
                           "events around the dispatch on the card, "
                           "host-timed on the CPU), per bucket rung via "
                           "|rung= — alertable through slo_rules like "
                           "any histogram family",
    "deviceprof.sampled_batches": "serving batches elected by the "
                                  "1-in-N device-time sampler",
    "deviceprof.captures": "full per-op device-trace captures parsed "
                           "into an attribution table (profile runs + "
                           "rate-limited serving captures)",
    "deviceprof.capture_errors": "device-trace captures that failed to "
                                 "start, stop, or parse (warn-not-"
                                 "crash: the batch still completed)",
    "deviceprof.coverage": "fraction of measured device/step time "
                           "attributed to named Program ops by the "
                           "last capture (chip_smoke.py holds >=0.90 "
                           "on an amp GPT-2-small step)",
    "profiler.traces_pruned": "old profiler-run subdirectories removed "
                              "from trace_dir by the retention cap "
                              "(profiler.TRACE_RETAIN)",
    "analysis.warnings": "Program-IR verifier warnings (executor "
                         "PADDLE_TPU_VALIDATE hook)",
    "analysis.audit_runs": "jaxpr auditor runs (PT7xx, per traced "
                           "signature)",
    "analysis.audit_warnings": "jaxpr auditor warning findings",
    "analysis.audit_findings": "auditor findings per |code= PT### "
                               "label",
    "analysis.audit_flops": "static per-step FLOP tally of the audited "
                            "program (|program= label)",
    "analysis.audit_peak_hbm_bytes": "static peak-HBM estimate of the "
                                     "audited program (|program= "
                                     "label)",
    "analysis.parallel_audit_runs": "parallel-audit (PT8xx) runs — "
                                    "audits whose traced step "
                                    "contained shard_map regions",
    "analysis.audit_comm_bytes": "static per-step collective wire "
                                 "bytes attributed to one mesh axis "
                                 "(|axis= label; ring-algorithm "
                                 "factors, the PT821 tally)",
    "analysis.parallel_regions": "shard_map regions in the audited "
                                 "step (|program= label)",
    "analysis.parallel_collectives": "collective ops across the "
                                     "audited step's SPMD regions "
                                     "(|program= label)",
    "serving_lm.requests": "generation requests admitted to the queue",
    "serving_lm.rejected": "generation requests rejected at admission "
                           "(queue at queue_limit)",
    "serving_lm.deadline_shed": "generation requests shed because "
                                "their deadline lapsed while queued or "
                                "between decode steps (the slot is "
                                "freed mid-generation)",
    "serving_lm.completed": "generations finished (eos or length cap)",
    "serving_lm.client_disconnects": "generations cancelled because "
                                     "the streaming client vanished "
                                     "(slot freed at the next decode-"
                                     "step boundary instead of "
                                     "generating for nobody)",
    "serving_lm.errors": "generations failed by a scheduler/step error",
    "serving_lm.tokens": "tokens decoded and streamed to clients",
    "serving_lm.prefills": "prefill dispatches (one ragged prompt "
                           "batch each, padded to bucket rungs)",
    "serving_lm.decode_steps": "fused decode steps (one token for "
                               "EVERY live slot per step)",
    "serving_lm.ttft_s": "time to first token: submit -> first token "
                         "streamed (queue wait + prefill)",
    "serving_lm.inter_token_s": "gap between consecutive streamed "
                                "tokens of one request (the decode-"
                                "step cadence a reader perceives)",
    "serving_lm.request_latency_s": "generation submit -> finish "
                                    "seconds (all tokens)",
    "serving_lm.prefill_s": "prefill dispatch seconds (per padded "
                            "prompt batch)",
    "serving_lm.decode_step_s": "one fused decode-step dispatch in "
                                "seconds",
    "serving_lm.prefill_batch_size": "prompts per prefill dispatch "
                                     "(pre-padding, the ragged truth)",
    "serving_lm.queue_depth": "generation requests waiting for a slot",
    "serving_lm.live_slots": "KV-cache slots currently decoding",
    "serving_lm.kv_occupancy": "filled fraction of the slotted KV "
                               "cache (live tokens / slots*cache_len)",
    "serving_lm.kv_cache_bytes": "bytes of the preallocated slotted "
                                 "KV-cache planes (priced against the "
                                 "PT721 HBM estimate at boot)",
    "serving_lm.admitted_mid_flight": "prompts admitted into an "
                                      "in-flight decode batch (slots "
                                      "were live when they prefilled) "
                                      "— continuous batching working",
    "serving_lm.warmup_s": "per-rung warmup seconds (rung= label; AOT "
                           "rungs read instead of compile)",
    "serving_lm.kv_pages_free": "KV pages on the pool free list "
                                "(paged engine; excludes the trash "
                                "page)",
    "serving_lm.kv_pages_live": "KV pages referenced by live "
                                "sequences' page tables",
    "serving_lm.kv_pages_cached": "KV pages held ONLY by the prefix "
                                  "cache — evictable on demand at "
                                  "admission",
    "serving_lm.kv_pages_reserved": "free-list pages promised to live "
                                    "sequences' worst-case growth "
                                    "(the deadlock-free admission "
                                    "ledger)",
    "serving_lm.kv_pages_occupancy": "in-use fraction of the KV page "
                                     "pool (1 - free/total)",
    "serving_lm.prefix_hits": "admissions that reused a cached "
                              "prompt-prefix's KV pages instead of "
                              "recomputing them",
    "serving_lm.prefix_hit_rate": "prefix-cache hit fraction over "
                                  "paged admissions",
    "serving_lm.prefix_tokens_saved": "prompt tokens whose prefill "
                                      "compute was skipped via "
                                      "prefix-cache hits",
    "serving_lm.cow_splits": "copy-on-write page copies (a "
                             "full-prompt hit owning its partial "
                             "tail page before the first decode "
                             "write)",
}


def format_prometheus(snap):
    """Render a snapshot dict in the Prometheus text exposition format
    0.0.4 (the serving front end's GET /metrics): one `# HELP` +
    `# TYPE` header per family, label values escaped per spec, all of a
    family's series in one contiguous group. Counters and gauges map
    directly; histograms become summaries — nearest-rank quantile
    series plus <name>_count / <name>_sum (the registry keeps samples,
    not fixed buckets)."""
    lines = []

    def emit(section, mtype, render):
        # group label variants under ONE family header: sort by the
        # base name first so `m` and `m|dev=0` stay adjacent even when
        # another family sorts between their raw names
        items = sorted((_split_labels(n) + (v,)
                        for n, v in section.items()),
                       key=lambda t: (t[0], t[1]))
        last_family = None
        for base, labels, v in items:
            pn = _prom_name(base)
            if pn != last_family:
                last_family = pn
                lines.append(f"# HELP {pn} "
                             f"{_escape_help(_HELP.get(base, 'paddle_tpu metric ' + base))}")
                lines.append(f"# TYPE {pn} {mtype}")
            render(pn, labels, v)

    def render_scalar(pn, labels, v):
        lines.append(f"{pn}{_label_str(labels)} {v}")

    def render_summary(pn, labels, s):
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            if s.get(key) is not None:
                lines.append(
                    f"{pn}{_label_str(labels + [('quantile', q)])} "
                    f"{s[key]}")
        ls = _label_str(labels)
        lines.append(f"{pn}_count{ls} {s.get('count', 0)}")
        lines.append(f"{pn}_sum{ls} {s.get('sum', 0.0)}")

    def render_native(pn, labels, s):
        # a family may not be TYPE summary AND histogram at once, so
        # the native cumulative view lives under its own `_hist`
        # family; cumulative counts are scaled-from-subsample ints and
        # the +Inf bucket equals _count by construction
        for le, cum in s.get("buckets", ()):
            lines.append(
                f"{pn}_bucket"
                f"{_label_str(labels + [('le', f'{le:g}')])} {cum}")
        lines.append(
            f"{pn}_bucket{_label_str(labels + [('le', '+Inf')])} "
            f"{s.get('count', 0)}")
        ls = _label_str(labels)
        lines.append(f"{pn}_sum{ls} {s.get('sum', 0.0)}")
        lines.append(f"{pn}_count{ls} {s.get('count', 0)}")

    emit(snap.get("counters", {}), "counter", render_scalar)
    emit({n: v for n, v in snap.get("gauges", {}).items()
          if v is not None}, "gauge", render_scalar)
    emit(snap.get("histograms", {}), "summary", render_summary)
    # native cumulative histogram twins (<base>_hist): external
    # Prometheus can compute ITS OWN windowed quantiles
    # (histogram_quantile over rate(_bucket)) instead of trusting the
    # in-process nearest-rank summaries. Only rendered for snapshots
    # that carry bucket data (older dump files do not).
    native = {n: s for n, s in snap.get("histograms", {}).items()
              if s.get("buckets")}
    items = sorted((_split_labels(n) + (s,) for n, s in native.items()),
                   key=lambda t: (t[0], t[1]))
    last_family = None
    for base, labels, s in items:
        pn = _prom_name(base) + "_hist"
        if pn != last_family:
            last_family = pn
            lines.append(
                f"# HELP {pn} "
                f"{_escape_help(_HELP.get(base, 'paddle_tpu metric ' + base))} "
                f"(native cumulative buckets)")
            lines.append(f"# TYPE {pn} histogram")
        render_native(pn, labels, s)
    return "\n".join(lines) + "\n"


_REGISTRY = MetricsRegistry()

# Tri-state module gate: None = not yet resolved from the `metrics` flag
# (env PADDLE_TPU_METRICS); the fast path below is a single attribute
# load + truth test, so disabled call sites cost ~no more than a
# function call.
_ENABLED = None


def global_registry() -> MetricsRegistry:
    return _REGISTRY


def set_enabled(on):
    global _ENABLED
    _ENABLED = bool(on)
    return _ENABLED


def enabled():
    """Is telemetry recording on? Resolves the `metrics` flag once."""
    if _ENABLED is None:
        from .. import flags
        # flags.get applies the side effect that calls set_enabled
        val = flags.get("metrics")
        if _ENABLED is None:           # pragma: no cover - belt & braces
            set_enabled(val)
    return _ENABLED


# -- zero-overhead recording helpers (the instrumentation surface) ---------

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


# -- module-level export conveniences --------------------------------------

def snapshot():
    return _REGISTRY.snapshot()


def reset():
    _REGISTRY.reset()


@contextlib.contextmanager
def _open_for_dump(path):
    """Write-temp-then-rename: a reader polling the file (`metrics
    --watch`) must never observe a truncated half-written snapshot."""
    import os
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        yield f
    os.replace(tmp, path)


def dump_jsonl(path):
    with _open_for_dump(path) as f:
        _REGISTRY.dump_jsonl(f)
    return path


def dump_json(path):
    with _open_for_dump(path) as f:
        json.dump(_REGISTRY.snapshot(), f, indent=2)
    return path


def format_table():
    return _REGISTRY.format_table()
