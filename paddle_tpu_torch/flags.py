"""Runtime flags the port reads: env-tunable knobs (`PADDLE_TPU_*`).

The port's own copy of the slice of `paddle_tpu/flags.py` that LM
serving, one-shot serving, the int8 quantized ops, the stacked
transformer's remat, the conv stem rewrite, the sparse embedding
gradient's dispatch, the executor's NaN guard, the input pipeline, the
fault injector, the telemetry (metrics, trace, flight recorder, time
series and SLOs, the serving sampler) and the fleet's autoscaler read,
with the same names, defaults and environment spellings
(`PADDLE_TPU_<NAME>`), so one deployment environment configures both
packages alike. Values resolve
from the environment at first use and can be set from Python.
"""

from __future__ import annotations

import os

__all__ = ["get", "set_flag", "reset", "snapshot"]


def _parse_bool(s):
    if isinstance(s, bool):
        return s
    return str(s).strip().lower() in ("1", "true", "yes", "on")


def _parse_int(s):
    return int(str(s).strip())


def _parse_float(s):
    return float(str(s).strip())


def _parse_str(s):
    return str(s)


def _parse_choice(*choices):
    def parse(s):
        t = str(s).strip().lower()
        if t == "":
            t = choices[0]
        if t not in choices:
            raise ValueError(f"expected one of {choices}, got {s!r}")
        return t
    return parse


# name -> (parser, default, help)
_DEFS = {
    "metrics": (_parse_bool, False,
                "record structured telemetry (counters/gauges/histograms) "
                "into the monitor registry; off = zero-overhead no-ops"),
    "metrics_path": (_parse_str, "",
                     "where monitor.maybe_dump() writes the registry "
                     "snapshot (.json object or .jsonl lines) — the "
                     "serve CLI dumps here on exit"),
    "metrics_sample_s": (_parse_float, 0.0,
                         "background time-series sampler cadence in "
                         "seconds (monitor/timeseries.py): each tick "
                         "snapshots the metric registry into bounded "
                         "per-metric ring buffers — windowed rates, "
                         "min/max/mean and quantiles are computed on "
                         "read — and evaluates the SLO rules "
                         "(monitor/slo.py) with hysteresis. 0 "
                         "(default) = disabled: ZERO threads, registry "
                         "write cost unchanged"),
    "slo_rules": (_parse_str, "",
                  "path to a JSON file of extra SLO rules "
                  "(monitor/slo.py rules_from_json grammar: threshold "
                  "rules and good/total burn-rate rules) evaluated "
                  "alongside the default serving/training pack; rules "
                  "with scope='fleet' load into the fleet router's "
                  "aggregator instead"),
    "trace_path": (_parse_str, "",
                   "write a Chrome-trace JSON (chrome://tracing / "
                   "Perfetto) of host spans and record_event regions to "
                   "this path at exit; profiler(trace_dir=...) needs no "
                   "flag"),
    "blackbox_dir": (_parse_str, "",
                     "where the flight recorder (monitor/blackbox.py) "
                     "writes post-mortem blackbox-<ts>.json bundles on "
                     "NaN-guard trips, rollback/restore, preemption and "
                     "serving batch failures — last-N spans/events, "
                     "metrics snapshot, flags, device memory; empty = "
                     "no dumps (the in-memory ring still records when "
                     "telemetry is on)"),
    "profile_sample_n": (_parse_int, 0,
                         "serving: profile 1-in-N dispatched batches "
                         "(monitor/deviceprof.py) — sampled batches "
                         "time the dispatch with CUDA events into "
                         "per-rung serving.device_time histograms and, "
                         "rate-limited, capture a full per-op device "
                         "trace for the stats()/debug-vars top-op "
                         "table. 0 (default) disables: no sampler "
                         "object, no threads, zero per-dispatch cost"),
    "check_nan_inf": (_parse_bool, False,
                      "scan run outputs/state for NaN/Inf and raise; while "
                      "on, every op that writes a persistable var writes a "
                      "new tensor and the executor commits all of the "
                      "run's state or none of it"),
    "feed_workers": (_parse_int, 1,
                     "reader/convert worker threads of the device input "
                     "pipeline (reader/pipeline.py): 0 = synchronous "
                     "inline feed (no threads; the same batches), N>=1 = "
                     "async prefetch through the ordered staging buffer "
                     "— any N yields the same batch order"),
    "feed_prefetch_depth": (_parse_int, 2,
                            "device-side prefetch queue depth of the "
                            "input pipeline: batches copied to the card "
                            "ahead of the consumer; 2 = double buffering "
                            "(batch n+1's host-to-device copy rides under "
                            "step n)"),
    "faults": (_parse_str, "",
               "deterministic fault-injection schedule "
               "(resilience/faults.py), comma-separated "
               "site:trigger:kind items, e.g. "
               "step:7:RuntimeError,ckpt_save:1:crash — empty = no "
               "injection (zero overhead)"),
    "remat": (_parse_bool, False,
              "rematerialise each transformer_stack layer in the backward "
              "(torch.utils.checkpoint): activation memory for FLOPs"),
    "conv_s2d_stem": (_parse_bool, True,
                      "rewrite small-channel strided convs (image stems) "
                      "as space-to-depth + stride-1 conv — exact same "
                      "math, MXU-friendlier shapes"),
    "int8_matmul": (_parse_choice("auto", "pallas", "dot"), "auto",
                    "quantized-matmul core (quant_mul/quant_matmul, "
                    "ops/quant_ops.py): on a CUDA tensor every value runs "
                    "K6, the int8 x int8 -> int32 Hopper kernel; on a CPU "
                    "tensor auto (default) = dequantize-to-f32 matmul, "
                    "pallas / dot = the plain int8 x int8 -> int32 core"),
    "sparse_grad": (_parse_choice("auto", "selected_rows", "dense"),
                    "auto",
                    "lookup_table is_sparse=True gradient dispatch: auto "
                    "(default) takes the dense gradient (a scatter-add "
                    "into a table-sized zero) when the table carries no "
                    "sharding hint and fits the dense-update budget, "
                    "else a SelectedRows; selected_rows / dense force "
                    "one path"),
    "serving_max_batch_size": (_parse_int, 16,
                               "serving.EngineConfig default: admission "
                               "bound and largest bucket-ladder rung of "
                               "the online micro-batcher"),
    "serving_batch_timeout_ms": (_parse_float, 2.0,
                                 "serving.EngineConfig default: how long "
                                 "the batcher holds an incomplete batch "
                                 "open for more requests (0 = dispatch "
                                 "immediately)"),
    "serving_queue_limit": (_parse_int, 128,
                            "bounded-queue capacity in requests; submits "
                            "beyond it raise ServerOverloadedError"),
    "serving_lm_max_slots": (_parse_int, 8,
                             "GenerationConfig default: KV slot-pool size "
                             "= the one decode batch width"),
    "serving_lm_prefill_batch": (_parse_int, 4,
                                 "GenerationConfig default: most prompts "
                                 "one prefill dispatch admits (clamped to "
                                 "max_slots)"),
    "serving_lm_max_prompt_len": (_parse_int, 256,
                                  "GenerationConfig default: longest "
                                  "admissible prompt"),
    "serving_lm_max_new_tokens": (_parse_int, 128,
                                  "GenerationConfig default: per-request "
                                  "generation cap"),
    "serving_lm_paged": (_parse_bool, True,
                         "GenerationConfig default: True = paged KV "
                         "cache; False = slab planes"),
    "serving_lm_page_len": (_parse_int, 16,
                            "GenerationConfig default: tokens per KV page"),
    "serving_lm_num_pages": (_parse_int, 0,
                             "GenerationConfig default: KV page-pool "
                             "size; 0 = max_slots * pages per worst-case "
                             "sequence"),
    "serving_lm_prefix_cache": (_parse_bool, True,
                                "GenerationConfig default: cross-request "
                                "prefix KV reuse in paged mode"),
    "serving_read_timeout_s": (_parse_float, 30.0,
                               "per-connection socket read timeout of the "
                               "HTTP front end; 0 disables"),
    "autoscale": (_parse_bool, False,
                  "route: run the AutoscaleController "
                  "(serving/autoscale.py) inside the router process — "
                  "the fleet sizes itself off its own /fleet/dashboard "
                  "signals, adding/removing supervised replica slots "
                  "within [autoscale_min_replicas, "
                  "autoscale_max_replicas]. Spawn mode only (a "
                  "--targets fleet is externally managed)"),
    "autoscale_min_replicas": (_parse_int, 1,
                               "autoscale: fleet size floor; a "
                               "given-up replica does not count, so "
                               "the controller backfills it"),
    "autoscale_max_replicas": (_parse_int, 4,
                               "autoscale: fleet size ceiling"),
    "autoscale_mode": (_parse_choice("reactive", "predictive"),
                       "reactive",
                       "autoscale: reactive = hysteresis over "
                       "queue-depth/fleet-shed-rate SLO signals; "
                       "predictive = compute required replicas from "
                       "offered load (Little's law) and measured "
                       "per-rung device times (serving.device_time) "
                       "and scale up ahead of the hold clock — "
                       "scale-down keeps the reactive sustained-idle "
                       "discipline in both modes"),
    "autoscale_interval_s": (_parse_float, 1.0,
                             "autoscale: decision cadence (seconds)"),
    "autoscale_window_s": (_parse_float, 10.0,
                           "autoscale: dashboard window the controller "
                           "reads its signals over — short, so signals "
                           "move on the decision timescale"),
    "autoscale_queue_high": (_parse_float, 8.0,
                             "autoscale: fleet queue depth above which "
                             "scale-up pressure exists (breach "
                             "surface)"),
    "autoscale_queue_low": (_parse_float, 2.0,
                            "autoscale: queue depth at/below which the "
                            "fleet can be considered idle (the "
                            "separate clear surface — hysteresis)"),
    "autoscale_up_for_s": (_parse_float, 3.0,
                           "autoscale: how long scale-up pressure must "
                           "hold before a reactive scale-up (the hold "
                           "clock predictive mode skips)"),
    "autoscale_idle_rps": (_parse_float, 1.0,
                           "autoscale: fleet requests/sec at/below "
                           "which the fleet can be considered idle"),
    "autoscale_idle_for_s": (_parse_float, 15.0,
                             "autoscale: how long the idle condition "
                             "must hold before a scale-down"),
    "autoscale_up_cooldown_s": (_parse_float, 10.0,
                                "autoscale: minimum time between "
                                "scale-ups"),
    "autoscale_down_cooldown_s": (_parse_float, 30.0,
                                  "autoscale: minimum time between "
                                  "scale-downs (also waits out the up "
                                  "cooldown — scale-up is the more "
                                  "recent evidence)"),
    "autoscale_target_util": (_parse_float, 0.6,
                              "autoscale predictive mode: fraction of "
                              "measured per-replica capacity the load "
                              "model plans to (derate headroom)"),
}

_values: dict = {}


def _unknown(name):
    return KeyError(f"unknown flag {name!r}. Known flags: {sorted(_DEFS)}")


def get(name):
    if name not in _DEFS:
        raise _unknown(name)
    if name in _values:
        return _values[name]
    parser, default, _ = _DEFS[name]
    env = os.environ.get("PADDLE_TPU_" + name.upper())
    val = parser(env) if env is not None else default
    _values[name] = val
    _apply_side_effects(name, val)
    return val


def set_flag(name, value):
    if name not in _DEFS:
        raise _unknown(name)
    val = _DEFS[name][0](value)
    _values[name] = val
    _apply_side_effects(name, val)
    return val


def reset():
    """Forget cached and explicit values (tests)."""
    _values.clear()


def snapshot():
    """Resolved flag values only (no env side effects): what /debug/vars
    and blackbox bundles report. Flags never read stay unreported rather
    than being resolved from the environment here — resolving
    `trace_path` / `metrics` has side effects a diagnostics read must
    not trigger."""
    return dict(_values)


def _apply_side_effects(name, val):
    if name == "metrics":
        from .monitor import registry
        registry.set_enabled(bool(val))
    elif name == "trace_path":
        from .monitor import trace
        trace.configure_from_flag(val)
    elif name == "metrics_sample_s":
        from .monitor import timeseries
        timeseries.configure(val)
