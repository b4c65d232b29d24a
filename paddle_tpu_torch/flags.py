"""Runtime flags the port reads: env-tunable knobs (`PADDLE_TPU_*`).

The port's own copy of the slice of `paddle_tpu/flags.py` that LM
serving reads, with the same names, defaults and environment spellings
(`PADDLE_TPU_<NAME>`), so one deployment environment configures both
packages alike. Values resolve from the environment at first use and
can be set from Python.
"""

from __future__ import annotations

import os

__all__ = ["get", "set_flag"]


def _parse_bool(s):
    if isinstance(s, bool):
        return s
    return str(s).strip().lower() in ("1", "true", "yes", "on")


def _parse_int(s):
    return int(str(s).strip())


def _parse_float(s):
    return float(str(s).strip())


# name -> (parser, default, help)
_DEFS = {
    "metrics": (_parse_bool, False,
                "record structured telemetry (counters/gauges/histograms) "
                "into the monitor registry; off = zero-overhead no-ops"),
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


def _apply_side_effects(name, val):
    if name == "metrics":
        from .monitor import registry
        registry.set_enabled(bool(val))
