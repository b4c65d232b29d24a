"""Op-level device-time attribution: which Program op ate the step.

The port's counterpart of `paddle_tpu/monitor/deviceprof.py`. The
reference joins three tables (trace event -> HLO instruction -> named
scope); the port runs eagerly, so the join is shorter:

1. **Annotate** — while a profile is active (`scopes_active()`, read
   once a run) the executor lowers every Program op inside
   `torch.profiler.record_function(op_scope(block, idx, op_type))`, the
   reference's "<block>/<idx>:<op_type>" string. Otherwise no scope is
   entered.

2. **Measure** — `torch.profiler` (CPU and, on the card, CUDA activity)
   records each profiled step; its Chrome trace (kineto's events) holds
   the scopes as `user_annotation` slices, the launches as
   `cuda_runtime` / `cuda_driver` slices and the device work as
   `kernel` / `gpu_memcpy` / `gpu_memset` slices. Each device event is
   attributed to the innermost op scope that encloses its launch on the
   host: the launch is found by the CUPTI correlation id the kernel and
   its runtime / driver call share; kernels whose launch the trace does
   not correlate (a driver-API launch kineto does not trace) are paired
   in order with the uncorrelated launch calls when there are as many of
   each (one stream runs its kernels in launch order), and stay
   unresolved otherwise; the report's `links` counts each way. The
   autograd engine launches a grad op's kernels from its own thread,
   inside the executor's scope in time, so containment is by time, not
   thread.

3. **Join with static cost** — `static_scope_costs` is the per-op FLOP
   tally of `introspect.program_op_costs` (the reference's dot / conv
   formulas), and bytes the op's input and output var bytes. Each row
   gets achieved FLOP/s and a roofline verdict against the card's ridge
   point (dense bf16 peak over HBM bandwidth; H100 SXM: 989e12 / 3.35e12).

Report modes (the reference's `mode` field):

    device      the card's kernel / memcpy / memset events
    host-cpu    no device events: leaf CPU op events per thread (the CPU
                backend), attributed to the scope they run in
    host-timed  no usable events: wall-clock step times + static costs
                only, coverage 0.0

A CUDA-graph replay (the serving rungs) carries no op scope: its kernels
are attributed by name under the rung (`"<rung>:<kernel>"`), and
`coverage` counts them as attributed to the rung.

Serving: `SamplingProfiler` (flag `profile_sample_n` = N) times 1-in-N
dispatched batches with CUDA events around the dispatch (perf_counter on
the CPU) into per-rung `serving.device_time|rung=` histograms, and
rate-limits FULL captures to one per `trace_min_interval_s`. With N = 0
the sampler is never constructed: no object, no thread, no per-dispatch
cost. Each sampled batch's record carries the batch's `x-trace-id`s, and
when an ambient host Chrome trace is running a flow event links the
request's dispatch span to a "device (sampled)" lane.
"""

from __future__ import annotations

import bisect
import contextlib
import gzip
import json
import math
import os
import re
import sys
import threading
import time

from . import registry as _registry
from .introspect import _cuda_available as _on_card

__all__ = [
    "op_scope", "scope_of", "scopes_active", "profiling",
    "find_trace_files", "load_trace_events", "aggregate_trace",
    "static_scope_costs", "attribute", "profile_program", "profile_fn",
    "device_roofline", "SamplingProfiler", "sampler_from_flags", "stats",
    "reset", "format_rows", "brief_rows", "SCHEMA_VERSION",
]

SCHEMA_VERSION = 1

# "<block>/<idx>:<op_type>" — matches op_scope() output inside a longer
# path; the INNERMOST (last) token wins
SCOPE_RE = re.compile(r"(?:^|/)(\d+/\d+:[A-Za-z0-9_.\-]+)")
_SCOPE_NAME = re.compile(r"^\d+/\d+:[A-Za-z0-9_.\-]+$")

# HBM bandwidth (bytes/s) per card, the denominator of the roofline
# ridge point; NVIDIA data sheets (H100 SXM5 3.35 TB/s, PCIe 2.0, NVL
# 3.9; A100 80GB 2.0). Off the card: the reference's 819e9.
_HBM_BW_BY_NAME = (
    ("h100 nvl", 3.9e12),
    ("h100 pcie", 2.0e12),
    ("h100", 3.35e12),
    ("h200", 4.8e12),
    ("a100", 2.0e12),
)
_UNKNOWN_CARD_BW = 3.35e12
_CPU_SMOKE_BW = 819e9

# device-side trace categories and the host calls that launch them
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_LAUNCH_NAMES = ("Launch", "Memcpy", "Memset")

# live profiles: while > 0 the executor enters an op scope per op
_active = 0
_active_lock = threading.Lock()


def op_scope(block_idx, op_idx, op_type):
    """The scope string for one Program op — the single place the
    "<block>/<idx>:<op_type>" scheme is defined."""
    return f"{block_idx}/{op_idx}:{op_type}"


def scope_of(text):
    """Innermost "<block>/<idx>:<op_type>" token in a path, or None."""
    if not text:
        return None
    found = SCOPE_RE.findall(text)
    return found[-1] if found else None


def scope_op_type(scope):
    """The op_type half of a scope token ("0/7:mul" -> "mul")."""
    return scope.split(":", 1)[1] if scope and ":" in scope else scope


def scopes_active():
    """Should the executor enter per-op scopes? True only while a
    profile captures."""
    return _active > 0


@contextlib.contextmanager
def profiling():
    """Turn the executor's per-op scopes on for the block."""
    global _active
    with _active_lock:
        _active += 1
    try:
        yield
    finally:
        with _active_lock:
            _active -= 1


def device_roofline():
    """(peak_flops_per_sec, hbm_bytes_per_sec, device_label)."""
    from . import introspect
    peak, label = introspect.peak_flops()
    if label == "cpu-smoke":
        return peak, _CPU_SMOKE_BW, label
    probe = str(label).lower()
    bw = next((b for marker, b in _HBM_BW_BY_NAME if marker in probe),
              _UNKNOWN_CARD_BW)
    return peak, bw, label


# ---------------------------------------------------------------------------
# trace-event loading / aggregation (pure: fixture-testable)
# ---------------------------------------------------------------------------

def _warn(msg):
    print(f"deviceprof: {msg}", file=sys.stderr)


def find_trace_files(trace_dir):
    """The `*.trace.json(.gz)` / `*.pt.trace.json` files directly in
    `trace_dir`, sorted; possibly empty."""
    if not os.path.isdir(trace_dir):
        return []
    return [os.path.join(trace_dir, f) for f in sorted(os.listdir(trace_dir))
            if f.endswith((".trace.json", ".trace.json.gz"))]


def load_trace_events(path):
    """The `traceEvents` list of one trace file (.json or .json.gz), or
    None with a warning — a truncated capture must degrade the report,
    never crash the step that produced it."""
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            doc = json.load(f)
    except (OSError, ValueError, EOFError) as e:
        _warn(f"unreadable trace {path!r}: {e}")
        return None
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(events, list):
        _warn(f"no traceEvents array in {path!r}")
        return None
    return events


def _slices(events, pred):
    out = []
    for ev in events or ():
        if ev.get("ph") != "X" or not pred(ev):
            continue
        try:
            ts = float(ev.get("ts", 0.0))
            dur = float(ev.get("dur", 0.0))
        except (TypeError, ValueError):
            continue
        out.append((ts, dur, ev))
    return out


def _cat(ev):
    return str(ev.get("cat", "")).lower()


def _corr(ev):
    c = (ev.get("args") or {}).get("correlation")
    try:
        return int(c) if c is not None else None
    except (TypeError, ValueError):
        return None


class _Scopes:
    """Sorted op-scope slices on the host's clock (`user_annotation`;
    kineto also projects each onto the device's timeline as a
    `gpu_user_annotation`, which host times must not be matched
    against); `at(t)` is the innermost one enclosing t."""

    def __init__(self, events):
        sl = sorted((ts, ts + dur, ev.get("name"))
                    for ts, dur, ev in _slices(
                        events, lambda e: _cat(e) == "user_annotation"
                        and _SCOPE_NAME.match(
                            str(e.get("name", ""))) is not None))
        self._starts = [s for s, _, _ in sl]
        self._slices = sl

    def at(self, t):
        i = bisect.bisect_right(self._starts, t)
        # walk back over the few slices that start before t: the latest
        # start that still encloses t is the innermost
        for j in range(i - 1, max(i - 9, -1), -1):
            s, e, name = self._slices[j]
            if s <= t <= e:
                return name
        return None


def _leaf_only(slices):
    """Per (pid, tid) lane, the slices that enclose no other slice."""
    lanes = {}
    for ts, dur, ev in slices:
        lanes.setdefault((ev.get("pid"), ev.get("tid")), []).append(
            (ts, dur, ev))
    out = []
    for lane in lanes.values():
        lane.sort(key=lambda t: (t[0], -t[1]))
        stack, entries = [], []
        for ts, dur, ev in lane:
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if stack:
                stack[-1][1] = False
            rec = [ts + dur, True, ts, dur, ev]
            stack.append(rec)
            entries.append(rec)
        out.extend((ts, dur, ev) for _, leaf, ts, dur, ev in entries
                   if leaf)
    return out


def aggregate_trace(events, unscoped=None):
    """Per-(scope, kernel) duration totals from kineto trace events.

    Returns {"ops": {key: {"dur_us", "calls", "scope_hint", "kernel"}},
    "total_us", "source": "device" | "host-cpu" | "empty", "kernels":
    {name: {"events", "dur_us"}}}. `scope_hint` is the Program op scope
    the event is attributed to (None: unresolved). With `unscoped` (a
    rung label), a device event outside every op scope is attributed to
    "<unscoped>:<kernel name>" instead (CUDA-graph replays)."""
    scopes = _Scopes(events)
    device = _slices(events, lambda e: _cat(e) in _DEVICE_CATS)
    ops = {}
    kernels = {}
    total = 0.0

    def add(scope, name, dur):
        key = f"{scope}|{name}" if scope else name
        ent = ops.setdefault(key, {"dur_us": 0.0, "calls": 0,
                                   "scope_hint": scope, "kernel": name})
        ent["dur_us"] += dur
        ent["calls"] += 1

    if device:
        launches = _slices(events, lambda e: _cat(e) in _LAUNCH_CATS)
        by_corr = {}
        for ts, _, ev in launches:
            c = _corr(ev)
            if c is not None:
                by_corr.setdefault(c, ts)
        device.sort(key=lambda t: t[0])
        launch_t = {}
        orphans = []
        used = set()
        for i, (ts, dur, ev) in enumerate(device):
            c = _corr(ev)
            if c is not None and c in by_corr:
                launch_t[i] = by_corr[c]
                used.add(c)
            else:
                orphans.append(i)
        correlated = len(launch_t)
        if orphans:
            # uncorrelated kernels pair, in order, with the launch calls
            # that correlate to no device event — only when the two
            # lists are the same length; otherwise they stay unresolved
            free = sorted(ts for ts, _, ev in launches
                          if _corr(ev) not in used
                          and any(k in str(ev.get("name", ""))
                                  for k in _LAUNCH_NAMES))
            if len(free) == len(orphans):
                for i, t in zip(orphans, free):
                    launch_t[i] = t
        links = {"correlated": correlated,
                 "paired": len(launch_t) - correlated,
                 "unlaunched": len(device) - len(launch_t)}
        for i, (ts, dur, ev) in enumerate(device):
            name = str(ev.get("name", "?"))
            t = launch_t.get(i)
            scope = scopes.at(t) if t is not None else None
            if scope is None and unscoped is not None:
                scope = f"{unscoped}:{name}"
            add(scope, name, dur)
            k = kernels.setdefault(name, {"events": 0, "dur_us": 0.0})
            k["events"] += 1
            k["dur_us"] += dur
            total += dur
        source = "device"
    else:
        links = {}
        cpu = _leaf_only(_slices(events, lambda e: _cat(e) == "cpu_op"))
        for ts, dur, ev in cpu:
            name = str(ev.get("name", "?"))
            add(scopes.at(ts), name, dur)
            total += dur
        source = "host-cpu"
    return {"ops": ops, "total_us": total,
            "source": source if ops else "empty", "kernels": kernels,
            "links": links}


def _merge_aggs(aggs):
    """Sum several steps' aggregates; each kernel's `events` is the most
    any one step recorded (the profiler now and then drops a step's
    device events)."""
    out = {"ops": {}, "total_us": 0.0, "source": "empty", "kernels": {},
           "links": {}}
    for agg in aggs:
        for k, v in agg.get("links", {}).items():
            out["links"][k] = out["links"].get(k, 0) + v
        if agg["source"] == "device" or out["source"] == "empty":
            out["source"] = agg["source"] if agg["ops"] else out["source"]
        out["total_us"] += agg["total_us"]
        for key, ent in agg["ops"].items():
            o = out["ops"].setdefault(key, dict(ent, dur_us=0.0, calls=0))
            o["dur_us"] += ent["dur_us"]
            o["calls"] += ent["calls"]
        for name, k in agg["kernels"].items():
            o = out["kernels"].setdefault(name, {"events": 0,
                                                 "dur_us": 0.0})
            o["events"] = max(o["events"], k["events"])
            o["dur_us"] += k["dur_us"]
    return out


# ---------------------------------------------------------------------------
# static per-scope costs
# ---------------------------------------------------------------------------

def static_scope_costs(program, feed=None, block=None):
    """{scope_token: {"flops", "bytes", "eqns"}} of every op of the
    program's global block: introspect's FLOP tally (the reference's dot
    / conv formulas) and the op's input + output var bytes; "eqns" is 1
    (one Program op a scope)."""
    from . import introspect
    block = block if block is not None else program.global_block()
    return {op_scope(block.idx, idx, t): {"flops": f, "bytes": b,
                                          "eqns": 1}
            for idx, t, f, b in introspect.program_op_costs(
                program, feed, block)}


# ---------------------------------------------------------------------------
# the join: measured durations x static costs -> the table
# ---------------------------------------------------------------------------

def attribute(agg, scope_map, static_costs=None, steps=1, peak=None,
              bw=None):
    """Join aggregated durations onto Program-op scopes.

    Returns (rows, coverage, unresolved_us): rows sorted by per-step
    device time desc, each {scope, op_type, device_time_us, calls,
    flops, bytes, achieved_flops_per_s, intensity, verdict, share};
    coverage = resolved time / total measured time. `scope_map` maps an
    aggregate key to a scope where the event itself carries none."""
    static_costs = static_costs or {}
    steps = max(int(steps), 1)
    if peak is None or bw is None:
        peak, bw, _ = device_roofline()
    ridge = peak / bw if bw else float("inf")

    by_scope = {}
    unresolved_us = 0.0
    for key, ent in (agg.get("ops") or {}).items():
        scope = scope_map.get(key) or ent.get("scope_hint")
        if scope is None:
            unresolved_us += ent["dur_us"]
            continue
        row = by_scope.setdefault(scope, {"dur_us": 0.0, "calls": 0})
        row["dur_us"] += ent["dur_us"]
        row["calls"] += ent["calls"]

    total_us = float(agg.get("total_us") or 0.0)
    resolved_us = max(total_us - unresolved_us, 0.0)
    coverage = (resolved_us / total_us) if total_us > 0 else 0.0

    rows = []
    for scope, row in by_scope.items():
        per_step_us = row["dur_us"] / steps
        cost = static_costs.get(scope, {})
        flops = int(cost.get("flops", 0))
        nbytes = int(cost.get("bytes", 0))
        achieved = (flops / (per_step_us * 1e-6)
                    if per_step_us > 0 and flops else 0.0)
        intensity = (flops / nbytes) if nbytes else None
        if intensity is None:
            verdict = "unknown"
        elif intensity >= ridge:
            verdict = "compute-bound"
        else:
            verdict = "transfer-bound"
        rows.append({
            "scope": scope,
            "op_type": scope_op_type(scope),
            "device_time_us": per_step_us,
            "calls": row["calls"],
            "flops": flops,
            "bytes": nbytes,
            "achieved_flops_per_s": achieved,
            "intensity": intensity,
            "verdict": verdict,
            "share": (row["dur_us"] / total_us) if total_us > 0 else 0.0,
        })
    rows.sort(key=lambda r: r["device_time_us"], reverse=True)
    return rows, coverage, unresolved_us / steps


# ---------------------------------------------------------------------------
# one-shot profiling
# ---------------------------------------------------------------------------

def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if _on_card():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _sync():
    if _on_card():
        import torch
        torch.cuda.synchronize()


# Late in a long process, a whole-step capture lost the device events of
# the step's first launches (a fixed number for a given step: ~20-55),
# while their launch calls were recorded (ROADMAP C30). A session warmed
# first keeps them: it turns CUPTI's activity collection on (the
# profiler's warm-up phase), launches WARM_LAUNCHES trivial kernels
# outside the recorded window, and only then opens the window around
# the step.
WARM_LAUNCHES = 512


def _capture(fn, path, warm=False):
    """fn() under torch.profiler with the executor's op scopes on, its
    Chrome trace written to `path`; returns (fn's result, wall s). With
    `warm` (on the card), the session's warm-up phase runs
    WARM_LAUNCHES trivial kernels before the recorded window opens."""
    from torch.profiler import profile, schedule
    warm = warm and _on_card()
    sched = schedule(wait=0, warmup=1, active=1) if warm else None
    with profiling(), profile(activities=_activities(),
                              schedule=sched) as prof:
        if warm:
            import torch
            z = torch.zeros(1, device="cuda")
            for _ in range(WARM_LAUNCHES):
                z.add_(1.0)
            _sync()
            prof.step()            # the recorded window opens here
        t0 = time.perf_counter()
        out = fn()
        _sync()
        dt = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    return out, dt


def profile_fn(fn, steps=3, warmup=1, static_costs=None, trace_dir=None,
               keep_trace=False, unscoped=None):
    """Profile `steps` calls of fn() (after `warmup` plain calls), each
    in its own warmed capture (`_capture`), and return the attribution
    report dict (see the module docstring for the modes).
    `trace_dir=None` captures into a temp dir removed after parsing; a
    caller's dir is kept."""
    import shutil
    import tempfile

    for _ in range(max(int(warmup), 0)):
        fn()
    _sync()
    steps = max(int(steps), 1)
    own_dir = trace_dir is None
    tdir = trace_dir or tempfile.mkdtemp(prefix="paddle_tpu_torch_prof_")
    os.makedirs(tdir, exist_ok=True)
    step_times, aggs = [], []
    for i in range(steps):
        path = os.path.join(tdir, f"step{i}.trace.json")
        try:
            _, dt = _capture(fn, path, warm=True)
        except Exception as e:   # noqa: BLE001 — degrade, never crash
            _warn(f"profiler capture failed ({e}); host-timed fallback")
            t0 = time.perf_counter()
            fn()
            _sync()
            dt = time.perf_counter() - t0
            path = None
        step_times.append(dt)
        events = load_trace_events(path) if path else None
        if events:
            aggs.append(aggregate_trace(events, unscoped=unscoped))
    if own_dir and not keep_trace:
        shutil.rmtree(tdir, ignore_errors=True)
        tdir = None
    agg = _merge_aggs(aggs)
    static_costs = static_costs or {}
    peak, bw, device = device_roofline()
    rows, coverage, unresolved_us = attribute(
        agg, {}, static_costs, steps=steps, peak=peak, bw=bw)
    if rows:
        mode = agg["source"]
    else:
        # no usable events: static costs + wall time
        mode = "host-timed"
        for scope, cost in sorted(static_costs.items(),
                                  key=lambda kv: -kv[1]["flops"]):
            rows.append({
                "scope": scope, "op_type": scope_op_type(scope),
                "device_time_us": None, "calls": 0,
                "flops": cost["flops"], "bytes": cost["bytes"],
                "achieved_flops_per_s": 0.0,
                "intensity": (cost["flops"] / cost["bytes"]
                              if cost["bytes"] else None),
                "verdict": "unknown", "share": 0.0,
            })
        coverage = 0.0
    step_times.sort()
    report = {
        "schema_version": SCHEMA_VERSION,
        "device": device,
        "peak_flops": peak,
        "hbm_bw": bw,
        "mode": mode,
        "steps": steps,
        "step_time_s": step_times[len(step_times) // 2],
        "total_us": float(agg["total_us"]) / steps,
        "unresolved_us": unresolved_us,
        "coverage": coverage,
        "rows": rows,
        # each device kernel's events in a step (the most any one step
        # recorded) and its device time a step
        "kernels": {n: {"events_per_step": k["events"],
                        "us_per_step": k["dur_us"] / steps}
                    for n, k in sorted(agg["kernels"].items(),
                                       key=lambda kv: -kv[1]["dur_us"])},
        # how the device events found their launches, over all steps:
        # by correlation id, paired in order, or not at all
        "links": agg["links"],
        "trace_dir": tdir if (trace_dir or keep_trace) else None,
    }
    _registry.gauge_set("deviceprof.coverage", coverage)
    _registry.counter_inc("deviceprof.captures")
    return report


def profile_program(program, feed=None, fetch_list=None, scope=None,
                    executor=None, steps=3, warmup=1, trace_dir=None,
                    keep_trace=False):
    """Run `program` `warmup + steps` times through the executor (on
    the card unless `executor` is a CPU one; a training program takes
    those steps on `scope`) and return the attribution report of the
    `steps` profiled runs."""
    from .. import executor as executor_mod

    exe = executor or executor_mod.Executor()
    feed = dict(feed or {})
    fetch = list(fetch_list or ())

    def step():
        return exe.run(program, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)

    return profile_fn(step, steps=steps, warmup=warmup,
                      static_costs=static_scope_costs(program, feed),
                      trace_dir=trace_dir, keep_trace=keep_trace)


def format_rows(rows, top=None, total_us=None):
    """Fixed-width text table of attribution rows."""
    rows = rows[:top] if top else rows
    lines = [f"{'op':<44} {'time/step':>12} {'share':>6} "
             f"{'GFLOP/s':>10} {'AI':>8}  verdict"]
    for r in rows:
        t = ("      --    " if r["device_time_us"] is None
             else f"{r['device_time_us']:10.1f}us")
        ai = ("    --" if r["intensity"] is None
              else f"{r['intensity']:8.2f}")
        lines.append(
            f"{r['scope'][:44]:<44} {t:>12} {r['share'] * 100:5.1f}% "
            f"{r['achieved_flops_per_s'] / 1e9:10.2f} {ai:>8}  "
            f"{r['verdict']}")
    return "\n".join(lines)


def brief_rows(rows, top=5):
    """Compact row dicts for embedding (debug_vars, chip_smoke lines)."""
    out = []
    for r in rows[:top]:
        out.append({
            "op": r["scope"],
            "us": (None if r["device_time_us"] is None
                   else round(r["device_time_us"], 2)),
            "share": round(r["share"], 4),
            "gflops": round(r["achieved_flops_per_s"] / 1e9, 2),
            "verdict": r["verdict"],
        })
    return out


# ---------------------------------------------------------------------------
# serving: sampled continuous profiling
# ---------------------------------------------------------------------------

class SamplingProfiler:
    """1-in-N dispatch sampler for the one-shot serving engine.

    `tick()` is called once per formed batch; when it elects the batch,
    the engine routes the dispatch through `sample()`. The dispatch's
    device time (CUDA events around it on the card, perf_counter on the
    CPU) lands in `serving.device_time|rung=`. Full captures are
    rate-limited to one per `trace_min_interval_s` and parsed inline on
    the batcher thread. No threads are ever created, and with every_n=0
    the engine never constructs one."""

    def __init__(self, every_n, trace_min_interval_s=5.0,
                 scope_map=None, on_card=None):
        self.every_n = max(int(every_n), 0)
        self.trace_min_interval_s = float(trace_min_interval_s)
        self.scope_map = scope_map or {}
        self.on_card = _on_card() if on_card is None else bool(on_card)
        self._lock = threading.Lock()
        self._count = 0
        self._sampled = 0
        self._captures = 0
        self._capture_errors = 0
        self._last_capture_t = -math.inf
        self._last = None          # last attribution record
        self._top_ops = []         # last full capture's top table

    def tick(self):
        """True when the current batch should be sampled."""
        if self.every_n <= 0:
            return False
        with self._lock:
            self._count += 1
            return self._count % self.every_n == 1 or self.every_n == 1

    def _timed(self, dispatch, padded):
        """(outputs, device seconds, host start perf_counter)."""
        t0 = time.perf_counter()
        if self.on_card:
            import torch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outputs = dispatch(padded)
            end.record()
            end.synchronize()
            return outputs, start.elapsed_time(end) / 1e3, t0
        outputs = dispatch(padded)
        return outputs, time.perf_counter() - t0, t0

    def sample(self, dispatch, padded, rung=None, trace_ids=()):
        """Run one elected dispatch, recording its device time and
        (rate-limited) a full capture. Returns the dispatch outputs; a
        measurement failure never fails the batch."""
        import shutil
        import tempfile

        now = time.monotonic()
        with self._lock:
            capture = (now - self._last_capture_t
                       >= self.trace_min_interval_s)
            if capture:
                self._last_capture_t = now
        tdir = None
        parsed = {}
        if capture:
            tdir = tempfile.mkdtemp(prefix="paddle_tpu_torch_sprof_")
            path = os.path.join(tdir, "dispatch.trace.json")
            try:
                (outputs, dt, t0), _ = _capture(
                    lambda: self._timed(dispatch, padded), path)
                parsed = self._parse_capture(path, rung)
            except Exception as e:   # noqa: BLE001
                _warn(f"serving capture failed: {e}")
                with self._lock:
                    self._capture_errors += 1
                _registry.counter_inc("deviceprof.capture_errors")
                outputs, dt, t0 = self._timed(dispatch, padded)
            shutil.rmtree(tdir, ignore_errors=True)
        else:
            outputs, dt, t0 = self._timed(dispatch, padded)

        label = f"|rung={rung}" if rung is not None else ""
        _registry.histogram_observe(f"serving.device_time{label}", dt)
        _registry.counter_inc("deviceprof.sampled_batches")
        record = {
            "ts": time.time(),
            "rung": rung,
            "device_time_s": dt,
            "trace_ids": list(trace_ids or ()),   # x-trace-id join key
            "mode": "cuda_events" if self.on_card else "host",
        }
        record.update(parsed)
        self._emit_flow(record, t0, dt)
        with self._lock:
            self._sampled += 1
            self._last = record
            if record.get("top_ops"):
                self._top_ops = record["top_ops"]
        return outputs

    def _parse_capture(self, path, rung):
        """One capture's trace into the record fields; warn-not-crash."""
        try:
            events = load_trace_events(path)
            agg = aggregate_trace(events or [],
                                  unscoped=f"rung{rung}"
                                  if rung is not None else "dispatch")
            if not agg["ops"]:
                return {}
            rows, coverage, _ = attribute(agg, self.scope_map, steps=1)
            with self._lock:
                self._captures += 1
            _registry.counter_inc("deviceprof.captures")
            _registry.gauge_set("deviceprof.coverage", coverage)
            return {"mode": agg["source"], "coverage": coverage,
                    "top_ops": brief_rows(rows, top=10)}
        except Exception as e:   # noqa: BLE001
            _warn(f"serving capture parse failed: {e}")
            with self._lock:
                self._capture_errors += 1
            _registry.counter_inc("deviceprof.capture_errors")
            return {}

    def _emit_flow(self, record, t0, dt):
        """With an ambient host Chrome trace running, add the sampled
        dispatch to a "device (sampled)" lane and a flow arrow from the
        batcher thread's dispatch span to it."""
        from . import trace as trace_mod
        tb = trace_mod.current()
        if tb is None:
            return
        try:
            ts0 = t0 * 1e6
            flow_id = (hash(record["trace_ids"][0]) & 0x7FFFFFFF
                       if record["trace_ids"]
                       else int(ts0) & 0x7FFFFFFF)
            name = f"device/batch rung={record.get('rung')}"
            args = {"trace_ids": record["trace_ids"],
                    "device_time_s": round(dt, 6)}
            tb.add_flow(name, flow_id, ts0, "s")
            tb.add_complete(name, ts0, dt * 1e6, cat="device",
                            args=args, tid=_DEVICE_LANE_TID,
                            tname="device (sampled)")
            tb.add_flow(name, flow_id, ts0 + dt * 1e6, "f",
                        tid=_DEVICE_LANE_TID)
        except Exception as e:   # noqa: BLE001
            _warn(f"flow-event emit failed: {e}")

    def section(self):
        """The `deviceprof` dict for stats() and /debug/vars."""
        with self._lock:
            return {
                "profile_sample_n": self.every_n,
                "batches_seen": self._count,
                "sampled": self._sampled,
                "captures": self._captures,
                "capture_errors": self._capture_errors,
                "last": self._last,
                "top_ops": list(self._top_ops),
            }


# synthetic tid for the "device (sampled)" Perfetto lane
_DEVICE_LANE_TID = 0x7EF1CE

_active_sampler = None


def sampler_from_flags(scope_map=None, on_card=None):
    """A SamplingProfiler when the `profile_sample_n` flag is positive,
    else None — the disabled path constructs NOTHING. The instance
    registers as the module's active sampler so stats()/debug_vars see
    it."""
    global _active_sampler
    from .. import flags
    n = int(flags.get("profile_sample_n") or 0)
    if n <= 0:
        return None
    sampler = SamplingProfiler(n, scope_map=scope_map, on_card=on_card)
    _active_sampler = sampler
    return sampler


def stats():
    """The active serving sampler's section, or None (section omitted
    from debug_vars)."""
    return _active_sampler.section() if _active_sampler else None


def reset():
    """Test isolation."""
    global _active_sampler
    _active_sampler = None
