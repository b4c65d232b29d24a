"""Profiler: timer registry + report table + trace capture.

The port's copy of `paddle_tpu/profiler.py`, a facade over
`paddle_tpu_torch.monitor`:

  * named host regions — `record_event(name)`; `stop_profiler` prints
    the ParseEvents-style table (calls / total / min / max / avg /
    ratio, sorted by `sorted_key`) and returns its rows.
  * timelines — `start/stop_profiler(trace_dir)` writes a host Chrome
    trace of the record_event regions and spans
    (`<trace_dir>/host_trace.json`) and a `torch.profiler` trace of the
    card (`<trace_dir>/plugins/profile/<run>/<host>.pt.trace.json`,
    kineto's Chrome trace: kernels, launches, and the executor's per-op
    "<block>/<idx>:<op_type>" scopes, which are entered while the
    profiler runs), the newest TRACE_RETAIN runs kept.
  * `cost_analysis(program, feed)` — the reference's takes a jitted JAX
    function and asks XLA; the port's takes a Program and returns the
    static FLOP tally of monitor.introspect (`{"flops": n}`), and raises
    TypeError for anything else (XLA's cost model is JAX-only).

The public API (`record_event`, `start/stop_profiler`, `reset_profiler`,
`report`, `profiler`, `cuda_profiler`, `cost_analysis`, `is_profiling`)
and the report() row schema are the reference's.
"""

from __future__ import annotations

import collections
import contextlib
import time

from .monitor import deviceprof as _deviceprof
from .monitor import trace as _trace

__all__ = ["profiler", "record_event", "start_profiler", "stop_profiler",
           "reset_profiler", "report", "cuda_profiler", "cost_analysis",
           "is_profiling"]

_on = False
_records = collections.OrderedDict()   # name -> list of durations (s)

# Retention cap on accumulated device-trace runs: every
# start_profiler(trace_dir=...) session adds one
# <trace_dir>/plugins/profile/<timestamp>/ subdirectory (tens of MB of
# trace files each) and nothing ever deleted them — a long-lived
# trainer profiling every eval round grows the dir without bound. The
# newest TRACE_RETAIN runs are kept; older ones are pruned at session
# start, counted in `profiler.traces_pruned`.
TRACE_RETAIN = 8


def _prune_trace_runs(trace_dir, keep=None):
    """Delete all but the newest `keep` profiler-run subdirectories
    under `<trace_dir>/plugins/profile/`; returns how many were
    removed. Best-effort: IO failures skip the run, never raise."""
    import os
    import shutil

    keep = TRACE_RETAIN if keep is None else max(int(keep), 0)
    root = os.path.join(trace_dir, "plugins", "profile")
    if not os.path.isdir(root):
        return 0
    runs = []
    for d in os.listdir(root):
        p = os.path.join(root, d)
        if os.path.isdir(p):
            try:
                runs.append((os.path.getmtime(p), p))
            except OSError:
                continue
    runs.sort()
    pruned = 0
    for _, p in runs[:max(len(runs) - keep, 0)]:
        try:
            shutil.rmtree(p)
            pruned += 1
        except OSError:
            continue
    if pruned:
        from . import monitor
        monitor.counter_inc("profiler.traces_pruned", pruned)
    return pruned


def is_profiling():
    return _on


@contextlib.contextmanager
def record_event(name):
    """RecordEvent analog (platform/profiler.h:104): times the region
    under `name` when the table profiler is on and/or a host trace is
    active; free when both are off."""
    tr = _trace.current()
    if not _on and tr is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if _on:
            _records.setdefault(name, []).append(dt)
        if tr is not None:
            tr.add_complete(name, t0 * 1e6, dt * 1e6)


def reset_profiler():
    _records.clear()


def start_profiler(state="All", trace_dir=None):
    """Begin collecting events; with `trace_dir`, also a host Chrome
    trace (written on stop) and a torch.profiler trace (best effort)."""
    global _on
    _on = True
    reset_profiler()
    if trace_dir:
        import os
        session_path = os.path.join(trace_dir, "host_trace.json")
        tr = _trace.current()
        if tr is not None and tr.path:
            # an ambient trace (trace_path flag) stays LIVE — it keeps
            # accumulating for its own exit-time save — and the session
            # writes a copy of the builder at stop. The copy is the full
            # ambient view (pre-session events included; a buffer
            # already at its event cap adds nothing new): the trade for
            # never losing the ambient file's pre/post-session events.
            start_profiler._session_trace_path = session_path
            start_profiler._host_tracing = "shared"
        else:
            _trace.start(session_path)
            start_profiler._host_tracing = True
        # retention: keep TRACE_RETAIN-1 old runs so this session's new
        # run lands inside the cap
        _prune_trace_runs(trace_dir, keep=TRACE_RETAIN - 1)
        _start_device_trace(trace_dir)


def _start_device_trace(trace_dir):
    """Start a torch.profiler capture for the session (best effort: the
    host table and trace never depend on it); the executor enters its
    per-op scopes while it runs."""
    import os
    try:
        from torch.profiler import profile
        scopes = _deviceprof.profiling()
        scopes.__enter__()
        prof = profile(activities=_deviceprof._activities())
        try:
            prof.__enter__()
        except BaseException:
            scopes.__exit__(None, None, None)
            raise
        run = os.path.join(trace_dir, "plugins", "profile",
                           time.strftime("%Y_%m_%d_%H_%M_%S"))
        start_profiler._device = (prof, scopes, run)
    except Exception as e:   # device tracing is never load-bearing
        import sys
        print(f"profiler: torch device trace unavailable ({e!r}); "
              "host_trace.json is still written", file=sys.stderr)


def _stop_device_trace():
    """Stop the session's torch.profiler capture and write its trace;
    exception-safe (the host report must still be written)."""
    dev = getattr(start_profiler, "_device", None)
    start_profiler._device = None
    if dev is None:
        return
    prof, scopes, run = dev
    import os
    import socket
    try:
        prof.__exit__(None, None, None)
        os.makedirs(run, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(run, f"{socket.gethostname()}.pt.trace.json"))
    except Exception as e:   # noqa: BLE001 — never load-bearing
        import sys
        print(f"profiler: torch device trace stop failed ({e!r}); "
              "host report/trace are still written", file=sys.stderr)
    finally:
        scopes.__exit__(None, None, None)


def stop_profiler(sorted_key="total", profile_path=None):
    """Stop collecting and print/return the aggregate table
    (ParseEvents analog, platform/profiler.h:133-141).

    sorted_key: total | calls | max | min | ave (reference spellings).
    Returns the table as a list of row dicts.
    """
    global _on
    _on = False
    _stop_device_trace()
    host_tracing = getattr(start_profiler, "_host_tracing", False)
    if host_tracing == "shared":
        tr = _trace.current()
        try:
            if tr is not None:
                tr.save(start_profiler._session_trace_path)
        finally:
            start_profiler._host_tracing = False
    elif host_tracing:
        try:
            _trace.stop(save=True)
        finally:
            start_profiler._host_tracing = False
    rows = report(sorted_key)
    _print_table(rows, profile_path)
    return rows


def report(sorted_key="total"):
    rows = []
    grand_total = sum(sum(v) for v in _records.values()) or 1e-12
    for name, times in _records.items():
        total = sum(times)
        rows.append({
            "name": name, "calls": len(times), "total": total,
            "min": min(times), "max": max(times),
            "ave": total / len(times), "ratio": total / grand_total,
        })
    key = {"total": "total", "calls": "calls", "max": "max", "min": "min",
           "ave": "ave"}.get(sorted_key, "total")
    rows.sort(key=lambda r: r[key], reverse=True)
    return rows


def _print_table(rows, profile_path=None):
    header = (f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Min(ms)':>10}"
              f"{'Max(ms)':>10}{'Ave(ms)':>10}{'Ratio':>8}")
    lines = ["------------------------->  Profiling Report  "
             "<-------------------------", header]
    for r in rows:
        lines.append(
            f"{r['name']:<40}{r['calls']:>8}{r['total'] * 1e3:>12.3f}"
            f"{r['min'] * 1e3:>10.3f}{r['max'] * 1e3:>10.3f}"
            f"{r['ave'] * 1e3:>10.3f}{r['ratio']:>8.3f}")
    text = "\n".join(lines)
    print(text)
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(text + "\n")


@contextlib.contextmanager
def profiler(state="All", sorted_key="total", profile_path=None,
             trace_dir=None):
    """Context manager mirroring fluid.profiler.profiler (:76): profile
    the region, then print the report table (and write the Chrome trace
    when trace_dir is given)."""
    start_profiler(state, trace_dir=trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(*a, **k):
    """Reference-compat shim (fluid profiler.py:33): use
    start/stop_profiler(trace_dir=...) for a device timeline."""
    yield


def cost_analysis(program, feed=None):
    """Static cost of one step of a Program: {"flops": n}, the tally of
    monitor.introspect.program_flops (feed gives the batch dim). The
    reference's cost_analysis takes a jitted JAX function and returns
    XLA's cost model, which is JAX-only: anything but a Program raises
    TypeError."""
    from .framework import Program
    from .monitor import introspect
    if not isinstance(program, Program):
        raise TypeError(
            "cost_analysis takes a Program in the port (XLA's cost "
            "analysis of a jitted function is JAX-only); got "
            f"{type(program).__name__}")
    return {"flops": float(introspect.program_flops(program, feed))}
