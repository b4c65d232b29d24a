"""Chrome-trace ("trace event format") exporter for host regions.

The port's own copy of `paddle_tpu/monitor/trace.py`: every finished
span and every `profiler.record_event` region becomes a complete
("ph": "X") event with microsecond timestamps, grouped into per-thread
tracks via tid + thread_name metadata; flow ("s"/"f") events link a
request's host span to its sampled device lane (monitor/deviceprof.py).
The output file loads directly in chrome://tracing and
https://ui.perfetto.dev.

Activation:
  * `profiler.start_profiler(trace_dir=...)` / `profiler.profiler(
    trace_dir=...)` — writes `<trace_dir>/host_trace.json` on stop.
  * flag `trace_path` (env `PADDLE_TPU_TRACE_PATH`) — trace from first
    use, written at interpreter exit (atexit) or by `stop()`.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
import time

__all__ = ["TraceBuilder", "start", "stop", "current", "instant"]


# Event cap for long-lived (ambient) traces: each event dict is a few
# hundred bytes of host RAM, buffered until save — a million-step run
# with per-step run/compile regions would otherwise grow without bound
# (the same concern _HIST_MAX_SAMPLES addresses in registry.py). At the
# cap, recording stops and ONE truncation marker is appended; trace
# viewers choke on multi-million-event files anyway.
_MAX_EVENTS = 500_000


class TraceBuilder:
    """Accumulates trace events; thread-safe; serializes to the Chrome
    trace-event JSON object format ({"traceEvents": [...]})."""

    def __init__(self, path=None):
        self.path = path
        self._lock = threading.Lock()
        self._events = []
        self._named_tids = set()
        self._truncated = False
        self.pid = os.getpid()

    @staticmethod
    def _now_us():
        return time.perf_counter() * 1e6

    def _thread_meta(self, tid, tname=None):
        if tid in self._named_tids:
            return
        self._named_tids.add(tid)
        if tname is None:
            # only trust the ambient thread name for the ambient tid —
            # a span finishing on another thread passes the starting
            # thread's name explicitly
            tname = (threading.current_thread().name
                     if tid == threading.get_ident() else f"thread-{tid}")
        self._events.append({
            "ph": "M", "name": "thread_name", "pid": self.pid, "tid": tid,
            "args": {"name": tname}})

    def _append(self, tid, ev, tname=None):
        """Caller must hold no lock. Enforces the event cap."""
        with self._lock:
            if len(self._events) >= _MAX_EVENTS:
                if not self._truncated:
                    self._truncated = True
                    self._events.append({
                        "ph": "i", "name": "trace_truncated",
                        "cat": "host", "pid": self.pid, "tid": tid,
                        "ts": self._now_us(), "s": "g",
                        "args": {"max_events": _MAX_EVENTS}})
                return
            self._thread_meta(tid, tname)
            self._events.append(ev)

    def add_complete(self, name, ts_us, dur_us, cat="host", args=None,
                     tid=None, tname=None):
        """One finished region ("X" phase, ts/dur in microseconds).
        `tid`/`tname` pin the event to a specific thread track — a span
        that STARTED on another thread stays on that thread's track even
        when it finishes here (serving requests close on the batcher
        thread)."""
        if tid is None:
            tid = threading.get_ident()
        ev = {"ph": "X", "name": name, "cat": cat, "pid": self.pid,
              "tid": tid, "ts": ts_us, "dur": dur_us}
        if args:
            ev["args"] = args
        self._append(tid, ev, tname)

    def add_flow(self, name, flow_id, ts_us, phase, cat="flow",
                 tid=None, tname=None):
        """One endpoint of a flow arrow (trace-event "s"/"f" phases,
        shared `id`): Perfetto draws an arrow between the enclosing
        slices of matching endpoints. deviceprof uses this to connect a
        request's host dispatch span to its sampled device-lane slice —
        one story per request across tracks. `phase` is "s" (start) or
        "f" (finish; binds to the enclosing slice's end, "bp": "e")."""
        if phase not in ("s", "f"):
            raise ValueError(f"flow phase must be 's' or 'f', "
                             f"got {phase!r}")
        if tid is None:
            tid = threading.get_ident()
        ev = {"ph": phase, "name": name, "cat": cat, "pid": self.pid,
              "tid": tid, "ts": ts_us, "id": int(flow_id)}
        if phase == "f":
            ev["bp"] = "e"
        self._append(tid, ev, tname)

    def add_instant(self, name, cat="host", args=None):
        tid = threading.get_ident()
        ev = {"ph": "i", "name": name, "cat": cat, "pid": self.pid,
              "tid": tid, "ts": self._now_us(), "s": "t"}
        if args:
            ev["args"] = args
        self._append(tid, ev)

    @contextlib.contextmanager
    def span(self, name, cat="host", args=None):
        t0 = self._now_us()
        try:
            yield
        finally:
            self.add_complete(name, t0, self._now_us() - t0, cat=cat,
                              args=args)

    def to_dict(self):
        with self._lock:
            events = list(self._events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path=None):
        path = path or self.path
        if not path:
            raise ValueError("TraceBuilder has no output path")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


_active: TraceBuilder | None = None
_flag_checked = False
_atexit_registered = False


def _save_at_exit():
    if _active is not None and _active.path:
        try:
            _active.save()
        except OSError:       # pragma: no cover - exit-time best effort
            pass


def start(path=None):
    """Begin a host trace. `path` (optional) is where `stop()` / atexit
    will write the JSON. Returns the active builder (idempotent: an
    already-running trace is kept)."""
    global _active, _atexit_registered, _flag_checked
    # any explicit start settles the flag question: after a later
    # stop(), current() must NOT resurrect an ambient trace from the
    # flag — its exit save would overwrite the already-written file
    _flag_checked = True
    if _active is None:
        _active = TraceBuilder(path)
    elif path and not _active.path:
        _active.path = path
    if path and not _atexit_registered:
        _atexit_registered = True
        atexit.register(_save_at_exit)
    return _active


def stop(save=True):
    """End the trace; write the file when it has a path. Returns the
    written path (or the builder when pathless), None if not tracing."""
    global _active
    tr = _active
    _active = None
    if tr is None:
        return None
    if save and tr.path:
        return tr.save()
    return tr


def configure_from_flag(value):
    """flags side effect for `trace_path`: a non-empty path starts the
    ambient trace (first set wins; clearing does not stop a running
    trace — use profiler.stop_profiler or monitor.trace.stop)."""
    if value and _active is None:
        start(value)


def current() -> TraceBuilder | None:
    """The ambient trace, or None. First call resolves the `trace_path`
    flag (env PADDLE_TPU_TRACE_PATH) so exporting needs no code change;
    afterwards this is one global load + None test."""
    global _flag_checked
    if _active is None and not _flag_checked:
        _flag_checked = True
        from .. import flags
        # flags.get fires configure_from_flag via its side-effect hook
        val = flags.get("trace_path")
        if val and _active is None:    # pragma: no cover - belt & braces
            configure_from_flag(val)
    return _active


def instant(name, cat="host", args=None):
    tr = current()
    if tr is not None:
        tr.add_instant(name, cat=cat, args=args)
