"""Flight recorder: a bounded ring of recent spans/events, dumped as a
post-mortem bundle when the run dies.

The port's own copy of `paddle_tpu/monitor/blackbox.py`. Every finished
span and every noted event lands in a fixed-size ring buffer (newest
wins, O(1), thread-safe), and the escalation paths — the executor's
NaN-guard trips, the Trainer's rollback / restore / preemption, serving
batch and step failures — call `maybe_dump(reason, error)` to write
everything the ring holds PLUS a metrics snapshot, resolved flags, the
card's memory (`torch.cuda.memory_stats`) and the error context into
`<blackbox_dir>/blackbox-<ts>.json`, with a `health` section while a
HealthMonitor is active.

Recording is gated like every other monitor surface (free when the
`metrics` flag is off and no trace is active — spans.on()); dumping is
gated by the `blackbox_dir` flag (`PADDLE_TPU_BLACKBOX_DIR`): unset
means the ring still records (cheap) but nothing is written. `dump()`
with an explicit path writes unconditionally.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from . import registry as _registry

__all__ = ["FlightRecorder", "recorder", "note_span", "note_event",
           "dump", "maybe_dump", "reset"]

# Ring capacity: 512 records ≈ a few hundred KB of host RAM and, at the
# instrumented span density (≈10 spans/step, ≈6 spans/request), tens of
# steps / requests of lookback — enough to see the lead-up to a crash
# without competing with the trace exporter for "full history" duty.
_CAPACITY = 512


class FlightRecorder:
    """Thread-safe bounded ring of JSON-able records (newest evicts
    oldest). Records are plain dicts: spans via `note_span`, ad-hoc
    events via `note_event`."""

    def __init__(self, capacity=_CAPACITY):
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=int(capacity))
        self.dropped = 0          # records evicted by wraparound

    @property
    def capacity(self):
        return self._ring.maxlen

    def set_capacity(self, capacity):
        """Resize, keeping the newest records (tests; boot-time tuning)."""
        with self._lock:
            self._ring = collections.deque(self._ring,
                                           maxlen=int(capacity))
        return self

    def note(self, record):
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(record)

    def records(self):
        """Copy-on-read view, oldest first."""
        with self._lock:
            return list(self._ring)

    def spans_for_trace(self, trace_id):
        """All recorded spans belonging to `trace_id` — by the span's
        own trace_id OR by membership in a shared span's `trace_ids`
        attr (a batch-dispatch span belongs to every co-batched
        request's trace), oldest first."""
        out = []
        for rec in self.records():
            if rec.get("kind") != "span":
                continue
            if rec.get("trace_id") == trace_id or \
                    trace_id in (rec.get("attrs") or {}).get(
                        "trace_ids", ()):
                out.append(rec)
        return out

    def clear(self):
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def __len__(self):
        with self._lock:
            return len(self._ring)


_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    return _recorder


def note_span(span):
    """Called by Span.finish — already behind the spans.on() gate."""
    _recorder.note(span.to_dict())
    # no-op in trace-only mode (registry disabled): the counter exists
    # for metrics consumers, the ring is the source of truth
    _registry.counter_inc("monitor.spans")


def note_event(name, **data):
    """Record an ad-hoc event (escalations, restores, shutdowns). Free
    when telemetry is off — same gate as the metrics helpers."""
    from . import spans as _spans
    if not _spans.on():
        return
    _recorder.note({"kind": "event", "name": name,
                    "ts_us": time.perf_counter() * 1e6,
                    "thread": threading.current_thread().name, **data})


def _device_memory():
    """Best-effort device memory stats — a post-mortem must never fail
    because the backend is dead (that may be WHY we are dumping)."""
    try:
        from . import introspect
        return introspect.device_memory_stats()
    except Exception as e:   # noqa: BLE001 — diagnostics only
        return {"error": f"{type(e).__name__}: {e}"}


# maybe_dump is called from several layers for the SAME failure (the
# executor's NaN guard raises, the trainer's anomaly handler sees the
# same exception): dedupe by marking the exception object itself — a
# raw id() could be recycled by a later unrelated exception (silently
# suppressing its bundle), a strong reference would pin the traceback
# frames (and the model/batch arrays in their locals) for the life of
# the process, and a weak reference is impossible (builtin exception
# instances have no __weakref__ slot). Exceptions DO carry a __dict__.
_DUMPED_ATTR = "__paddle_tpu_torch_blackbox_dumped__"
_dump_counter = 0
_dump_lock = threading.Lock()


def dump(reason, error=None, path=None, extra=None):
    """Write the post-mortem bundle; returns the path.

    With `path=None` the destination is `blackbox-<ts>.json` under the
    `blackbox_dir` flag directory — a ValueError when neither is set
    (use maybe_dump() for the fire-and-forget spelling)."""
    global _dump_counter
    from .. import flags
    if path is None:
        d = flags.get("blackbox_dir")
        if not d:
            raise ValueError("dump() needs a path or the blackbox_dir "
                             "flag (PADDLE_TPU_BLACKBOX_DIR)")
        with _dump_lock:
            _dump_counter += 1
            n = _dump_counter
        ts = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(d, f"blackbox-{ts}-{os.getpid()}-{n}.json")
    from . import spans as _spans
    cur = _spans._current.get()
    bundle = {
        "reason": reason,
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "pid": os.getpid(),
        # the span the failing thread is INSIDE right now (e.g. the
        # trainer/step that is dying): it has not finished, so it is not
        # in the ring yet — snapshot it here or the bundle would show
        # every step except the one that crashed
        "open_span": (cur.to_dict() if isinstance(cur, _spans.Span)
                      else None),
        "error": (f"{type(error).__name__}: {error}"
                  if isinstance(error, BaseException)
                  else (str(error) if error is not None else None)),
        "error_context": _executor_error_context(),
        "flags": flags.snapshot(),
        "records": _recorder.records(),
        "records_dropped": _recorder.dropped,
        "metrics": _registry.snapshot(),
        "device_memory": _device_memory(),
    }
    try:
        # model-health lead-up (grad-norm trend, update ratios, loss
        # EMA) from the active HealthMonitor — the training context a
        # crash bundle was blind to before monitor/health.py
        from . import health as _health
        section = _health.current_section()
        if section is not None:
            bundle["health"] = section
    except Exception as e:   # noqa: BLE001 — diagnostics only
        bundle["health"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        # input-pipeline lead-up (stalls, queue depth, wait times) from
        # the active DeviceFeeder — was the run starving when it died?
        from ..reader import pipeline as _pipeline
        feed = _pipeline.feed_stats()
        if feed is not None:
            bundle["feed"] = feed
    except Exception as e:   # noqa: BLE001 — diagnostics only
        bundle["feed"] = {"error": f"{type(e).__name__}: {e}"}
    if extra:
        bundle.update(extra)
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with open(path, "w") as f:
        json.dump(bundle, f, indent=1, default=str)
    return path


def maybe_dump(reason, error=None, extra=None):
    """The escalation-path hook: write a bundle when `blackbox_dir` is
    configured, skip silently otherwise, dedupe per failure, and NEVER
    raise — a broken disk must not mask the failure being recorded.
    Returns the path or None."""
    from .. import flags
    try:
        if not flags.get("blackbox_dir"):
            return None
        if error is not None and getattr(error, _DUMPED_ATTR, False):
            return None               # this failure already has a bundle
        path = dump(reason, error=error, extra=extra)
        # marked only AFTER the write succeeded: a transient dump
        # failure (ENOSPC, unwritable dir) must leave the next layer's
        # attempt for the same exception free to retry
        if error is not None:
            try:
                setattr(error, _DUMPED_ATTR, True)
            except (AttributeError, TypeError):
                pass   # __slots__ exception: duplicate bundles beat
                       # losing one
        return path
    except Exception as e:   # noqa: BLE001 — diagnostics only
        import sys
        print(f"blackbox dump failed ({reason}): {e}", file=sys.stderr)
        return None


def _executor_error_context():
    from .. import executor as executor_mod
    return executor_mod._current_error_context()


def reset():
    """Tests: empty the ring."""
    _recorder.clear()
