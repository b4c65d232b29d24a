"""Correlated spans: trace_id / span_id / parent propagation over host
regions.

The port's own copy of `paddle_tpu/monitor/spans.py`.

`monitor.span(name)` regions so far were anonymous Chrome-trace
rectangles: fine for "how long did compile take", useless for "follow
THIS serving request from admission to response" or "why was step 1234
slow". A `Span` carries the OpenTelemetry-shaped identity triple —

  trace_id   one logical operation end to end (a serving request, a
             training step); 16 hex chars, propagated to every span the
             operation touches (inbound via the `x-trace-id` HTTP
             header, outbound in the response)
  span_id    this region; 16 hex chars
  parent_id  the enclosing span's span_id (None at the root)

plus free-form `attrs`. Parentage propagates ambiently through a
contextvar for same-thread nesting (a trainer step's executor phases
need no plumbing) and EXPLICITLY via `parent=`/`trace_id=` for
lifecycles that cross threads (a serving request is admitted on an HTTP
handler thread and completed on the batcher thread).

Where spans land (both optional, both thread-safe):

  * the ambient Chrome trace (monitor/trace.py), as complete events on
    the track of the thread that STARTED the span, with the identity
    triple in `args` — so one Perfetto load shows the request tree and
    clicking any rectangle reveals its trace id;
  * the flight recorder ring buffer (monitor/blackbox.py), so a crash
    bundle contains the last-N spans including the failing one.

Overhead contract: recording is on when the metrics registry is enabled
OR an ambient trace is active; otherwise `span()` / `start_span()` are
early-return no-ops under the same disabled-path budget as the metrics
helpers (the port has no overhead guard in tier-1: chip_smoke.py measures it).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import random
import threading
import time

from . import registry as _registry
from . import trace as _trace

__all__ = ["Span", "SpanContext", "span", "start_span", "on",
           "current_context", "attach", "new_trace_id", "new_span_id"]


class SpanContext:
    """The propagatable identity of a live (or finished) span."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext({self.trace_id}, {self.span_id})"


# Id generation: a per-process random base XOR a process-wide counter —
# unique within the process, collision-resistant across processes (the
# base comes from os.urandom), and ~10x cheaper than uuid4 on the
# serving hot path. itertools.count is atomic under the GIL.
_rng = random.Random(int.from_bytes(os.urandom(8), "big") ^ os.getpid())
_TRACE_BASE = _rng.getrandbits(64)
_SPAN_BASE = _rng.getrandbits(64)
_trace_counter = itertools.count(1)
_span_counter = itertools.count(1)
_MASK = (1 << 64) - 1


def new_trace_id():
    return f"{(_TRACE_BASE + (next(_trace_counter) * 0x9e3779b9)) & _MASK:016x}"


def new_span_id():
    return f"{(_SPAN_BASE + (next(_span_counter) * 0x9e3779b9)) & _MASK:016x}"


def on():
    """Is span recording active? One gate for every instrumentation
    site: the metrics registry is enabled (flight recorder collects) or
    an ambient Chrome trace is running (exporter collects)."""
    return (_registry._ENABLED
            if _registry._ENABLED is not None else _registry.enabled()) \
        or _trace.current() is not None


_current: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_span", default=None)


def current_context():
    """The ambient SpanContext (for explicit cross-thread propagation),
    or None."""
    return _current.get()


class Span:
    """One timed region with identity. Created by start_span()/span();
    `finish()` is idempotent and may run on a different thread than the
    start (the tid recorded at start keeps the Chrome-trace event on the
    starting thread's track)."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "attrs", "t0_us", "dur_us", "status", "error", "tid",
                 "thread_name", "_done")

    def __init__(self, name, trace_id, parent_id, attrs, cat="span"):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.attrs = attrs
        self.t0_us = time.perf_counter() * 1e6
        self.dur_us = None
        self.status = "ok"
        self.error = None
        self.tid = threading.get_ident()
        self.thread_name = threading.current_thread().name
        self._done = False

    @property
    def context(self):
        return SpanContext(self.trace_id, self.span_id)

    def set_attr(self, key, value):
        self.attrs[key] = value
        return self

    def finish(self, error=None):
        """Close the span and emit it (trace + flight recorder). The
        first call wins; later calls are no-ops so shed/failed serving
        requests can be closed defensively from several paths."""
        if self._done:
            return self
        self._done = True
        self.dur_us = time.perf_counter() * 1e6 - self.t0_us
        if error is not None:
            self.status = "error"
            self.error = f"{type(error).__name__}: {error}" \
                if isinstance(error, BaseException) else str(error)
        tr = _trace.current()
        if tr is not None:
            args = {"trace_id": self.trace_id, "span_id": self.span_id}
            if self.parent_id:
                args["parent_id"] = self.parent_id
            if self.error:
                args["error"] = self.error
            args.update(self.attrs)
            tr.add_complete(self.name, self.t0_us, self.dur_us,
                            cat=self.cat, args=args,
                            tid=self.tid, tname=self.thread_name)
        from . import blackbox
        blackbox.note_span(self)
        return self

    def to_dict(self):
        return {"kind": "span", "name": self.name,
                "trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "ts_us": self.t0_us,
                "dur_us": self.dur_us, "status": self.status,
                "error": self.error, "thread": self.thread_name,
                "attrs": dict(self.attrs)}

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"span={self.span_id}, status={self.status})")


def start_span(name, parent=None, trace_id=None, attrs=None,
               cat="span"):
    """Begin a span WITHOUT making it ambient — the manual API for
    lifecycles that cross threads (serving requests). Returns None when
    recording is off (callers hold the None and pass it around freely:
    finish()/set_attr() access is guarded at the call site with
    `if span is not None` or the `_maybe` helpers below).

    parent: a Span, a SpanContext, or None. None adopts the ambient
    context when one is set (same-thread nesting); pass trace_id to pin
    the trace explicitly (e.g. an inbound x-trace-id header).
    """
    if not on():
        return None
    if parent is None:
        parent = _current.get()
        if parent is not None and trace_id is not None \
                and parent.trace_id != trace_id:
            # a parent must share the trace (the OTel invariant every
            # tree-walker here assumes): an explicitly-pinned trace id
            # starts a fresh root rather than dangling off whatever
            # unrelated span the caller happens to be inside (e.g.
            # engine.submit invoked from an instrumented eval loop)
            parent = None
    if parent is not None:
        pid = parent.span_id
        tid = trace_id or parent.trace_id
    else:
        pid = None
        tid = trace_id or new_trace_id()
    return Span(name, tid, pid, dict(attrs) if attrs else {}, cat=cat)


@contextlib.contextmanager
def span(name, cat="span", args=None, attrs=None, parent=None,
         trace_id=None):
    """Ambient correlated region: nests under the current span (same
    thread), records into the Chrome trace and the flight recorder on
    exit, marks status=error (and re-raises) on exception. Yields the
    Span, or None when recording is off.

    `cat`/`args` keep the pre-correlation monitor.span signature (args
    merge into attrs; cat becomes the Chrome-trace event category)."""
    sp = start_span(name, parent=parent, trace_id=trace_id, cat=cat,
                    attrs=(dict(args or (), **(attrs or {}))
                           or None) if (args or attrs) else None)
    if sp is None:
        yield None
        return
    token = _current.set(sp)
    try:
        yield sp
    except BaseException as e:
        sp.finish(error=e)
        raise
    finally:
        _current.reset(token)
        sp.finish()


@contextlib.contextmanager
def attach(context):
    """Make `context` (a Span or SpanContext) ambient for the duration —
    how a worker thread adopts a request's trace before opening child
    spans."""
    token = _current.set(context)
    try:
        yield context
    finally:
        _current.reset(token)
