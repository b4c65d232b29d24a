"""Correlated spans: trace_id / span_id / parent propagation.

The port's own copy of the span identity of `paddle_tpu/monitor/
spans.py`: a `Span` carries trace_id (one request end to end, 16 hex
chars, adopted from an inbound `x-trace-id`), span_id, parent_id and
free-form attrs. Parentage propagates through a contextvar for
same-thread nesting and explicitly via `parent=`/`trace_id=` across
threads (a request is admitted on an HTTP thread and finished on the
scheduler thread).

Recording is on when the metrics registry is enabled; otherwise
`span()` / `start_span()` return None at once. Finished spans are
counted in `monitor.spans`; the Chrome-trace exporter and the flight
recorder ring of the reference are not ported yet (see blackbox.py).
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

__all__ = ["Span", "span", "start_span", "on", "new_trace_id",
           "new_span_id"]

# per-process random base XOR a process-wide counter: unique within the
# process, collision-resistant across processes
_rng = random.Random(int.from_bytes(os.urandom(8), "big") ^ os.getpid())
_TRACE_BASE = _rng.getrandbits(64)
_SPAN_BASE = _rng.getrandbits(64)
_trace_counter = itertools.count(1)
_span_counter = itertools.count(1)
_MASK = (1 << 64) - 1


def new_trace_id():
    return f"{(_TRACE_BASE + next(_trace_counter) * 0x9e3779b9) & _MASK:016x}"


def new_span_id():
    return f"{(_SPAN_BASE + next(_span_counter) * 0x9e3779b9) & _MASK:016x}"


def on():
    """Is span recording active (the metrics registry is enabled)?"""
    return (_registry._ENABLED if _registry._ENABLED is not None
            else _registry.enabled())


_current: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_span", default=None)


class Span:
    """One timed region with identity; `finish()` is idempotent and may
    run on another thread than the start."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "t0_us", "dur_us", "status", "error", "thread_name",
                 "_done")

    def __init__(self, name, trace_id, parent_id, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.attrs = attrs
        self.t0_us = time.perf_counter() * 1e6
        self.dur_us = None
        self.status = "ok"
        self.error = None
        self.thread_name = threading.current_thread().name
        self._done = False

    def set_attr(self, key, value):
        self.attrs[key] = value
        return self

    def finish(self, error=None):
        if self._done:
            return self
        self._done = True
        self.dur_us = time.perf_counter() * 1e6 - self.t0_us
        if error is not None:
            self.status = "error"
            self.error = (f"{type(error).__name__}: {error}"
                          if isinstance(error, BaseException) else str(error))
        _registry.counter_inc("monitor.spans")
        return self


def start_span(name, parent=None, trace_id=None, attrs=None):
    """Begin a span without making it ambient (cross-thread
    lifecycles). Returns None when recording is off."""
    if not on():
        return None
    if parent is None:
        parent = _current.get()
        if parent is not None and trace_id is not None \
                and parent.trace_id != trace_id:
            # an explicitly pinned trace starts a fresh root
            parent = None
    if parent is not None:
        pid, tid = parent.span_id, trace_id or parent.trace_id
    else:
        pid, tid = None, trace_id or new_trace_id()
    return Span(name, tid, pid, dict(attrs) if attrs else {})


@contextlib.contextmanager
def span(name, attrs=None, parent=None, trace_id=None):
    """Ambient correlated region; yields the Span, or None when
    recording is off. Marks status=error (and re-raises) on exception."""
    sp = start_span(name, parent=parent, trace_id=trace_id, attrs=attrs)
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
