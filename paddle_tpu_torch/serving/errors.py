"""Structured serving errors.

The reference's C-API returns flat status codes
(paddle/capi/error.h: kPD_NO_ERROR/kPD_OUT_OF_RANGE/...); an online
engine needs *actionable* failure classes a front end can map to HTTP
semantics: reject-now (429), missed-deadline (504), shutting-down
(503). Every class carries enough context to log without grabbing
engine internals.
"""

from __future__ import annotations

__all__ = ["ServingError", "ServerOverloadedError",
           "DeadlineExceededError", "EngineClosedError"]


class ServingError(RuntimeError):
    """Base class for engine-raised request failures."""


class ServerOverloadedError(ServingError):
    """Admission control rejected the request: the bounded queue is
    full. Back off and retry — nothing was enqueued or computed."""

    def __init__(self, queue_depth, queue_limit):
        self.queue_depth = queue_depth
        self.queue_limit = queue_limit
        super().__init__(
            f"server overloaded: queue depth {queue_depth} at limit "
            f"{queue_limit} — request rejected")


class DeadlineExceededError(ServingError):
    """The request's deadline expired before its batch was dispatched.
    Shed requests are never computed (no wasted device time)."""

    def __init__(self, waited_s, deadline_s):
        self.waited_s = waited_s
        self.deadline_s = deadline_s
        super().__init__(
            f"deadline exceeded: waited {waited_s * 1e3:.1f} ms against "
            f"a {deadline_s * 1e3:.1f} ms deadline — request shed "
            "before dispatch")


class EngineClosedError(ServingError):
    """submit() after shutdown(), or the request was abandoned by a
    non-draining shutdown."""
