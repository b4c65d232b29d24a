"""Flight recorder: not ported yet.

The reference (`paddle_tpu/monitor/blackbox.py`) keeps a ring of the
last finished spans and events and writes `blackbox-<ts>.json`
post-mortem bundles on serving step failures, NaN-guard trips,
rollbacks and preemptions. Until that recorder is ported, `maybe_dump`
and `note_event` keep the call sites' shape and do nothing: the
scheduler still fails the affected requests and counts
`serving_lm.errors`, and the Trainer still counts its `resilience.*`
events.
"""

from __future__ import annotations

__all__ = ["maybe_dump", "note_event"]


def maybe_dump(reason, error=None, extra=None):
    """No-op until the flight recorder is ported; returns None (the
    reference returns the bundle path, or None when nothing was
    written)."""
    return None


def note_event(kind, **fields):
    """No-op until the flight recorder is ported (the reference appends
    `{kind, **fields}` to the recorder's event ring)."""
    return None
