"""Flight recorder: not ported yet.

The reference (`paddle_tpu/monitor/blackbox.py`) keeps a ring of the
last finished spans and writes `blackbox-<ts>.json` post-mortem bundles
on serving step failures. Until that recorder is ported, `maybe_dump`
keeps the call sites' shape and does nothing: the scheduler still
fails the affected requests and counts `serving_lm.errors`.
"""

from __future__ import annotations

__all__ = ["maybe_dump"]


def maybe_dump(reason, error=None, extra=None):
    """No-op until the flight recorder is ported; returns None (the
    reference returns the bundle path, or None when nothing was
    written)."""
    return None
