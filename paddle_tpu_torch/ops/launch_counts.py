"""The kernel wrappers' host-side counts, in one registry.

Each wrapper keeps its counts as attributes of itself (`launches`, and
where it has them `calls`, `dq_partials`, `repacks`, `k_pads`), which
`chip_smoke.py` and the tests read and reset. A wrapper declares them
with `counted(fn, *attrs)` and moves them only through `count`, so that
every count is seen by whoever tallies it: a CUDA-graph capture
(serving/graphs.py) runs the wrappers' Python once and their kernels on
every replay, so it tallies the counts its own thread made during the
capture, takes them back, and adds them again on each replay.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["counted", "count", "counters", "tallied"]

_REGISTERED = []            # (wrapper, attribute), in declaration order
_local = threading.local()


def counted(fn, *attrs):
    """Declare fn's counts `attrs`, each starting at 0; returns fn."""
    for a in attrs:
        setattr(fn, a, 0)
        _REGISTERED.append((fn, a))
    return fn


def count(fn, attr, n=1):
    """Add n to fn.attr, and to the tally this thread keeps, if any."""
    setattr(fn, attr, getattr(fn, attr) + n)
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[(fn, attr)] = tally.get((fn, attr), 0) + n


def counters():
    """Every declared (wrapper, attribute) pair."""
    return tuple(_REGISTERED)


@contextlib.contextmanager
def tallied():
    """Yields {(wrapper, attribute): n}, the counts this thread makes
    inside the block (another thread's counts are not in it)."""
    outer = getattr(_local, "tally", None)
    _local.tally = tally = {}
    try:
        yield tally
    finally:
        _local.tally = outer
        if outer is not None:
            for key, n in tally.items():
                outer[key] = outer.get(key, 0) + n
