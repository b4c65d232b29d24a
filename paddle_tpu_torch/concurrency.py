"""CSP channels, the port's copy of `paddle_tpu/concurrency.py`
(reference fluid/framework/channel.h + the
buffered/unbuffered details): Go-style channels for coordinating
host-side pipeline stages (readers, feeders, trainers). The reference
ships these as C++ templates exercised only by unit tests; here they
are host objects with the IDENTICAL contract, tested against the same
scenarios (channel_test.cc):

  - send to a full buffered channel blocks until a receive or close;
  - receive from an empty channel blocks until a send or close;
  - send on a closed channel returns False immediately;
  - receive on a closed channel drains residual buffered values first,
    then returns (None, False);
  - an unbuffered channel is a rendezvous: send completes only when a
    receiver takes the value;
  - FIFO order is preserved.

Device-side work needs none of this; these exist for the host runtime
around it, like the DeviceFeeder's queue-based pipeline.
"""

from __future__ import annotations

import threading
from collections import deque

__all__ = ["Channel", "make_channel", "close_channel", "go"]


class Channel:
    """Abstract base (channel.h:21-28)."""

    def send(self, value) -> bool:
        raise NotImplementedError

    def receive(self):
        """Returns (value, True) or (None, False) when closed-and-empty."""
        raise NotImplementedError

    @property
    def cap(self) -> int:
        raise NotImplementedError

    def close(self):
        raise NotImplementedError


class _Buffered(Channel):
    def __init__(self, cap):
        if cap <= 0:
            raise ValueError("buffered channel needs cap > 0")
        self._cap = int(cap)
        self._q = deque()
        self._closed = False
        self._cond = threading.Condition()

    @property
    def cap(self):
        return self._cap

    def send(self, value):
        with self._cond:
            self._cond.wait_for(
                lambda: len(self._q) < self._cap or self._closed)
            if self._closed:
                return False
            self._q.append(value)
            self._cond.notify_all()
            return True

    def receive(self):
        with self._cond:
            self._cond.wait_for(lambda: self._q or self._closed)
            if self._q:          # residual values drain after close
                value = self._q.popleft()
                self._cond.notify_all()
                return value, True
            return None, False

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class _UnBuffered(Channel):
    """Rendezvous channel: each send hands its value directly to one
    receiver (details/unbuffered_channel.h). Every installed value gets
    a monotonically increasing ticket and receivers ack BY TICKET, so a
    competing sender can never steal another send's acknowledgement
    (a bare taken-flag lets sender B reset the flag between receiver's
    ack and sender A's wakeup, deadlocking A)."""

    def __init__(self):
        self._slot = None          # None | [value]
        self._seq = 0              # ticket of the installed value
        self._acked = 0            # highest ticket a receiver consumed
        self._closed = False
        self._cond = threading.Condition()

    @property
    def cap(self):
        return 0

    def send(self, value):
        with self._cond:
            self._cond.wait_for(
                lambda: self._slot is None or self._closed)
            if self._closed:
                return False
            self._seq += 1
            ticket = self._seq
            self._slot = [value]
            self._cond.notify_all()
            self._cond.wait_for(
                lambda: self._acked >= ticket or self._closed)
            if self._acked >= ticket:
                return True
            # closed before any receiver arrived: retract OUR value
            # (a later ticket means someone else owns the slot)
            if self._slot is not None and self._seq == ticket:
                self._slot = None
            return False

    def receive(self):
        with self._cond:
            self._cond.wait_for(
                lambda: self._slot is not None or self._closed)
            if self._slot is not None:
                value = self._slot[0]
                self._slot = None
                self._acked = self._seq
                self._cond.notify_all()
                return value, True
            return None, False

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()


def make_channel(buffer_size=0):
    """channel.h:40 MakeChannel: buffer_size > 0 -> buffered, 0 ->
    unbuffered (rendezvous)."""
    if buffer_size < 0:
        raise ValueError("buffer_size must be >= 0 (0 = unbuffered)")
    if buffer_size > 0:
        return _Buffered(buffer_size)
    return _UnBuffered()


def close_channel(ch):
    """channel.h:49 CloseChannel."""
    ch.close()


def go(fn, *args, **kwargs):
    """Spawn a goroutine-style daemon thread (the csp design's `go`
    construct); returns the Thread, already started."""
    t = threading.Thread(target=fn, args=args, kwargs=kwargs,
                         daemon=True)
    t.start()
    return t
