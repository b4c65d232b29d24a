"""Retry policy core: bounded attempts + exponential backoff + jitter.

The port's copy of `paddle_tpu/resilience/retry.py`. Checkpoint IO
(io.save_checkpoint) and the supervised train-step loop
(trainer.Trainer) call `call_with_retry` / `retrying` with a
`RetryPolicy` instead of hand-rolling attempt loops.

The classification follows the card's failure modes:

  * `torch.OutOfMemoryError` (the caching allocator could not serve a
    request) is the card's form of XLA's RESOURCE_EXHAUSTED, which the
    reference retries: transient. The allocator frees its cache and the
    retried step may fit.
  * a sticky CUDA error ("CUDA error: an illegal memory access was
    encountered", a device-side assert, ...) leaves the CUDA context
    dead: every later call on it fails the same way. Never transient,
    whatever words the message also holds.

Every performed retry increments `resilience.retries` in the monitor
registry (plus an optional per-site counter), so a run's recovery
activity is observable and, under the fault-injection harness
(resilience/faults.py), exactly checkable against the injected
schedule.
"""

from __future__ import annotations

import functools
import random
import time

import torch

from .. import monitor

__all__ = ["RetryPolicy", "retrying", "call_with_retry", "is_transient"]


# Status markers that mean "the device/runtime hiccuped, the computation
# itself is fine" (the reference's, kept so one fault spec classifies
# alike in both packages). The fault injector tags its synthetic
# transients with "injected transient".
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
    "CANCELLED", "preempted", "injected transient",
)

# torch.OutOfMemoryError (older torch: torch.cuda.OutOfMemoryError)
_OOM = (getattr(torch, "OutOfMemoryError", None)
        or torch.cuda.OutOfMemoryError)

# A CUDA runtime error surfaces as RuntimeError("CUDA error: <reason>");
# after one the context is unusable, so no retry can succeed.
_STICKY_CUDA_PREFIX = "CUDA error"


def is_transient(exc) -> bool:
    """Default retryable-exception predicate.

    Transient: OS/socket errors (incl. ConnectionError/TimeoutError),
    `torch.OutOfMemoryError`, and RuntimeErrors carrying a transient
    status marker. Never transient: FloatingPointError (a tripped NaN
    guard is an *anomaly*, the AnomalyPolicy's job: re-running the same
    batch reproduces the same NaN), a sticky CUDA error, and everything
    else (ValueError etc. are program bugs; retrying them only hides the
    traceback).
    """
    if isinstance(exc, FloatingPointError):
        return False
    if isinstance(exc, _OOM):
        return True
    if isinstance(exc, (OSError, TimeoutError)):
        return True
    if isinstance(exc, RuntimeError):
        msg = str(exc)
        if msg.lstrip().startswith(_STICKY_CUDA_PREFIX):
            return False
        return any(m in msg for m in _TRANSIENT_MARKERS)
    return False


class RetryPolicy:
    """max attempts + exponential backoff with seeded jitter + predicate.

    `delay_s(attempt)` (attempt = 1-based index of the attempt that just
    failed) is `base * 2**(attempt-1)` capped at `backoff_max_s`, then
    stretched by up to `jitter_frac` from a policy-seeded RNG — the
    sequence of delays is deterministic per (seed, call order), so
    recovery tests are reproducible.
    """

    def __init__(self, max_attempts=3, backoff_base_s=0.05,
                 backoff_max_s=5.0, jitter_frac=0.1, retryable=None,
                 seed=0):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter_frac = float(jitter_frac)
        self.retryable = retryable or is_transient
        self.seed = seed
        self._rng = random.Random(seed)

    def is_retryable(self, exc) -> bool:
        return bool(self.retryable(exc))

    def delay_s(self, attempt: int) -> float:
        d = min(self.backoff_max_s,
                self.backoff_base_s * (2 ** (max(1, attempt) - 1)))
        if self.jitter_frac:
            d *= 1.0 + self.jitter_frac * self._rng.random()
        return d

    def __repr__(self):
        return (f"RetryPolicy(max_attempts={self.max_attempts}, "
                f"backoff_base_s={self.backoff_base_s}, "
                f"backoff_max_s={self.backoff_max_s}, "
                f"jitter_frac={self.jitter_frac}, seed={self.seed})")


def call_with_retry(fn, *args, policy=None, counter=None, on_retry=None,
                    sleep=time.sleep, may_retry=None, **kwargs):
    """Run `fn(*args, **kwargs)`, retrying per `policy`.

    Only Exceptions the policy classifies as retryable are retried (and
    only while attempts remain, and only when `may_retry()` — if given —
    still says True: the Trainer's "no state was written in place");
    everything else — including resilience.SimulatedCrash, a
    BaseException modelling a process kill — propagates immediately.
    Each performed retry increments `resilience.retries` (and `counter`
    when given) and calls `on_retry(exc, failed_attempt)`.
    """
    pol = policy or RetryPolicy()
    for attempt in range(1, pol.max_attempts + 1):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            if (attempt >= pol.max_attempts or not pol.is_retryable(e)
                    or (may_retry is not None and not may_retry())):
                raise
            monitor.counter_inc("resilience.retries")
            if counter:
                monitor.counter_inc(counter)
            if on_retry is not None:
                on_retry(e, attempt)
            sleep(pol.delay_s(attempt))
    raise AssertionError("unreachable")


def retrying(policy=None, counter=None, sleep=time.sleep):
    """Decorator form of `call_with_retry`:

        @resilience.retrying(RetryPolicy(max_attempts=5))
        def fetch(): ...
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return call_with_retry(fn, *args, policy=policy,
                                   counter=counter, sleep=sleep, **kwargs)
        return wrapper
    return deco
