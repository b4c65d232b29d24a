"""Batch-shape math: bucket ladders.

The port's copy of the ladder half of `paddle_tpu/serving/batching.py`
(the LM engine pads prefill batches and prompt lengths up to ladder
rungs). A **bucket ladder** is the closed set of sizes the engine may
dispatch; rounding every dispatch up to a rung bounds the distinct
shapes at len(ladder). Default ladder: powers of two up to the maximum
(1, 2, 4, ..., max).
"""

from __future__ import annotations

__all__ = ["bucket_ladder", "round_up_to_bucket"]


def bucket_ladder(max_batch_size, buckets=None):
    """Validated ascending tuple of allowed dispatch sizes.

    `buckets=None` builds the power-of-two ladder 1, 2, 4, ...
    capped/completed by `max_batch_size`. An explicit `buckets` is
    deduplicated and sorted; its largest rung must equal
    `max_batch_size`.
    """
    max_batch_size = int(max_batch_size)
    if max_batch_size < 1:
        raise ValueError(f"max_batch_size must be >= 1, "
                         f"got {max_batch_size}")
    if buckets is None:
        ladder = []
        b = 1
        while b < max_batch_size:
            ladder.append(b)
            b *= 2
        ladder.append(max_batch_size)
        return tuple(ladder)
    ladder = sorted({int(b) for b in buckets})
    if not ladder or ladder[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    if ladder[-1] != max_batch_size:
        raise ValueError(
            f"largest bucket ({ladder[-1]}) must equal max_batch_size "
            f"({max_batch_size}) so a full batch has a rung")
    return tuple(ladder)


def round_up_to_bucket(n, ladder):
    """Smallest rung >= n. n must fit the ladder (n <= ladder[-1])."""
    for b in ladder:
        if b >= n:
            return b
    raise ValueError(f"batch of {n} rows exceeds the largest bucket "
                     f"({ladder[-1]})")
