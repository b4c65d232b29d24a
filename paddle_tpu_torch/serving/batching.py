"""Batch-shape math: bucket ladders, batch-dim padding, result splits.

The port's copy of `paddle_tpu/serving/batching.py`: pure host-side
array plumbing, no engine state, no threads.

  * a **bucket ladder** is the closed set of sizes an engine may
    dispatch (the one-shot engine's batch sizes; the LM engine's prefill
    batches and prompt lengths); rounding every dispatch up to a rung
    bounds the distinct shapes at len(ladder). Default ladder: powers of
    two up to the maximum (1, 2, 4, ..., max).
  * **padding** fills the gap between the real row count and the rung
    with zero rows along axis 0. Row-wise inference math (each output
    row depends only on its input row) makes the pad rows inert; they
    are sliced off before any caller sees them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bucket_ladder", "round_up_to_bucket", "pad_to_bucket",
           "split_rows"]


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


def pad_to_bucket(request_arrays, bucket):
    """Concatenate per-request positional feeds along axis 0 and
    zero-pad to `bucket` rows.

    `request_arrays`: one list of positional feed arrays per request
    (all requests agree on feed count and trailing dims). Returns
    `(padded, row_slices)` — `padded[i]` has bucket rows; `row_slices[j]`
    is the slice of request j's rows inside the batch.
    """
    if not request_arrays:
        raise ValueError("pad_to_bucket needs at least one request")
    row_slices = []
    start = 0
    for arrays in request_arrays:
        rows = arrays[0].shape[0]
        row_slices.append(slice(start, start + rows))
        start += rows
    if start > bucket:
        raise ValueError(f"{start} rows do not fit bucket {bucket}")
    pad = bucket - start
    padded = []
    for pos in range(len(request_arrays[0])):
        cat = (request_arrays[0][pos] if len(request_arrays) == 1
               else np.concatenate([arrays[pos]
                                    for arrays in request_arrays], axis=0))
        if pad:
            fill = np.zeros((pad,) + cat.shape[1:], dtype=cat.dtype)
            cat = np.concatenate([cat, fill], axis=0)
        padded.append(cat)
    return padded, row_slices


def split_rows(outputs, row_slices):
    """Per-request views of the batched outputs: request j gets
    `[out[row_slices[j]] for out in outputs]` (pad rows fall off)."""
    return [[out[s] for out in outputs] for s in row_slices]
