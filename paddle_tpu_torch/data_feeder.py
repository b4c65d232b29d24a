"""DataFeeder: minibatch (python lists / numpy) -> feed dict of arrays.

The port's copy of `paddle_tpu/data_feeder.py`, dense feeds only: each
column of per-example tuples is stacked into one numpy array in the
feed var's dtype. Sequence (LoD) inputs, which the reference pads to a
bucketed length beside a `<name>@SEQLEN` vector, raise
`LoDFeedNotPorted` until the port builds sequence programs (ROADMAP A8).

Dtypes: one conversion straight into the var's dtype. The port keeps
int64 as int64 (torch has no x64 switch; the JAX package builds int32
when jax's x64 is off), and a bfloat16 var is fed float32, cast on the
card.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DataFeeder", "LoDFeedNotPorted", "feed_dtype"]


class LoDFeedNotPorted(NotImplementedError):
    """A sequence (lod_level >= 1) feed var: not ported yet (A8)."""


def feed_dtype(var_dtype):
    """The numpy dtype a feed array is BUILT with for a var of
    `var_dtype` — the one feed-conversion dtype policy, shared with
    executor.host_cast_feed."""
    if var_dtype == "bfloat16":
        return np.float32
    return var_dtype


class DataFeeder:
    def __init__(self, feed_list, place=None):
        self.feed_vars = list(feed_list)
        self.place = place
        for var in self.feed_vars:
            if var.lod_level:
                raise LoDFeedNotPorted(
                    f"feed var {var.name!r} has lod_level {var.lod_level}: "
                    "sequence feeds are not ported yet (dense only)")

    def feed(self, minibatch):
        """minibatch: iterable of per-example tuples aligned with
        feed_list."""
        rows = list(minibatch)
        out = {}
        for i, var in enumerate(self.feed_vars):
            column = [r[i] for r in rows]
            arr = np.asarray(column, dtype=feed_dtype(var.dtype))
            out[var.name] = self._fix_rank(var, arr)
        return out

    @staticmethod
    def _fix_rank(var, arr):
        want = len(var.shape or ())
        # e.g. labels fed as [N] for declared shape [-1, 1]
        if want and arr.ndim == want - 1 and var.shape[-1] == 1:
            arr = arr[..., None]
        return arr
