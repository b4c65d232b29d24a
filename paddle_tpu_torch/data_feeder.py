"""DataFeeder: minibatch (python lists / numpy) -> feed dict of arrays.

The port's copy of `paddle_tpu/data_feeder.py`. A dense column of
per-example tuples is stacked into one numpy array in the feed var's
dtype. A sequence (LoD) column leaves as a padded dense array plus a
`<name>@SEQLEN` int32 vector (lod_level 2: also `<name>@SEQLEN@SUB`, the
[batch, S] inner lengths), padded to a bucketed length so that a run
sees O(log T) shapes, not one a batch.

Dtypes: one conversion straight into the var's dtype. The port keeps
int64 as int64 (torch has no x64 switch; the JAX package builds int32
when jax's x64 is off), and a bfloat16 var is fed float32, cast on the
card. Lengths are int32 in both packages.
"""

from __future__ import annotations

import numpy as np

from .framework import seq_len_name, sub_seq_len_name

__all__ = ["DataFeeder", "bucket_length", "feed_dtype", "LENGTH_BUCKETS"]

LENGTH_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)


def bucket_length(n, buckets=LENGTH_BUCKETS):
    """The smallest bucket >= n; past the last one, the next power of 2."""
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(max(n, 1))))


def feed_dtype(var_dtype):
    """The numpy dtype a feed array is BUILT with for a var of
    `var_dtype` — the one feed-conversion dtype policy, shared with
    executor.host_cast_feed."""
    if var_dtype == "bfloat16":
        return np.float32
    return var_dtype


class DataFeeder:
    def __init__(self, feed_list, place=None,
                 length_buckets=LENGTH_BUCKETS):
        self.feed_vars = list(feed_list)
        self.place = place
        self.buckets = tuple(length_buckets)

    def feed(self, minibatch):
        """minibatch: iterable of per-example tuples aligned with
        feed_list."""
        rows = list(minibatch)
        out = {}
        for i, var in enumerate(self.feed_vars):
            column = [r[i] for r in rows]
            if var.lod_level == 0:
                arr = np.asarray(column, dtype=feed_dtype(var.dtype))
                out[var.name] = self._fix_rank(var, arr)
            elif var.lod_level == 1:
                padded, lens = self._pad_level1(var, column)
                out[var.name] = padded
                out[seq_len_name(var.name)] = lens
            elif var.lod_level == 2:
                padded, outer, inner = self._pad_level2(var, column)
                out[var.name] = padded
                out[seq_len_name(var.name)] = outer
                out[sub_seq_len_name(var.name)] = inner
            else:
                raise NotImplementedError(
                    f"lod_level={var.lod_level} feeding is unsupported "
                    "(nested sequences stop at 2 levels, like the "
                    "reference's sub-sequence LoD)")
        return out

    @staticmethod
    def _fix_rank(var, arr):
        want = len(var.shape or ())
        # e.g. labels fed as [N] for declared shape [-1, 1]
        if want and arr.ndim == want - 1 and var.shape[-1] == 1:
            arr = arr[..., None]
        return arr

    def _pad_level1(self, var, column):
        """(values [B, T, *feat], lens [B]); T is the bucketed longest
        row. The feature dims come from the data: a declared trailing
        [1] of an id sequence stays 2-D, as lookup_table takes both."""
        seqs = [np.asarray(s) for s in column]
        lens = np.asarray([len(s) for s in seqs], dtype=np.int32)
        max_t = bucket_length(int(lens.max()) if len(lens) else 1,
                              self.buckets)
        inner = seqs[0].shape[1:] if seqs[0].ndim > 1 else ()
        padded = np.zeros((len(seqs), max_t) + inner,
                          dtype=feed_dtype(var.dtype))
        for j, s in enumerate(seqs):
            padded[j, :len(s)] = s.reshape((len(s),) + inner)
        return padded, lens

    def _pad_level2(self, var, column):
        """Nested sequences: each example is a list of sub-sequences.
        Returns (values [B, S, T, *feat], outer_lens [B], inner_lens
        [B, S]). The sub-sequence count S has its own finer ladder
        (2, 4, 8, then the time buckets)."""
        examples = [[np.asarray(sub) for sub in ex] for ex in column]
        outer = np.asarray([len(ex) for ex in examples], np.int32)
        max_s = bucket_length(int(outer.max()) if len(outer) else 1,
                              (2, 4, 8) + self.buckets)
        all_lens = [len(sub) for ex in examples for sub in ex] or [1]
        max_t = bucket_length(max(all_lens), self.buckets)
        first = next((sub for ex in examples for sub in ex), None)
        inner_feat = first.shape[1:] if (first is not None
                                         and first.ndim > 1) else ()
        padded = np.zeros((len(examples), max_s, max_t) + inner_feat,
                          dtype=feed_dtype(var.dtype))
        inner = np.zeros((len(examples), max_s), np.int32)
        for i, ex in enumerate(examples):
            for j, sub in enumerate(ex):
                inner[i, j] = len(sub)
                padded[i, j, :len(sub)] = sub.reshape((len(sub),)
                                                      + inner_feat)
        return padded, outer, inner

