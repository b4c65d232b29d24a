"""SelectedRows: fixed-capacity sparse row gradients.

The port's copy of `paddle_tpu/selected_rows.py`. An is_sparse
embedding's gradient is a SelectedRows {rows, values, height}: the rows
the batch looked up (duplicates allowed) and one gradient row for each,
so only touched rows travel to the optimizer. The capacity is the
number of lookups in the batch, fixed by the batch's shape.

What differs from the JAX package. The reference merges duplicate rows
with `jnp.unique(size=C, fill_value=height)` and lets the optimizers
scatter at the padding sentinel `height`, which XLA drops; torch index
ops raise on such an index on the CPU and trip a device-side assert on
CUDA. Here no sentinel ever reaches an index op:

  * the rows are sorted (a stable sort, so equal rows keep their batch
    order), each sorted position gets the index of its row's segment,
    and `torch.segment_reduce` sums each segment in that order: no
    atomics, so the same bits every run, and no value read back to the
    host, so no device -> host sync (a `torch.unique` would need one);
  * the optimizers take `row_sums`: every sorted position with its
    row's whole sum. A row looked up k times is written k times with
    the same bits, and every index is a real row;
  * `merge_rows` keeps the reference's layout (sorted unique rows
    padded with `height`, their sums, zeros in the padding slots) for
    the parity tests and the health norms; its `height` padding is data
    that no index op reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SelectedRows(NamedTuple):
    rows: torch.Tensor     # [C] int32 row indices (may contain duplicates)
    values: torch.Tensor   # [C, width] gradient rows
    height: int            # first dim of the dense tensor

    def to_dense(self):
        rows, sums = row_sums(self)
        dense = torch.zeros((self.height,) + tuple(self.values.shape[1:]),
                            dtype=self.values.dtype,
                            device=self.values.device)
        return dense.index_copy_(0, rows, sums.to(dense.dtype))

    def to(self, device):
        return SelectedRows(self.rows.to(device), self.values.to(device),
                            self.height)


def is_selected_rows(x) -> bool:
    return isinstance(x, SelectedRows)


# op types whose lowerings consume SelectedRows natively; every other
# op gets the dense form (correct, just without the sparse economics)
SPARSE_AWARE_OPS = {"sgd", "momentum", "adam", "adagrad", "sum"}


def densify_ins(op_type, ins):
    """Dense fallback: convert SelectedRows inputs for ops that are not
    sparse-aware (clip, regularizers, the other optimizers...), so
    is_sparse=True never changes semantics — only data movement."""
    if op_type in SPARSE_AWARE_OPS:
        return ins
    if not any(is_selected_rows(v) for vals in ins.values() for v in vals):
        return ins
    return {slot: [v.to_dense() if is_selected_rows(v) else v
                   for v in vals]
            for slot, vals in ins.items()}


def _segments(sr):
    """(sorted rows as int64, the sort's permutation, each sorted
    position's segment index, each segment's length). Segment s is the
    s-th distinct row; the lengths of the C - distinct trailing
    segments are 0."""
    rows, perm = torch.sort(sr.rows.reshape(-1), stable=True)
    rows = rows.long()
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    seg = torch.cumsum(first, 0) - 1
    lengths = torch.zeros_like(seg).scatter_add_(0, seg,
                                                 torch.ones_like(seg))
    return rows, perm, seg, lengths


def _segment_sums(sr, perm, lengths):
    """[C, width] f32: segment s's values summed in batch order; zero
    rows for the empty trailing segments. `unsafe` skips the lengths
    checks, which read the lengths back to the host."""
    vals = sr.values.reshape(perm.shape[0], -1).float().index_select(0, perm)
    return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def row_sums(sr):
    """(rows [C] int64 sorted, sums [C, width] f32): each lookup's row,
    sorted, beside the sum of every gradient row of that row. An update
    that computes a row's new value from these writes each duplicate
    with the same bits."""
    rows, perm, seg, lengths = _segments(sr)
    return rows, _segment_sums(sr, perm, lengths).index_select(0, seg)


def merge_rows(sr):
    """Combine duplicate rows: (uniq_rows [C] int64, summed [C, width]
    f32), the reference's layout — the distinct rows ascending, then
    padding slots holding `height` with zero sums."""
    rows, perm, seg, lengths = _segments(sr)
    uniq = torch.full_like(rows, sr.height).scatter_(0, seg, rows)
    return uniq, _segment_sums(sr, perm, lengths)
