"""CTC loss and greedy alignment (the port of `warpctc` and `ctc_align`
from `paddle_tpu/ops/ctc_ops.py`; its `nce` and `hsigmoid` are not
ported yet).

  * `warpctc` (operators/warpctc_op.cc, which dynloads warp-ctc): the
    reference's log-space forward recursion over the blank-interleaved
    label sequence, in f32 (f64 for f64 logits), vectorised over the
    batch and the label positions, as a Python loop over time. A row's
    alpha freezes once t reaches its `LogitsLen`. The gradient is
    autograd through the loop: the classic CTC backward is the
    derivative of this forward, so there is no beta recursion.
    `torch.nn.functional.ctc_loss` takes its own conventions (its
    blank, reduction and zero-infinity rules) and is not used.
  * `ctc_align` (operators/ctc_align_op.h): greedy CTC decoding, merge
    repeats and drop blanks, kept as a padded [B, T] tensor with its
    lengths (`OutLen`). The reference compacts each row with a scatter
    whose dropped writes go to index T with `mode="drop"`; a torch
    index op raises on an out-of-range index, so the port scatters into
    a [B, T + 1] buffer whose last column takes the dropped writes, and
    keeps the first T columns: every index is in range.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op

_NEG = -1e30


@register_op("warpctc")
def _warpctc(ctx, ins, attrs):
    """CTC loss. Logits [B, T, C] (+ LogitsLen [B]), Label [B, U] int
    (+ LabelLen [B]); blank in [0, C). Loss [B, 1]."""
    logits = ins["Logits"][0]
    label = ins["Label"][0].to(torch.int64)
    logits_len = ins["LogitsLen"][0].to(torch.int64)
    label_len = ins["LabelLen"][0].to(torch.int64)
    blank = int(attrs.get("blank", 0))

    B, T, _C = logits.shape
    if logits.device.type == "meta":       # build-time shape inference
        return {"Loss": [logits.new_empty((B, 1))]}
    U = label.shape[1]
    S = 2 * U + 1
    cdt = torch.promote_types(logits.dtype, torch.float32)
    lp = torch.log_softmax(logits.to(cdt), dim=-1)             # [B, T, C]

    # a label slot past the row's LabelLen only feeds later positions of
    # the recursion, never the two it ends on: it reads as a blank, so
    # that padding of any value indexes inside [0, C)
    label = torch.where(torch.arange(U, device=lp.device)[None, :]
                        < label_len[:, None], label, blank)
    # blank-interleaved extended labels [blank, l1, blank, ..., lU, blank]
    ext = torch.full((B, S), blank, dtype=torch.int64, device=lp.device)
    ext[:, 1::2] = label
    # the skip s-2 -> s is allowed when ext[s] is no blank and differs
    # from ext[s-2]
    ext_m2 = F.pad(ext, (2, 0), value=-1)[:, :S]
    can_skip = (ext != blank) & (ext != ext_m2)                 # [B, S]
    # each step's emission log-probs at the extended labels
    lp_ext = torch.gather(lp, 2, ext[:, None, :].expand(B, T, S))

    has_label = (label_len > 0)[:, None]
    first = lp_ext[:, 0, :2]
    if U > 0:
        first = torch.cat([first[:, :1],
                           torch.where(has_label, first[:, 1:], _NEG)], 1)
    alpha = F.pad(first, (0, S - first.shape[1]), value=_NEG)
    live = (torch.arange(T, device=lp.device)[:, None]
            < logits_len[None, :])[:, :, None]                  # [T, B, 1]
    for t in range(1, T):
        a1 = F.pad(alpha, (1, 0), value=_NEG)[:, :S]
        a2 = torch.where(can_skip, F.pad(alpha, (2, 0), value=_NEG)[:, :S],
                         _NEG)
        new = torch.logaddexp(torch.logaddexp(alpha, a1), a2) + lp_ext[:, t]
        # frozen once t reaches the row's length
        alpha = torch.where(live[t], new, alpha)

    idx_last = 2 * label_len                                    # [B]
    a_end = torch.gather(alpha, 1, idx_last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, (idx_last - 1).clamp_min(0)[:, None])
    a_prev = torch.where(has_label, a_prev, _NEG)[:, 0]
    loss = -torch.logaddexp(a_end, a_prev)                      # [B]
    if attrs.get("norm_by_times", False):
        loss = loss / logits_len.clamp_min(1).to(loss.dtype)
    return {"Loss": [loss[:, None].to(logits.dtype)]}


@register_op("ctc_align", differentiable=False)
def _ctc_align(ctx, ins, attrs):
    """Greedy CTC decode of id sequences: merge repeats, drop blanks.
    Input [B, T] int ids + InLen [B]; Output padded [B, T] (zeros past
    each row's length) + OutLen [B] int64 (the JAX package's int32
    count summed under 64-bit types)."""
    ids_in = ins["Input"][0]
    ids = ids_in.to(torch.int64)
    in_len = ins["InLen"][0].to(torch.int64)
    blank = int(attrs.get("blank", 0))

    B, T = ids.shape
    t_idx = torch.arange(T, device=ids.device)
    keep = (ids != blank) & (t_idx[None, :] < in_len[:, None])
    if attrs.get("merge_repeated", True):
        keep = keep & (ids != F.pad(ids, (1, 0), value=-1)[:, :T])
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    tgt = torch.where(keep, pos, T)
    out = torch.zeros((B, T + 1), dtype=torch.int64, device=ids.device)
    out = out.scatter(1, tgt, ids)[:, :T]
    out_len = keep.sum(dim=1)
    return {"Output": [out.to(ids_in.dtype)], "OutLen": [out_len]}
