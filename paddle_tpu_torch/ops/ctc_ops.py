"""CTC loss, greedy alignment and the two sampled-softmax losses (the
port of `paddle_tpu/ops/ctc_ops.py`: `warpctc`, `ctc_align`, `nce` and
`hsigmoid`).

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
  * `nce` (nce_op.h): the reference's cost over the true classes and
    `num_neg_samples` negatives drawn uniformly from [0, V), b = k / V.
    With `CustomSamples` the negatives are given and the cost is the
    reference's bit for bit in formula; without them they come from the
    executor's generator, so they differ from the JAX package's draws
    (ROADMAP C32).
  * `hsigmoid` (HierarchicalSigmoidLayer.cpp, MatrixBitCode.cpp): the
    bit code of label + K walked over floor(log2(2K - 1)) levels, each a
    gather of the node's row of W and a row product, softplus(pre) -
    bit * pre where the level is on the path.
"""

from __future__ import annotations

import numpy as np
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


@register_op("nce", stateful=True)
def _nce(ctx, ins, attrs):
    """Input [B, D], Label [B, num_true], Weight [V, D] (+ Bias [V],
    SampleWeight [B], CustomSamples [B, k]) -> Cost [B, 1]:
    sum over the true classes of -log(o / (o + b)) plus over the
    negatives -log(b / (o + b)), o the sigmoid of the class logit."""
    x = ins["Input"][0]
    label = ins["Label"][0].to(torch.int64)
    w = ins["Weight"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    V = int(attrs["num_total_classes"])
    k = int(attrs["num_neg_samples"])
    B = x.shape[0]
    if ins.get("CustomSamples"):
        neg = ins["CustomSamples"][0].to(torch.int64)
    else:
        neg = torch.randint(0, V, (B, k), generator=ctx.generator,
                            dtype=torch.int64, device=x.device)
    samples = torch.cat([label, neg], dim=1)              # [B, n]
    logits = torch.einsum("bd,bnd->bn", x.float(), w[samples].float())
    if bias is not None:
        logits = logits + bias[samples].float()
    o = torch.sigmoid(logits)
    b = float(k) / float(V)
    nt = label.shape[1]
    cost_true = -torch.log(o[:, :nt] / (o[:, :nt] + b))
    cost_neg = -torch.log(b / (o[:, nt:] + b))
    cost = cost_true.sum(dim=1) + cost_neg.sum(dim=1)
    if ins.get("SampleWeight"):
        cost = cost * ins["SampleWeight"][0].to(cost.dtype)
    return {"Cost": [cost[:, None].to(x.dtype)]}


@register_op("hsigmoid")
def _hsigmoid(ctx, ins, attrs):
    """X [B, D], Label [B] or [B, 1], W [K - 1, D] (+ Bias [K - 1]) ->
    Cost [B, 1], over the complete binary tree's bit code of label + K:
    at level j the node (code >> (j + 1)) - 1 and the bit (code >> j) &
    1, on the path while j < floor(log2(code))."""
    x = ins["X"][0]
    label = ins["Label"][0].to(torch.int32)
    w = ins["W"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    K = int(attrs["num_classes"])
    if label.dim() == 2:
        label = label[:, 0]
    code = label + K
    length = torch.floor(torch.log2(code.float()) + 1e-6).to(torch.int32)
    max_len = int(np.floor(np.log2(2 * K - 1)))
    cdt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(cdt)
    cost = torch.zeros((x.shape[0],), dtype=cdt, device=x.device)
    for j in range(max_len):
        idx = torch.clamp((code >> (j + 1)) - 1, 0, K - 2).long()
        bit = ((code >> j) & 1).float()
        pre = torch.sum(xf * w[idx].to(cdt), dim=-1)
        if bias is not None:
            pre = pre + bias[idx].to(cdt)
        c = torch.logaddexp(pre, torch.zeros_like(pre)) - bit * pre
        cost = cost + torch.where(j < length, c, torch.zeros_like(c))
    return {"Cost": [cost[:, None].to(x.dtype)]}
