"""In-graph metric-accumulation ops (the port of the part of
`paddle_tpu/ops/metric_ops.py` the AUC, accuracy and chunk evaluators
run).

The evaluators keep their accumulators in persistable program vars
updated by ops every batch (evaluator.py), so a pass never ships raw
predictions to the host: `scatter_add_1d` is the histogram update behind
the AUC buckets, `auc_from_histograms` the pass-level metric read from
them by the eval program, `chunk_eval` a batch's chunk counts for
sequence labelling.
"""

from __future__ import annotations

import torch

from .registry import register_op


@register_op("scatter_add_1d", differentiable=False)
def _scatter_add_1d(ctx, ins, attrs):
    """Out = X with Weight[b] added at Index[b] (a bincount update).
    An index outside [0, len(X)) adds nothing: its weight is zeroed and
    the index clamped into range, so no out-of-range index reaches the
    add. Weights of 0 and 1 (the AUC's) add exactly, in any order."""
    x = ins["X"][0]
    idx = ins["Index"][0].reshape(-1).to(torch.int64)
    if ins.get("Weight"):
        w = ins["Weight"][0].reshape(-1).to(x.dtype)
    else:
        w = torch.ones(idx.shape, dtype=x.dtype, device=x.device)
    n = x.shape[0]
    valid = (idx >= 0) & (idx < n)
    w = torch.where(valid, w, torch.zeros((), dtype=w.dtype,
                                          device=w.device))
    return {"Out": [x.index_add(0, idx.clamp(0, n - 1), w)]}


@register_op("auc_from_histograms", differentiable=False)
def _auc_from_histograms(ctx, ins, attrs):
    """ROC AUC from bucketed score histograms (the rankauc evaluator's
    finishing step; host twin: evaluator.Auc.eval). Thresholds swept
    high to low, trapezoid rule."""
    pos = ins["Pos"][0].float()
    neg = ins["Neg"][0].float()
    tp = torch.cumsum(pos.flip(0), 0)
    fp = torch.cumsum(neg.flip(0), 0)
    P = tp[-1].clamp_min(1.0)
    N = fp[-1].clamp_min(1.0)
    zero = torch.zeros((1,), dtype=tp.dtype, device=tp.device)
    tpr = torch.cat([zero, tp / P])
    fpr = torch.cat([zero, fp / N])
    return {"Auc": [torch.trapezoid(tpr, fpr).reshape(1)]}


def _chunk_segments(tags, valid, num_types):
    """Per-position chunk cover of IOB tags (2k = B-type-k, 2k+1 =
    I-type-k, >= 2 * num_types = O), on [B, T].

    Returns (is_start, ends_here, start_idx, ctype): is_start marks a
    chunk's first token, ends_here its last, and start_idx / ctype give
    the chunk of a covered position, so two tag sequences share a chunk
    iff they share (end position, start position, type).

    The reference scans time with a carry (start, type, active); the
    same quantities in closed form, with no loop: position t lies in
    the chunk begun at s, the last B-tag at or before t, iff every
    position in (s, t] is an I-tag of s's type, i.e. iff the last
    position at or before t that is neither a B-tag nor such an I-tag
    comes before s. Integer ops only, so the counts are exact."""
    B, T = tags.shape
    t32 = tags.to(torch.int64)
    is_o = (t32 >= 2 * num_types) | ~valid
    is_b = ~is_o & (t32 % 2 == 0)
    is_i = ~is_o & (t32 % 2 == 1)
    typ = t32 // 2
    pos = torch.arange(T, device=tags.device).expand(B, T)
    start = torch.cummax(torch.where(is_b, pos, -1), dim=1).values
    ctype = torch.where(start >= 0,
                        torch.gather(typ, 1, start.clamp_min(0)), -1)
    breaks = ~is_b & ~(is_i & (typ == ctype))
    last_break = torch.cummax(torch.where(breaks, pos, -1), dim=1).values
    covered = (start >= 0) & (last_break < start)
    # a chunk ends at t when t is covered and t + 1 does not continue it
    nxt_cont = torch.cat([covered[:, 1:] & ~is_b[:, 1:],
                          torch.zeros_like(covered[:, :1])], dim=1)
    return is_b, covered & ~nxt_cont, start.clamp_min(0), ctype


@register_op("chunk_eval", differentiable=False)
def _chunk_eval(ctx, ins, attrs):
    """Chunk detection counts for sequence labelling, on the device
    (operators/chunk_eval_op.cc; host twin: evaluator.ChunkEvaluator).
    Inference / Label [B, T] or [B, T, 1] int in the IOB encoding (the
    reference's op and evaluators decode IOB only); an optional SeqLen
    [B] masks padding. attrs: num_chunk_types.

    Outputs (all [1] f32): NumInferChunks, NumLabelChunks,
    NumCorrectChunks, and the batch's Precision / Recall / F1Score."""
    inf, lab = ins["Inference"][0], ins["Label"][0]
    if inf.dim() == 3:
        inf = inf[..., 0]
    if lab.dim() == 3:
        lab = lab[..., 0]
    B, T = inf.shape
    n_types = int(attrs["num_chunk_types"])
    if ins.get("SeqLen"):
        sl = ins["SeqLen"][0].reshape(-1).to(torch.int64)
        valid = torch.arange(T, device=inf.device)[None, :] < sl[:, None]
    else:
        valid = torch.ones((B, T), dtype=torch.bool, device=inf.device)

    b_i, end_i, st_i, ty_i = _chunk_segments(inf, valid, n_types)
    b_l, end_l, st_l, ty_l = _chunk_segments(lab, valid, n_types)
    match = end_i & end_l & (st_i == st_l) & (ty_i == ty_l)
    n_inf = b_i.sum(dtype=torch.float32)
    n_lab = b_l.sum(dtype=torch.float32)
    n_cor = match.sum(dtype=torch.float32)
    p = n_cor / n_inf.clamp_min(1.0)
    r = n_cor / n_lab.clamp_min(1.0)
    f1 = 2 * p * r / (p + r).clamp_min(1e-12)
    return {"NumInferChunks": [n_inf.reshape(1)],
            "NumLabelChunks": [n_lab.reshape(1)],
            "NumCorrectChunks": [n_cor.reshape(1)],
            "Precision": [p.reshape(1)], "Recall": [r.reshape(1)],
            "F1Score": [f1.reshape(1)]}
