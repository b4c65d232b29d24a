"""In-graph metric-accumulation ops (the port of
`paddle_tpu/ops/metric_ops.py`).

The evaluators keep their accumulators in persistable program vars
updated by ops every batch (evaluator.py), so a pass never ships raw
predictions to the host: `scatter_add_1d` is the histogram update behind
the AUC and precision-recall buckets, `auc_from_histograms` the
pass-level metric read from them by the eval program, `chunk_eval` a
batch's chunk counts for sequence labelling, `pnpair_eval` a ranking
batch's ordered-pair counts and `detection_map_buckets` a detection
batch's tp / fp score histograms.
"""

from __future__ import annotations

import numpy as np
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


@register_op("pnpair_eval", differentiable=False)
def _pnpair_eval(ctx, ins, attrs):
    """Positive-negative ranking pair counts on the device (gserver pnpair
    evaluator; host twin: evaluator.PnpairEvaluator). Score / Label /
    QueryId [N(,1)]; an optional Weight [N(,1)] drops the rows of weight
    0. Outputs Pos / Neg / Spe [1] f32: within each query, the pairs
    whose score order agrees with / inverts / ties the label order.

    The pairs stream in chunks of `chunk_rows` rows (512 by default), a
    [chunk, N] tile at a time, so the memory is O(N x chunk). The counts
    are sums of 0 / 1 in f32: exact in any order below 2^24."""
    f32 = torch.float32
    s = ins["Score"][0].reshape(-1).to(f32)
    y = ins["Label"][0].reshape(-1).to(f32)
    dev = s.device
    q = (ins["QueryId"][0].reshape(-1) if ins.get("QueryId")
         else torch.zeros(s.shape, dtype=torch.int32, device=dev))
    w = (ins["Weight"][0].reshape(-1).to(f32) if ins.get("Weight")
         else torch.ones(s.shape, dtype=f32, device=dev))
    N = s.shape[0]
    if dev.type == "meta":
        z = torch.zeros((1,), dtype=f32, device=dev)
        return {"Pos": [z], "Neg": [z], "Spe": [z]}
    chunk = max(1, min(int(attrs.get("chunk_rows", 512)), max(N, 1)))
    ju = torch.arange(N, device=dev)
    totals = torch.zeros(3, dtype=f32, device=dev)
    for start in range(0, N, chunk):
        i = ju[start:start + chunk]
        si, yi, qi, wi = s[i], y[i], q[i], w[i]
        upper = i[:, None] < ju[None, :]                 # i < j pairs
        same_q = qi[:, None] == q[None, :]
        live = (wi[:, None] > 0) & (w[None, :] > 0)
        dy = yi[:, None] - y[None, :]
        rel = upper & same_q & live & (dy != 0)
        agree = torch.sign(si[:, None] - s[None, :]) * torch.sign(dy)
        relf = rel.to(f32)
        totals = totals + torch.stack([(relf * (agree > 0)).sum(),
                                       (relf * (agree < 0)).sum(),
                                       (relf * (agree == 0)).sum()])
    return {"Pos": [totals[0:1]], "Neg": [totals[1:2]],
            "Spe": [totals[2:3]]}


def _gt_iou(box, boxes):
    """IoU of box [B, 4] with boxes [B, G, 4] -> [B, G] (the detection-mAP
    matcher's formula: no clamp of the union)."""
    ix = torch.clamp_min(torch.minimum(box[:, None, 2], boxes[..., 2])
                         - torch.maximum(box[:, None, 0], boxes[..., 0]), 0.0)
    iy = torch.clamp_min(torch.minimum(box[:, None, 3], boxes[..., 3])
                         - torch.maximum(box[:, None, 1], boxes[..., 1]), 0.0)
    inter = ix * iy

    def area(b):
        return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])

    ua = area(box)[:, None] + area(boxes) - inter
    return torch.where(ua > 0, inter / ua, torch.zeros_like(inter))


@register_op("detection_map_buckets", differentiable=False)
def _detection_map_buckets(ctx, ins, attrs):
    """A batch's detection-mAP statistics on the device (reference
    operators/detection_map_op.*; host twin: evaluator.DetectionMAP).

    The state is a [num_classes, num_buckets] score-histogram pair (tp /
    fp) and per-class positive counts, the static-shape trade of the AUC
    evaluator. Greedy matching as on the host: each image's detections in
    descending score order (a stable sort, so equal scores keep their
    slot order), each taking the best-IoU unmatched ground truth of its
    class at overlap >= threshold. Each of the K steps is one batched
    step over the images, with no read on the host; the histograms are
    summed by index_add_ of 0 / 1, exact in any order.

    ins: Detections [B, K, 6] (label, score, x1, y1, x2, y2; label -1 =
    padding), GtBoxes [B, G, 4], GtLabels [B, G(,1)], optional GtCount
    [B]. outs: TpHist / FpHist [C, Nb], PosCount [C]."""
    f32 = torch.float32
    det = ins["Detections"][0].to(f32)
    gtb = ins["GtBoxes"][0].to(f32)
    gtl = ins["GtLabels"][0]
    if gtl.dim() == 3:
        gtl = gtl[..., 0]
    gtl = gtl.to(torch.int32)
    dev = det.device
    B, K, _ = det.shape
    G = gtb.shape[1]
    C = int(attrs["num_classes"])
    Nb = int(attrs.get("num_buckets", 512))
    if dev.type == "meta":
        return {"TpHist": [torch.zeros((C, Nb), dtype=f32, device=dev)],
                "FpHist": [torch.zeros((C, Nb), dtype=f32, device=dev)],
                "PosCount": [torch.zeros((C,), dtype=f32, device=dev)]}
    thr = float(np.float32(attrs.get("overlap_threshold", 0.5)))
    bg = int(attrs.get("background_label", 0))
    garange = torch.arange(G, device=dev)
    if ins.get("GtCount"):
        gc = ins["GtCount"][0].reshape(-1).to(torch.int32)
        gt_valid = garange[None, :] < gc[:, None]
    else:
        gt_valid = torch.ones((B, G), dtype=torch.bool, device=dev)
    # an out-of-range gt label (-1 padding, or >= C) is left out like
    # background padding rather than folded into class 0 or C - 1
    gt_valid = gt_valid & (gtl != bg) & (gtl >= 0) & (gtl < C)
    pos_count = torch.zeros((C,), dtype=f32, device=dev).index_add_(
        0, gtl.reshape(-1).clamp(0, C - 1).long(),
        gt_valid.reshape(-1).to(f32))

    dlab = det[..., 0].to(torch.int32)
    dscore = det[..., 1]
    # a label >= C (malformed detector output) is left out like padding
    dvalid = (det[..., 0] >= 0) & (dlab != bg) & (dlab < C)
    neg_inf = torch.full((), -float("inf"), dtype=f32, device=dev)
    order = torch.argsort(-torch.where(dvalid, dscore, neg_inf), dim=1,
                          stable=True)
    lab_o = torch.gather(dlab, 1, order)
    sc_o = torch.gather(dscore, 1, order)
    valid_o = torch.gather(dvalid, 1, order)
    box_o = torch.gather(det[..., 2:6], 1, order[..., None].expand(B, K, 4))
    matched = torch.zeros((B, G), dtype=torch.bool, device=dev)
    tp_h = torch.zeros((C * Nb,), dtype=f32, device=dev)
    fp_h = torch.zeros((C * Nb,), dtype=f32, device=dev)
    minus_one = torch.full((), -1.0, dtype=f32, device=dev)
    for k in range(K):
        lab, sc, valid = lab_o[:, k], sc_o[:, k], valid_o[:, k]
        ov = _gt_iou(box_o[:, k], gtb)                           # [B, G]
        cand = gt_valid & ~matched & (gtl == lab[:, None])
        ov = torch.where(cand, ov, minus_one)
        best_g = torch.argmax(ov, dim=1)                 # the first max
        best = torch.amax(ov, dim=1)
        tp = valid & (best >= thr)
        matched = matched | (tp[:, None] & (garange[None, :]
                                            == best_g[:, None]))
        bucket = torch.clamp((sc * Nb).to(torch.int32), 0, Nb - 1)
        flat_idx = (lab.clamp(0, C - 1) * Nb + bucket).long()
        tp_h.index_add_(0, flat_idx, (valid & tp).to(f32))
        fp_h.index_add_(0, flat_idx, (valid & ~tp).to(f32))
    return {"TpHist": [tp_h.reshape(C, Nb)], "FpHist": [fp_h.reshape(C, Nb)],
            "PosCount": [pos_count]}
