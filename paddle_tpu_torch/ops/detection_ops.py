"""Detection ops: prior_box, iou_similarity, box_coder, bipartite_match,
target_assign, multiclass_nms, mine_hard_examples (the port of
`paddle_tpu/ops/detection_ops.py`).

Every output keeps the reference's padded static-shape contract: NMS
keeps a different box count per image, so its output is padded to
`keep_top_k` rows with a count, and hard-negative mining returns a
[B, P] mask instead of a variable-length index list. The greedy loops
(bipartite matching, NMS, the mAP matcher in metric_ops.py) are Python
loops of a fixed trip count whose every step is one batched tensor step
over the images (and classes): nothing is read back on the host inside
a loop, so a step's launches do not wait on the card.

Ties decide the outputs, so every choice takes the reference's rule: an
argmax takes the first maximum (`torch.argmax` and the index of
`torch.max` over a dim, as `jnp.argmax`), a ranking takes the lower
index first among equal scores (a stable sort, as `jnp.argsort` and
`jax.lax.top_k`).

Box convention throughout: [xmin, ymin, xmax, ymax], normalised or not;
the ops are scale-agnostic except prior_box, which emits normalised
boxes.
"""

from __future__ import annotations

import math

import torch

from .registry import register_op
from .sequence_ops import topk_lower_index_first


def _expand_aspect_ratios(aspect_ratios, flip):
    """prior_box_op.h:23 ExpandAspectRatios: 1.0 first, duplicates
    dropped, reciprocals added with flip."""
    out = [1.0]
    for ar in aspect_ratios:
        if any(abs(ar - o) < 1e-6 for o in out):
            continue
        out.append(float(ar))
        if flip:
            out.append(1.0 / float(ar))
    return out


def _meta(*tensors):
    return any(t.device.type == "meta" for t in tensors)


def _f32_consts(values, device):
    """An f32 vector of Python floats made by fills on the device: no
    copy from host memory, which would make the card wait (a sync) at
    every step of a program that holds prior_box."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                   device=device) for v in values])


@register_op("prior_box", differentiable=False)
def _prior_box(ctx, ins, attrs):
    """SSD prior boxes of one feature map (prior_box_op.h:75-170), in f32
    from Python-float steps: Input [N, C, H, W] + Image [N, 3, IH, IW]
    -> Boxes / Variances [H, W, P, 4]."""
    fmap = ins["Input"][0]
    image = ins["Image"][0]
    dev = fmap.device
    H, W = int(fmap.shape[2]), int(fmap.shape[3])
    IH, IW = int(image.shape[2]), int(image.shape[3])

    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    if max_sizes and len(max_sizes) != len(min_sizes):
        raise ValueError(
            f"prior_box: max_sizes ({len(max_sizes)}) must be empty or "
            f"match min_sizes ({len(min_sizes)}) one-to-one "
            "(prior_box_op.h pairs max_sizes[s] with min_sizes[s])")
    ars = _expand_aspect_ratios(attrs.get("aspect_ratios", []),
                                attrs.get("flip", False))
    variances = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    clip = attrs.get("clip", False)
    step_w = attrs.get("step_w", 0.0) or IW / W
    step_h = attrs.get("step_h", 0.0) or IH / H
    offset = attrs.get("offset", 0.5)

    # each location's prior (width, height), in the reference's order
    whs = []
    for s, mn in enumerate(min_sizes):
        whs.append((mn, mn))
        if max_sizes:
            r = math.sqrt(mn * max_sizes[s])
            whs.append((r, r))
        for ar in ars:
            if abs(ar - 1.0) < 1e-6:
                continue
            whs.append((mn * math.sqrt(ar), mn / math.sqrt(ar)))
    P = len(whs)

    f32 = torch.float32
    cx = (torch.arange(W, dtype=f32, device=dev) + offset) * step_w   # [W]
    cy = (torch.arange(H, dtype=f32, device=dev) + offset) * step_h   # [H]
    bw = _f32_consts([w for w, _ in whs], dev) * 0.5
    bh = _f32_consts([h for _, h in whs], dev) * 0.5
    cxg = cx[None, :, None]        # [1, W, 1]
    cyg = cy[:, None, None]        # [H, 1, 1]
    boxes = torch.stack([
        ((cxg - bw) / IW).expand(H, W, P),
        ((cyg - bh) / IH).expand(H, W, P),
        ((cxg + bw) / IW).expand(H, W, P),
        ((cyg + bh) / IH).expand(H, W, P),
    ], dim=-1)                     # [H, W, P, 4]
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = _f32_consts(variances, dev).expand(H, W, P, 4).contiguous()
    return {"Boxes": [boxes], "Variances": [var]}


def _iou(a, b):
    """Pairwise IoU: a [..., N, 4], b [..., M, 4] -> [..., N, M]. Each
    min / max splits its gradient at a tie, as jnp.minimum / maximum."""
    ax0, ay0, ax1, ay1 = (a[..., :, None, i] for i in range(4))
    bx0, by0, bx1, by1 = (b[..., None, :, i] for i in range(4))
    zero = a.new_zeros(())
    iw = torch.maximum(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0),
                       zero)
    ih = torch.maximum(torch.minimum(ay1, by1) - torch.maximum(ay0, by0),
                       zero)
    inter = iw * ih
    area_a = torch.maximum(ax1 - ax0, zero) * torch.maximum(ay1 - ay0, zero)
    area_b = torch.maximum(bx1 - bx0, zero) * torch.maximum(by1 - by0, zero)
    union = area_a + area_b - inter
    return torch.where(union > 0,
                       inter / torch.maximum(union, a.new_full((), 1e-10)),
                       zero)


@register_op("iou_similarity")
def _iou_similarity(ctx, ins, attrs):
    """X [N, 4] or [B, N, 4], Y [M, 4] -> the IoU matrix
    (iou_similarity_op.h)."""
    return {"Out": [_iou(ins["X"][0], ins["Y"][0])]}


def _center_size(box):
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    cx = (box[..., 2] + box[..., 0]) * 0.5
    cy = (box[..., 3] + box[..., 1]) * 0.5
    return cx, cy, w, h


def _log_ratio(num, den):
    """log(max(num / den, 1e-10)), the gradient split at the floor."""
    r = num / den
    return torch.log(torch.maximum(r, r.new_full((), 1e-10)))


@register_op("box_coder")
def _box_coder(ctx, ins, attrs):
    """encode_center_size: TargetBox [N, 4] x PriorBox [M, 4] -> Out
    [N, M, 4] offsets; encode_matched: TargetBox [..., M, 4] aligned to
    the priors; decode_center_size: offsets [..., M, 4] -> boxes
    (box_coder_op.h)."""
    prior = ins["PriorBox"][0]
    pvar = (ins["PriorBoxVar"][0] if ins.get("PriorBoxVar")
            else torch.ones_like(prior))
    target = ins["TargetBox"][0]
    code_type = attrs.get("code_type", "encode_center_size")

    pcx, pcy, pw, ph = _center_size(prior)                 # [M]
    if code_type == "encode_center_size":
        tcx, tcy, tw, th = _center_size(target)            # [N]
        ex = (tcx[:, None] - pcx[None, :]) / pw[None, :] / pvar[None, :, 0]
        ey = (tcy[:, None] - pcy[None, :]) / ph[None, :] / pvar[None, :, 1]
        ew = _log_ratio(tw[:, None], pw[None, :]) / pvar[None, :, 2]
        eh = _log_ratio(th[:, None], ph[None, :]) / pvar[None, :, 3]
        out = torch.stack([ex, ey, ew, eh], dim=-1)        # [N, M, 4]
    elif code_type == "encode_matched":
        tcx, tcy, tw, th = _center_size(target)
        out = torch.stack([
            (tcx - pcx) / pw / pvar[..., 0],
            (tcy - pcy) / ph / pvar[..., 1],
            _log_ratio(tw, pw) / pvar[..., 2],
            _log_ratio(th, ph) / pvar[..., 3],
        ], dim=-1)
    elif code_type == "decode_center_size":
        dcx = target[..., 0] * pvar[..., 0] * pw + pcx
        dcy = target[..., 1] * pvar[..., 1] * ph + pcy
        dw = torch.exp(target[..., 2] * pvar[..., 2]) * pw
        dh = torch.exp(target[..., 3] * pvar[..., 3]) * ph
        out = torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                           dcx + dw * 0.5, dcy + dh * 0.5], dim=-1)
    else:
        raise ValueError(f"box_coder: unknown code_type {code_type!r}")
    return {"OutputBox": [out]}


@register_op("bipartite_match", differentiable=False)
def _bipartite_match(ctx, ins, attrs):
    """Greedy bipartite matching (bipartite_match_op.cc): DistMat
    [B, N, M] (N gt rows, M priors) -> ColToRowMatchIndices [B, M] int32
    (-1 = unmatched) + ColToRowMatchDist [B, M]. Each of min(N, M) rounds
    takes every image's largest remaining entry (the first in row-major
    order among equals, as jnp.argmax over the flattened matrix), matches
    its row and column where it is above 0, and retires both, one
    batched step for all images. match_type='per_prediction' then
    matches each column left over to its best row when that distance
    exceeds dist_threshold."""
    dist = ins["DistMat"][0]
    if dist.dim() == 2:
        dist = dist[None]
    B, N, M = dist.shape
    dev = dist.device
    match_type = attrs.get("match_type", "bipartite")
    dist_threshold = attrs.get("dist_threshold", 0.5)
    idx = torch.full((B, M), -1, dtype=torch.int32, device=dev)
    val = torch.zeros((B, M), dtype=dist.dtype, device=dev)
    if not _meta(dist):
        rows = torch.arange(N, device=dev)
        cols = torch.arange(M, device=dev)
        neg = dist.new_full((), -1.0)
        d = dist
        for _ in range(min(N, M)):
            pos = torch.argmax(d.reshape(B, N * M), dim=1)        # [B]
            best = torch.gather(d.reshape(B, N * M), 1, pos[:, None])[:, 0]
            r, c = pos // M, pos % M
            valid = best > 0
            hit = (cols[None, :] == c[:, None]) & valid[:, None]  # [B, M]
            idx = torch.where(hit, r[:, None].to(torch.int32), idx)
            val = torch.where(hit, best[:, None], val)
            row_out = (rows[None, :] == r[:, None]) & valid[:, None]
            d = torch.where(row_out[:, :, None] | hit[:, None, :], neg, d)
        if match_type == "per_prediction":
            row = torch.argmax(dist, dim=1).to(torch.int32)       # [B, M]
            best = torch.amax(dist, dim=1)
            extra = (idx < 0) & (best > dist_threshold)
            idx = torch.where(extra, row, idx)
            val = torch.where(extra, best, val)
    return {"ColToRowMatchIndices": [idx], "ColToRowMatchDist": [val]}


@register_op("target_assign")
def _target_assign(ctx, ins, attrs):
    """Per-row gt attributes scattered onto the matched columns
    (target_assign_op.h): X [B, N, K] + MatchIndices [B, M] -> Out
    [B, M, K] (mismatch_value where unmatched) + OutWeight [B, M, 1]."""
    x = ins["X"][0]
    match = ins["MatchIndices"][0]
    mismatch = attrs.get("mismatch_value", 0)
    if x.dim() == 2:
        x = x[None]
    B, M = match.shape
    if x.shape[0] != B:
        x = x.expand(B, *x.shape[1:])
    K = x.shape[2]
    at = match.clamp(0, x.shape[1] - 1).long()
    gathered = torch.gather(x, 1, at[:, :, None].expand(B, M, K))
    matched = (match >= 0)[..., None]
    out = torch.where(matched, gathered,
                      torch.full((), mismatch, dtype=x.dtype,
                                 device=x.device))
    return {"Out": [out], "OutWeight": [matched.to(x.dtype)]}


def _nms_kept(scores, boxes, nms_top_k, nms_threshold):
    """The kept score of every (image, class, box) after greedy NMS (0 =
    suppressed or never picked): scores [B, C, M], boxes [B, M, 4]. Each
    of the nms_top_k steps picks each (image, class) row's highest live
    score (the first among equals) where it is above 0, keeps it, and
    zeroes every live box whose IoU with the pick is >= nms_threshold,
    the pick included. The pick's IoU row is computed from the boxes at
    each step by `_iou`'s formula on the same operands, the values of
    the reference's [M, M] matrix row without holding B x M x M."""
    B, C, M = scores.shape
    zero = scores.new_zeros(())
    x0, y0, x1, y1 = (boxes[:, None, :, i] for i in range(4))    # [B,1,M]
    area = (torch.maximum(x1 - x0, zero) * torch.maximum(y1 - y0, zero))
    coords = boxes[:, None, :, :].expand(B, C, M, 4)
    areas = area.expand(B, C, M)
    live, kept = scores, torch.zeros_like(scores)
    for _ in range(nms_top_k):
        top, p = torch.max(live, dim=2, keepdim=True)     # the first max
        pick = top > 0
        # kept >= 0 and a pick's kept score is 0 or its own: amax keeps it
        # where there is no pick (top <= 0) and writes it where there is
        kept = kept.scatter_reduce(2, p, top, "amax")
        pb = torch.gather(coords, 2, p[..., None].expand(B, C, 1, 4))
        px0, py0, px1, py1 = (pb[..., i] for i in range(4))      # [B,C,1]
        iw = torch.maximum(torch.minimum(px1, x1) - torch.maximum(px0, x0),
                           zero)
        ih = torch.maximum(torch.minimum(py1, y1) - torch.maximum(py0, y0),
                           zero)
        inter = iw * ih
        union = torch.gather(areas, 2, p) + area - inter
        iou = torch.where(union > 0,
                          inter / torch.maximum(union, union.new_full(
                              (), 1e-10)), zero)
        live = torch.where((iou >= nms_threshold) & pick, zero, live)
    return kept


@register_op("multiclass_nms", differentiable=False)
def _multiclass_nms(ctx, ins, attrs):
    """Per-class hard NMS and the cross-class keep_top_k
    (multiclass_nms_op.cc) with static shapes: Scores [B, C, M] + BBoxes
    [M, 4] shared or [B, M, 4] per image -> Out [B, keep_top_k, 6]
    (label, score, box; label -1 = padding) + OutCount [B] int32.

    The keep_top_k rows are ranked by a stable descending sort of the
    kept scores over class-major (class, box) indices, the lower index
    first among equals, as jax.lax.top_k: after suppression most scores
    are exactly 0, and the padding rows then carry the box of whichever
    index the ranking put there, so the order of ties decides Out."""
    scores = ins["Scores"][0]
    boxes = ins["BBoxes"][0]
    B, C, M = scores.shape
    dev = scores.device
    background = attrs.get("background_label", 0)
    score_threshold = attrs.get("score_threshold", 0.0)
    nms_threshold = attrs.get("nms_threshold", 0.3)
    nms_top_k = min(int(attrs.get("nms_top_k", 64)), M)
    keep_top_k = int(attrs.get("keep_top_k", 16))
    k = min(keep_top_k, C * M)
    if boxes.dim() == 2:
        boxes = boxes[None].expand(B, M, 4)
    if _meta(scores, boxes):
        return {"Out": [scores.new_empty((B, keep_top_k, 6))],
                "OutCount": [torch.empty((B,), dtype=torch.int32,
                                         device=dev)]}
    zero = scores.new_zeros(())
    s0 = torch.where(scores >= score_threshold, scores, zero)
    # the background class's scores zeroed first: its sweep picks nothing
    cls_ids = torch.arange(C, device=dev)[None, :, None]
    s0 = torch.where(cls_ids == background, zero, s0)
    kept = _nms_kept(s0, boxes, nms_top_k, nms_threshold)
    top_scores, top_idx = topk_lower_index_first(kept.reshape(B, C * M), k)
    cls_of = torch.div(top_idx, M, rounding_mode="floor").to(scores.dtype)
    box_of = torch.gather(boxes, 1, (top_idx % M)[..., None].expand(B, k, 4))
    valid = top_scores > 0
    label = torch.where(valid, cls_of, scores.new_full((), -1.0))
    out = torch.cat([label[..., None], top_scores[..., None], box_of],
                    dim=2)                                        # [B, k, 6]
    if k < keep_top_k:
        out = torch.cat([out, out.new_full((B, keep_top_k - k, 6), -1.0)],
                        dim=1)
    return {"Out": [out], "OutCount": [valid.sum(1).to(torch.int32)]}


@register_op("mine_hard_examples", differentiable=False)
def _mine_hard_examples(ctx, ins, attrs):
    """SSD hard-negative mining (mine_hard_examples_op.cc, max_negative
    mode): of the unmatched priors (MatchIndices -1, match distance below
    neg_dist_threshold), the neg_pos_ratio x num_positives with the
    largest classification loss. Returns NegMask [B, P] (1 = a chosen
    negative) for the reference's variable-length NegIndices. The loss
    ranking is a stable descending sort, so equal losses keep the lower
    prior first, and the rank of each prior is the inverse of that
    permutation (a second stable argsort), as the reference's two
    jnp.argsort calls."""
    cls_loss = ins["ClsLoss"][0]
    match = ins["MatchIndices"][0]
    match_dist = (ins["MatchDist"][0] if ins.get("MatchDist")
                  else torch.zeros_like(cls_loss))
    neg_pos_ratio = float(attrs.get("neg_pos_ratio", 3.0))
    neg_dist_threshold = float(attrs.get("neg_dist_threshold", 0.5))
    if cls_loss.dim() == 3:
        cls_loss = cls_loss[..., 0]
    if match_dist.dim() == 3:
        match_dist = match_dist[..., 0]
    if _meta(cls_loss):
        return {"NegMask": [torch.empty_like(cls_loss)]}
    eligible = (match == -1) & (match_dist < neg_dist_threshold)
    num_pos = (match >= 0).to(torch.int32).sum(1)
    num_neg = torch.minimum(
        (num_pos.to(torch.float32) * neg_pos_ratio).to(torch.int32),
        eligible.to(torch.int32).sum(1))
    masked = torch.where(eligible, cls_loss,
                         cls_loss.new_full((), -float("inf")))
    order = torch.argsort(-masked, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    neg_mask = (rank < num_neg[:, None]) & eligible
    return {"NegMask": [neg_mask.to(cls_loss.dtype)]}
