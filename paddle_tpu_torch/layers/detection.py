"""Detection layers: SSD-style heads, matching and NMS (the port's copy
of `paddle_tpu/layers/detection.py`).

Fluid-shaped API over the detection op set (reference fluid
layers/detection.py + operators/prior_box_op.cc, multiclass_nms_op.cc,
bipartite_match_op.cc, box_coder_op.h, iou_similarity_op.*,
target_assign_op.*). Ground-truth boxes travel as padded
[B, max_gt, 4] + per-image valid counts instead of LoD; NMS output is
padded [B, keep_top_k, 6] + counts (see ops/detection_ops.py). The
names, argument orders and Program text equal the JAX package's.
"""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "prior_box", "iou_similarity", "box_coder", "bipartite_match",
    "target_assign", "multiclass_nms", "multi_box_head", "ssd_loss",
    "detection_output", "mine_hard_examples",
]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    helper = LayerHelper("prior_box", name=name)
    boxes = helper.create_tmp_variable(input.dtype)
    var = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        "prior_box", {"Input": [input.name], "Image": [image.name]},
        {"Boxes": [boxes.name], "Variances": [var.name]},
        {"min_sizes": list(min_sizes), "max_sizes": list(max_sizes or []),
         "aspect_ratios": list(aspect_ratios or []),
         "variances": list(variance), "flip": flip, "clip": clip,
         "step_w": steps[0], "step_h": steps[1], "offset": offset})
    return boxes, var


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("iou_similarity", {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name]}, {})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", name=None):
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_tmp_variable(target_box.dtype)
    ins = {"PriorBox": [prior_box.name], "TargetBox": [target_box.name]}
    if prior_box_var is not None:
        ins["PriorBoxVar"] = [prior_box_var.name]
    helper.append_op("box_coder", ins, {"OutputBox": [out.name]},
                     {"code_type": code_type})
    return out


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    helper = LayerHelper("bipartite_match", name=name)
    idx = helper.create_tmp_variable("int32")
    dist = helper.create_tmp_variable(dist_matrix.dtype)
    helper.append_op("bipartite_match", {"DistMat": [dist_matrix.name]},
                     {"ColToRowMatchIndices": [idx.name],
                      "ColToRowMatchDist": [dist.name]},
                     {"match_type": match_type,
                      "dist_threshold": dist_threshold})
    return idx, dist


def target_assign(input, matched_indices, mismatch_value=0, name=None):
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_tmp_variable(input.dtype)
    weight = helper.create_tmp_variable(input.dtype)
    helper.append_op("target_assign",
                     {"X": [input.name],
                      "MatchIndices": [matched_indices.name]},
                     {"Out": [out.name], "OutWeight": [weight.name]},
                     {"mismatch_value": mismatch_value})
    return out, weight


def multiclass_nms(bboxes, scores, background_label=0, score_threshold=0.01,
                   nms_top_k=64, nms_threshold=0.3, keep_top_k=16,
                   name=None):
    """Returns (out [B, keep_top_k, 6], count [B]); rows with label -1
    are padding (the reference emits a variable-length LoD tensor)."""
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_tmp_variable(scores.dtype)
    count = helper.create_tmp_variable("int32")
    helper.append_op("multiclass_nms",
                     {"Scores": [scores.name], "BBoxes": [bboxes.name]},
                     {"Out": [out.name], "OutCount": [count.name]},
                     {"background_label": background_label,
                      "score_threshold": score_threshold,
                      "nms_top_k": nms_top_k,
                      "nms_threshold": nms_threshold,
                      "keep_top_k": keep_top_k})
    return out, count


def detection_output(loc, scores, prior_box, prior_box_var=None,
                     background_label=0, nms_threshold=0.3,
                     nms_top_k=64, keep_top_k=16, score_threshold=0.01,
                     name=None):
    """Fluid-signature inference head (fluid layers/detection.py
    detection_output): decode predicted offsets against the priors, then
    per-class NMS. loc [B,P,4] offsets, scores [B,P,C] class probs,
    prior_box [P,4]. Returns (out [B, keep_top_k, 6], count [B])."""
    from . import tensor
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")   # [B,P,4]
    cls_scores = tensor.transpose(scores, [0, 2, 1])      # [B,C,P]
    return multiclass_nms(decoded, cls_scores,
                          background_label=background_label,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k,
                          nms_threshold=nms_threshold,
                          keep_top_k=keep_top_k, name=name)


def mine_hard_examples(cls_loss, match_indices, match_dist=None,
                       neg_pos_ratio=3.0, neg_dist_threshold=0.5,
                       name=None):
    """Select hard negatives (mine_hard_examples_op.cc): returns a
    [B, P] mask of chosen negatives (the static-shape stand-in for the
    reference's NegIndices LoD output)."""
    helper = LayerHelper("mine_hard_examples", name=name)
    mask = helper.create_tmp_variable(cls_loss.dtype)
    ins = {"ClsLoss": [cls_loss.name],
           "MatchIndices": [match_indices.name]}
    if match_dist is not None:
        ins["MatchDist"] = [match_dist.name]
    helper.append_op("mine_hard_examples", ins, {"NegMask": [mask.name]},
                     {"neg_pos_ratio": neg_pos_ratio,
                      "neg_dist_threshold": neg_dist_threshold})
    return mask


def multi_box_head(inputs, image, min_sizes, max_sizes=None,
                   aspect_ratios=None, num_classes=21, flip=False,
                   clip=False, name=None):
    """SSD head (fluid layers/detection.py multi_box_head): per feature
    map, a 3x3 conv predicts per-prior box offsets and class scores, and
    prior_box emits the anchors. Returns (loc [B,P,4], conf [B,P,C],
    priors [P,4], prior_vars [P,4]) concatenated over feature maps."""
    from . import nn, tensor
    if aspect_ratios is None:
        aspect_ratios = [[]] * len(inputs)
    locs, confs, priors, pvars = [], [], [], []
    for i, fmap in enumerate(inputs):
        mins = (min_sizes[i] if isinstance(min_sizes[i], (list, tuple))
                else [min_sizes[i]])
        maxs = [max_sizes[i]] if max_sizes else []
        if maxs and len(maxs) != len(mins):
            raise ValueError(
                f"multi_box_head: feature map {i} has {len(mins)} "
                f"min_sizes but {len(maxs)} max_sizes — prior_box pairs "
                "them one-to-one; pass per-map max_sizes lists matching "
                "min_sizes, or omit max_sizes")
        ars = aspect_ratios[i]
        boxes, var = prior_box(fmap, image, mins, maxs, ars, flip=flip,
                               clip=clip)
        H, W, P = boxes.shape[0], boxes.shape[1], boxes.shape[2]
        priors.append(tensor.reshape(boxes, [H * W * P, 4]))
        pvars.append(tensor.reshape(var, [H * W * P, 4]))
        loc = nn.conv2d(fmap, P * 4, 3, padding=1,
                        name=f"{name or 'mbox'}_loc{i}")
        # [B, P*4, H, W] -> [B, H, W, P*4] -> [B, H*W*P, 4]
        loc = tensor.transpose(loc, [0, 2, 3, 1])
        locs.append(tensor.reshape(loc, [-1, H * W * P, 4]))
        conf = nn.conv2d(fmap, P * num_classes, 3, padding=1,
                         name=f"{name or 'mbox'}_conf{i}")
        conf = tensor.transpose(conf, [0, 2, 3, 1])
        confs.append(tensor.reshape(conf, [-1, H * W * P, num_classes]))
    cat = (lambda vs, ax: vs[0] if len(vs) == 1
           else tensor.concat(vs, axis=ax))
    return cat(locs, 1), cat(confs, 1), cat(priors, 0), cat(pvars, 0)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             loc_loss_weight=1.0, conf_loss_weight=1.0,
             neg_pos_ratio=None, name=None):
    """SSD training loss (fluid layers/detection.py ssd_loss, legacy
    gserver MultiBoxLossLayer): match priors to ground truth (bipartite
    + per-prediction), encode matched boxes against their priors, and
    combine smooth-L1 localisation loss on matched priors with softmax
    confidence loss. With `neg_pos_ratio=None` (default) every negative
    contributes to the confidence term; setting it (e.g. 3.0, the SSD
    paper's ratio) enables hard-negative mining via
    mine_hard_examples: only matched priors plus the top-loss negatives
    count, as a static [B, P] weight mask.

    location [B,P,4], confidence [B,P,C], gt_box [B,G,4] padded (pad
    rows all-zero), gt_label [B,G] int (pad rows get background),
    prior_box [P,4]. Returns per-image loss [B, 1].
    """
    from . import nn, math_ops, tensor

    # IoU between gt rows and priors, per image: [B,G,P]
    similarity = iou_similarity(gt_box, prior_box)
    match_idx, match_dist = bipartite_match(similarity, "per_prediction",
                                            overlap_threshold)

    # conf targets: gathered gt labels where matched, else background
    glab = gt_label
    if len(glab.shape) == 2:
        glab = tensor.unsqueeze(glab, [2])
    glab = tensor.cast(glab, "float32")
    conf_t, conf_w = target_assign(glab, match_idx,
                                   mismatch_value=background_label)
    conf_t = tensor.cast(conf_t, "int64")           # [B,P,1]
    conf_loss = nn.softmax_with_cross_entropy(confidence, conf_t)
    if neg_pos_ratio is not None:
        neg_mask = mine_hard_examples(conf_loss, match_idx, match_dist,
                                      neg_pos_ratio=neg_pos_ratio)
        conf_loss = conf_loss * (conf_w
                                 + tensor.unsqueeze(neg_mask, [2]))

    # loc targets: matched gt box per prior, encoded center-size.
    # Unmatched priors are masked by zeroing BOTH smooth-l1 operands
    # (zero diff -> zero loss), keeping the loss one dense [B,P,4] op.
    gt_matched, loc_w = target_assign(gt_box, match_idx, mismatch_value=0)
    enc = box_coder(prior_box, prior_box_var, gt_matched,
                    code_type="encode_matched")
    loc_loss = nn.smooth_l1(location * loc_w, enc * loc_w)   # [B,1]

    conf_total = math_ops.reduce_sum(conf_loss, dim=[1, 2],
                                     keep_dim=False)
    total = (tensor.reshape(conf_total, [-1, 1]) * conf_loss_weight
             + loc_loss * loc_loss_weight)
    return total
