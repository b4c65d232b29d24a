"""In-graph metric-accumulation ops (the port of the part of
`paddle_tpu/ops/metric_ops.py` the AUC and accuracy evaluators run).

The evaluators keep their accumulators in persistable program vars
updated by ops every batch (evaluator.py), so a pass never ships raw
predictions to the host: `scatter_add_1d` is the histogram update behind
the AUC buckets, `auc_from_histograms` the pass-level metric read from
them by the eval program.
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
