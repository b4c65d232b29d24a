"""Miscellaneous op lowerings (the port of the part of
`paddle_tpu/ops/misc_ops.py` the control-flow, recurrent_group and OCR
programs run): `fill_constant_batch_size_like` (a recurrent_group
memory's zero boot, the OCR model's full-width lengths), `is_empty` and
`lod_reset` (a new lengths vector for a padded sequence); and the
legacy tail: the activations hard_shrink / tanh_shrink /
soft_relu / prelu, `minus`, the losses log_loss / margin_rank_loss /
modified_huber_loss / squared_l2_distance / lambda_rank_cost, the norms
l1_norm / squared_l2_norm, label_smooth, the fills assign_value / fill,
bilinear_tensor_product, conv_shift and sampling_id.

The formulas are the reference's, with the ties of its jnp functions
(`jnp.clip` is a minimum of a maximum, ops/nn_ops.py's `_clip`).
`sampling_id` draws from the executor's generator (Gumbel-max, as
`jax.random.categorical`), so its draws differ from the JAX package's
(ROADMAP C32).
"""

from __future__ import annotations

import numpy as np
import torch

from .nn_ops import _act, _clip, _maximum
from .registry import register_op, torch_dtype


@register_op("fill_constant_batch_size_like", differentiable=False)
def _fill_constant_bsl(ctx, ins, attrs):
    """A constant fill whose `output_dim_idx` dim copies the input's
    `input_dim_idx` dim (fill_constant_batch_size_like_op.cc)."""
    x = ins["Input"][0]
    shape = [int(s) for s in attrs["shape"]]
    shape[attrs.get("output_dim_idx", 0)] = int(
        x.shape[attrs.get("input_dim_idx", 0)])
    return {"Out": [torch.full(shape, attrs.get("value", 0.0),
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "float32")),
                               device=ctx.device)]}


@register_op("is_empty", differentiable=False)
def _is_empty(ctx, ins, attrs):
    """[1] bool: whether X has no elements (is_empty_op.cc). Shapes are
    known on the host, so nothing is read from the card."""
    return {"Out": [torch.full((1,), ins["X"][0].numel() == 0,
                               dtype=torch.bool, device=ctx.device)]}


@register_op("lod_reset")
def _lod_reset(ctx, ins, attrs):
    """lod_reset_op.cc for the padded + @SEQLEN encoding: the values pass
    through and `SeqLenOut` is the new lengths vector, Y's lengths
    (`TargetLen`) or the `target_lod` offsets turned into int32
    lengths."""
    x = ins["X"][0]
    if ins.get("TargetLen"):
        new_len = ins["TargetLen"][0]
    else:
        target_lod = attrs.get("target_lod")
        if target_lod is None:
            raise ValueError("lod_reset needs TargetLen input or target_lod")
        lengths = np.diff(np.asarray(target_lod, dtype=np.int64))
        new_len = torch.from_numpy(lengths.astype(np.int32)).to(ctx.device)
    return {"Out": [x], "SeqLenOut": [new_len]}


# -- activation tail (activation_op.cc) -------------------------------------

register_op("hard_shrink")(_act(
    lambda x, a: torch.where(torch.abs(x) > a.get("threshold", 0.5), x,
                             torch.zeros_like(x))))
register_op("tanh_shrink")(_act(lambda x, a: x - torch.tanh(x)))
register_op("soft_relu")(_act(
    lambda x, a: torch.log1p(torch.exp(_clip(
        x, -a.get("threshold", 40.0), a.get("threshold", 40.0))))))


@register_op("prelu")
def _prelu(ctx, ins, attrs):
    """x > 0 ? x : alpha * x; Alpha is one scalar (`all`), one a channel
    (`channel`, NCHW axis 1) or one an element (`element`)."""
    x = ins["X"][0]
    alpha = ins["Alpha"][0]
    mode = attrs.get("mode", "all")
    if mode == "all":
        alpha = alpha.reshape(())
    elif mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "element":
        alpha = alpha.reshape(x.shape)
    else:
        raise ValueError("prelu: unknown mode %r" % (mode,))
    return {"Out": [torch.where(x > 0, x, alpha * x)]}


@register_op("minus")
def _minus(ctx, ins, attrs):
    return {"Out": [ins["X"][0] - ins["Y"][0]]}


# -- losses ------------------------------------------------------------------

@register_op("log_loss")
def _log_loss(ctx, ins, attrs):
    """-y log(p + eps) - (1 - y) log(1 - p + eps) (log_loss_op.cc)."""
    p, y = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-y * torch.log(p + eps)
                     - (1.0 - y) * torch.log(1.0 - p + eps)]}


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx, ins, attrs):
    """max(0, -label * (x1 - x2) + margin); `Activated` marks where the
    hinge is active."""
    x1, x2 = ins["X1"][0], ins["X2"][0]
    raw = -ins["Label"][0] * (x1 - x2) + attrs.get("margin", 0.0)
    return {"Out": [_maximum(raw, 0.0)],
            "Activated": [(raw > 0).to(x1.dtype)]}


@register_op("modified_huber_loss")
def _modified_huber_loss(ctx, ins, attrs):
    """v = (2y - 1) x; -4v below -1, (1 - v)^2 below 1, else 0."""
    x, y = ins["X"][0], ins["Y"][0]
    v = (2.0 * y - 1.0) * x
    out = torch.where(v < -1.0, -4.0 * v,
                      torch.where(v < 1.0, torch.square(1.0 - v),
                                  torch.zeros_like(v)))
    return {"Out": [out], "IntermediateVal": [v]}


@register_op("squared_l2_distance")
def _squared_l2_distance(ctx, ins, attrs):
    """Row-wise ||x - y||^2 over the flattened rows; Y of batch 1
    broadcasts. `sub_result` is the flattened difference."""
    x, y = ins["X"][0], ins["Y"][0]
    sub = x.reshape(x.shape[0], -1) - y.reshape(y.shape[0], -1)
    return {"sub_result": [sub],
            "Out": [torch.sum(sub * sub, dim=1, keepdim=True)]}


@register_op("l1_norm")
def _l1_norm(ctx, ins, attrs):
    return {"Out": [torch.sum(torch.abs(ins["X"][0])).reshape(1)]}


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.sum(x * x).reshape(1)]}


@register_op("label_smooth")
def _label_smooth(ctx, ins, attrs):
    """(1 - eps) x + eps * prior, the prior uniform without PriorDist."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    if ins.get("PriorDist"):
        prior = ins["PriorDist"][0].reshape(-1)
        return {"Out": [(1.0 - eps) * x + eps * prior.expand(x.shape)]}
    return {"Out": [(1.0 - eps) * x + eps / float(x.shape[-1])]}


# -- fills -------------------------------------------------------------------

@register_op("assign_value", differentiable=False)
def _assign_value(ctx, ins, attrs):
    """A constant from attrs: `fp32_values` as float32, else
    `int32_values` as int32."""
    shape = [int(s) for s in attrs["shape"]]
    if attrs.get("fp32_values"):
        vals = np.asarray(attrs["fp32_values"], dtype=np.float32)
    else:
        vals = np.asarray(attrs.get("int32_values", []), dtype=np.int32)
    return {"Out": [torch.from_numpy(vals).reshape(shape).to(ctx.device)]}


@register_op("fill", differentiable=False)
def _fill(ctx, ins, attrs):
    """A tensor from a flat `value` attr, its `shape` and `dtype`."""
    shape = [int(s) for s in attrs["shape"]]
    vals = np.asarray(attrs["value"], dtype=attrs.get("dtype", "float32"))
    return {"Out": [torch.from_numpy(vals).reshape(shape).to(ctx.device)]}


# -- specialty math ----------------------------------------------------------

@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs):
    """out[b, s] = x[b] W[s] y[b]^T (+ bias): x [B, M] @ W [S, M, N]
    first, then the row products with y [B, N]."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]
    xw = torch.einsum("bm,smn->bsn", x, w)
    out = torch.einsum("bsn,bn->bs", xw, y)
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(1, -1)
    return {"Out": [out]}


@register_op("conv_shift")
def _conv_shift(ctx, ins, attrs):
    """Per-row circular correlation, out[b, i] = sum_j x[b, (i + j -
    (N - 1) / 2) mod M] y[b, j], as a gather into an [M, N] index table
    and one product."""
    x, y = ins["X"][0], ins["Y"][0]
    M, N = int(x.shape[1]), int(y.shape[1])
    half = (N - 1) // 2
    idx = (np.arange(M)[:, None] + np.arange(N)[None, :] - half) % M
    gathered = x[:, torch.from_numpy(idx).to(x.device)]     # [B, M, N]
    return {"Out": [torch.einsum("bmn,bn->bm", gathered, y)]}


@register_op("sampling_id", stateful=True, differentiable=False)
def _sampling_id(ctx, ins, attrs):
    """One class id a row of a probability matrix [B, C], int64: the
    argmax of log(max(p, 1e-20)) plus Gumbel noise from the executor's
    generator (jax.random.categorical's method; other draws than the
    JAX package's, ROADMAP C32). A one-hot row always gives its hot
    class."""
    x = ins["X"][0].float()
    logp = torch.log(torch.clamp_min(x, 1e-20))
    # uniform in [tiny, 1), as jax.random.gumbel draws it: a 0 would
    # give the hot class -inf
    u = torch.clamp_min(torch.rand(x.shape, generator=ctx.generator,
                                   dtype=torch.float32, device=x.device),
                        torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return {"Out": [torch.argmax(logp + gumbel, dim=-1)]}


@register_op("lambda_rank_cost")
def _lambda_rank_cost(ctx, ins, attrs):
    """LambdaRank cost with the reference's gradient field (gserver
    CostLayer.cpp LambdaCost::calcGrad): pairs in the label-sorted
    (ideal) order, truncated by `max_sort_size` (-1: the whole list),
    each pair w * log1p(exp(-(s_i - s_j))) with its |dcgDif| / maxDCG
    weight w held constant (`.detach()`, the reference's
    stop_gradient). `Ndcg` is the NDCG of the model's current ranking,
    constant too."""
    s = ins["Score"][0].float()
    y = ins["Label"][0].float()
    if s.dim() == 3:
        s = s[..., 0]
    if y.dim() == 3:
        y = y[..., 0]
    seqlen = ins["SeqLen"][0]
    ndcg_num = int(attrs.get("NDCG_num", 5))
    mss = int(attrs.get("max_sort_size", -1))
    B, T = s.shape
    dev = s.device
    t = torch.arange(T, device=dev)
    valid = t[None, :] < seqlen[:, None]
    lens = seqlen.to(torch.int32)
    sort_size = lens if mss == -1 else torch.clamp_max(lens, mss)
    inf = torch.full((), float("inf"), device=dev)
    zero = torch.zeros((), device=dev)

    gain = torch.where(valid, torch.exp2(y) - 1.0, zero)
    order = torch.argsort(torch.where(valid, -y, inf), dim=1, stable=True)
    pos = torch.argsort(order, dim=1)
    disc = 1.0 / torch.log(pos.float() + 2.0)

    ideal_gain = torch.flip(torch.sort(gain, dim=1).values, (1,))
    tf = torch.arange(T, dtype=torch.float32, device=dev)
    topk = (tf < ndcg_num).float()
    max_dcg = torch.sum(ideal_gain * topk / torch.log(tf + 2.0), dim=1)
    max_dcg = torch.clamp_min(max_dcg, 1e-12)

    in_prefix = pos < sort_size[:, None]
    dg = gain[:, :, None] - gain[:, None, :]
    disc_diff = torch.where(in_prefix[:, None, :],
                            disc[:, :, None] - disc[:, None, :],
                            disc[:, :, None])
    delta = (torch.abs(dg * disc_diff) / max_dcg[:, None, None]).detach()
    pair = (valid[:, :, None] & valid[:, None, :]
            & (pos[:, :, None] < pos[:, None, :])
            & in_prefix[:, :, None])
    ds = s[:, :, None] - s[:, None, :]
    pl = torch.log1p(torch.exp(-_clip(ds, -30.0, 30.0)))
    cost = torch.sum(torch.where(pair, delta * pl, zero), dim=(1, 2))

    s_order = torch.argsort(torch.where(valid, -s, inf), dim=1, stable=True)
    s_pos = torch.argsort(s_order, dim=1)
    dcg = torch.sum(torch.where(s_pos < ndcg_num,
                                gain / torch.log(s_pos.float() + 2.0),
                                zero), dim=1)
    ndcg = (dcg / max_dcg).detach()
    return {"Out": [cost[:, None]], "Ndcg": [ndcg[:, None]]}
