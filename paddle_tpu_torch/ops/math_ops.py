"""Math / tensor op lowerings (the port of the part of
`paddle_tpu/ops/math_ops.py` and `ops/tensor_ops.py` the training path
runs, with the ops the LR schedules, the gradient clips and the
regularizers append, the channel concat of the image models, and the
batched matmul, squeeze / unsqueeze and cosine similarity of the
sequence models).

Each lowering is a few lines of torch, run eagerly by the executor; the
large products (`mul`) go to `torch.matmul`, as the reference leaves
them to XLA. Broadcast semantics of elementwise_* (the `axis` attr
aligning Y into X, elementwise_op_function.h in the reference) are
reproduced exactly.
"""

from __future__ import annotations

import math

import torch

from .registry import register_op, torch_dtype


def _align_y(x, y, axis):
    """Reshape Y so it broadcasts into X aligned at `axis` (fluid semantics)."""
    if y.dim() >= x.dim() or y.dim() == 0:
        return y
    if axis == -1:
        axis = x.dim() - y.dim()
    shape = (1,) * axis + tuple(y.shape) + (1,) * (x.dim() - axis - y.dim())
    return y.reshape(shape)


def _elementwise(fn):
    def lowering(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        y = _align_y(x, y, attrs.get("axis", -1))
        return {"Out": [fn(x, y)]}
    return lowering


register_op("elementwise_add")(_elementwise(lambda x, y: x + y))
register_op("elementwise_sub")(_elementwise(lambda x, y: x - y))
register_op("elementwise_mul")(_elementwise(lambda x, y: x * y))
register_op("elementwise_div")(_elementwise(lambda x, y: x / y))
register_op("elementwise_max")(_elementwise(torch.maximum))
register_op("elementwise_min")(_elementwise(torch.minimum))


def _unary(fn):
    def lowering(ctx, ins, attrs):
        return {"Out": [fn(ins["X"][0], attrs)]}
    return lowering


register_op("exp")(_unary(lambda x, a: torch.exp(x)))
register_op("sqrt")(_unary(lambda x, a: torch.sqrt(x)))
register_op("square")(_unary(lambda x, a: torch.square(x)))
register_op("sign")(_unary(lambda x, a: torch.sign(x)))
register_op("pow")(_unary(lambda x, a: torch.pow(x, a.get("factor", 1.0))))


@register_op("reduce_sum")
def _reduce_sum(ctx, ins, attrs):
    """Sum over `dim` (default [0]) or every axis (`reduce_all`); a
    scalar result is shape [1] unless `keep_dim` (the reference's
    `_reduce`)."""
    x = ins["X"][0]
    if attrs.get("reduce_all", False):
        dims = tuple(range(x.dim()))
    else:
        dim = attrs.get("dim", [0])
        if isinstance(dim, int):
            dim = [dim]
        dims = tuple(d % x.dim() for d in dim)
    out = torch.sum(x, dim=dims, keepdim=bool(attrs.get("keep_dim", False)))
    if out.dim() == 0:
        out = out.reshape(1)
    return {"Out": [out]}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    """x * min(max_norm / max(||x||_2, 1e-12), 1) (operators/
    clip_by_norm_op.h)."""
    x = ins["X"][0]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.clamp_max(attrs["max_norm"] / torch.clamp_min(norm, 1e-12),
                            1.0)
    return {"Out": [x * scale]}


@register_op("less_than", differentiable=False)
def _less_than(ctx, ins, attrs):
    return {"Out": [ins["X"][0] < ins["Y"][0]]}


@register_op("select_where")
def _select_where(ctx, ins, attrs):
    return {"Out": [torch.where(ins["Condition"][0], ins["X"][0],
                                ins["Y"][0])]}


@register_op("increment", differentiable=False)
def _increment(ctx, ins, attrs):
    """X + step, the step cast to X's dtype (an int64 counter stays
    int64). When the op writes its own input (the LR schedules'
    `@LR_DECAY_COUNTER@`, an optimizer's `global_step`) and the context
    allows it, in place on the scope's tensor."""
    x = ins["X"][0]
    step = attrs.get("step", 1.0)
    step = int(step) if not x.is_floating_point() else float(step)
    op = ctx.op
    if ctx.in_place and op is not None and op.inputs["X"] == op.outputs["Out"]:
        with torch.no_grad():
            return {"Out": [x.add_(step)]}
    return {"Out": [x + step]}


@register_op("assign")
def _assign(ctx, ins, attrs):
    """A copy of X: the output may be a persistable that an optimizer
    then updates in place, which must not write through to X."""
    return {"Out": [ins["X"][0].clone()]}


@register_op("mul")
def _mul(ctx, ins, attrs):
    """Fluid `mul`: flatten X to 2-D at x_num_col_dims, Y at
    y_num_col_dims, matmul, restore leading dims (operators/mul_op.cc)."""
    x, y = ins["X"][0], ins["Y"][0]
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    x2 = x.reshape(math.prod(x.shape[:xnc]), -1)
    y2 = y.reshape(math.prod(y.shape[:ync]), -1)
    out = torch.matmul(x2, y2).to(x.dtype)
    return {"Out": [out.reshape(tuple(x.shape[:xnc])
                                + tuple(y.shape[ync:]))]}


@register_op("matmul")
def _matmul(ctx, ins, attrs):
    """Batched product of the last two axes (operators/matmul_op.cc):
    `transpose_X` / `transpose_Y` swap a (rank >= 2) operand's last two
    axes, `alpha` scales the product; torch.matmul broadcasts the batch
    axes as jnp.matmul does."""
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out.to(x.dtype)]}


@register_op("squeeze")
def _squeeze(ctx, ins, attrs):
    x = ins["X"][0]
    axes = attrs.get("axes", [])
    if not axes:
        return {"Out": [x.squeeze()]}
    for a in sorted((a % x.dim() for a in axes), reverse=True):
        if x.shape[a] != 1:
            raise ValueError(f"squeeze: axis {a} of {tuple(x.shape)} is "
                             "not 1")
        x = x.squeeze(a)
    return {"Out": [x]}


@register_op("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    x = ins["X"][0]
    for a in sorted(attrs["axes"]):
        x = x.unsqueeze(a)
    return {"Out": [x]}


@register_op("cos_sim")
def _cos_sim(ctx, ins, attrs):
    """Cosine similarity over the last axis (operators/cos_sim_op.cc);
    the norms are outputs too."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn + 1e-12)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register_op("sum")
def _sum(ctx, ins, attrs):
    """Variadic add (gradient accumulation, operators/sum_op.cc)."""
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("scale")
def _scale(ctx, ins, attrs):
    x = ins["X"][0]
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * scale + bias]}
    return {"Out": [(x + bias) * scale]}


@register_op("clip")
def _clip(ctx, ins, attrs):
    return {"Out": [ins["X"][0].clamp(attrs["min"], attrs["max"])]}


@register_op("floor")
def _floor(ctx, ins, attrs):
    return {"Out": [torch.floor(ins["X"][0])]}


@register_op("mean")
def _mean(ctx, ins, attrs):
    # Fluid mean outputs shape [1] (operators/mean_op.cc)
    return {"Out": [ins["X"][0].mean().reshape(1)]}


@register_op("arg_max", differentiable=False)
def _arg_max(ctx, ins, attrs):
    """int64 index of the maximum along `axis`; ties take the first index
    in both torch.argmax and jnp.argmax."""
    return {"Out": [torch.argmax(ins["X"][0], dim=attrs.get("axis", -1))]}


@register_op("cast")
def _cast(ctx, ins, attrs):
    return {"Out": [ins["X"][0].to(torch_dtype(attrs["out_dtype"]))]}


@register_op("concat")
def _concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("slice")
def _slice(ctx, ins, attrs):
    """A view of X (no copy): the attention op takes the q/k/v slices of
    the packed qkv plane by strides."""
    x = ins["X"][0]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[a] = slice(s, e)
    return {"Out": [x[tuple(idx)]]}


@register_op("lookup_table")
def _lookup_table(ctx, ins, attrs):
    """Embedding gather (operators/lookup_table_op.cc); the gradient is
    the dense scatter-add into the table (the reference's dense path;
    its SelectedRows sparse gradient is not ported)."""
    w = ins["W"][0]
    ids = ins["Ids"][0]
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    out = torch.nn.functional.embedding(ids, w)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return {"Out": [out]}
