"""Creation, random, comparison and logical op lowerings (the port of
the part of `paddle_tpu/ops/tensor_ops.py` the training path, its
startup program and the control-flow programs run; `less_than` is in
math_ops.py). The comparisons and logical ops give bool, as the
reference's; `shape` gives an int64 vector. The random ops draw from
the executor's
`torch.Generator` (`ctx.generator`, seeded from `Program.seed`) on the
executor's device, where the reference splits its threaded PRNG key:
the same seed gives other numbers than the JAX package's.

Also the tensor tail: `gather`, `scatter`, `where`
(which raises, as the reference's does), `cumsum`, `range`,
`multiplex` and `print`.
"""

from __future__ import annotations

import torch

from .registry import register_op, torch_dtype


def _shape_dtype(attrs):
    return tuple(attrs["shape"]), torch_dtype(attrs.get("dtype", "float32"))


@register_op("fill_constant", differentiable=False)
def _fill_constant(ctx, ins, attrs):
    shape, dtype = _shape_dtype(attrs)
    return {"Out": [torch.full(shape, attrs.get("value", 0.0), dtype=dtype,
                               device=ctx.device)]}


@register_op("uniform_random", differentiable=False, stateful=True)
def _uniform_random(ctx, ins, attrs):
    shape, dtype = _shape_dtype(attrs)
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = torch.rand(shape, generator=ctx.generator, dtype=torch.float32,
                     device=ctx.device)
    return {"Out": [(out * (hi - lo) + lo).to(dtype)]}


@register_op("gaussian_random", differentiable=False, stateful=True)
def _gaussian_random(ctx, ins, attrs):
    shape, dtype = _shape_dtype(attrs)
    out = torch.randn(shape, generator=ctx.generator, dtype=torch.float32,
                      device=ctx.device)
    return {"Out": [(out * attrs.get("std", 1.0)
                     + attrs.get("mean", 0.0)).to(dtype)]}


@register_op("truncated_gaussian_random", differentiable=False,
             stateful=True)
def _trunc_gaussian(ctx, ins, attrs):
    """A standard normal truncated to [-2, 2], then scaled and shifted
    (the reference's jax.random.truncated_normal(-2, 2))."""
    shape, dtype = _shape_dtype(attrs)
    out = torch.nn.init.trunc_normal_(
        torch.empty(shape, dtype=torch.float32, device=ctx.device), 0.0,
        1.0, -2.0, 2.0, generator=ctx.generator)
    return {"Out": [(out * attrs.get("std", 1.0)
                     + attrs.get("mean", 0.0)).to(dtype)]}


@register_op("fill_zeros_like", differentiable=False)
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


@register_op("shape", differentiable=False)
def _shape(ctx, ins, attrs):
    return {"Out": [torch.tensor(tuple(ins["Input"][0].shape),
                                 dtype=torch.int64, device=ctx.device)]}


def _binary(fn):
    def lowering(ctx, ins, attrs):
        return {"Out": [fn(ins["X"][0], ins["Y"][0])]}
    return lowering


register_op("less_equal", differentiable=False)(_binary(torch.le))
register_op("greater_than", differentiable=False)(_binary(torch.gt))
register_op("greater_equal", differentiable=False)(_binary(torch.ge))
register_op("equal", differentiable=False)(_binary(torch.eq))
register_op("not_equal", differentiable=False)(_binary(torch.ne))
register_op("logical_and", differentiable=False)(_binary(torch.logical_and))
register_op("logical_or", differentiable=False)(_binary(torch.logical_or))
register_op("logical_xor", differentiable=False)(_binary(torch.logical_xor))


@register_op("logical_not", differentiable=False)
def _logical_not(ctx, ins, attrs):
    return {"Out": [torch.logical_not(ins["X"][0])]}


@register_op("gather")
def _gather(ctx, ins, attrs):
    """Rows of X at Index (an [N, 1] index is squeezed)."""
    idx = ins["Index"][0]
    if idx.dim() == 2 and idx.shape[-1] == 1:
        idx = idx.squeeze(-1)
    return {"Out": [ins["X"][0][idx.long()]]}


@register_op("scatter")
def _scatter(ctx, ins, attrs):
    """X with its rows at Ids overwritten by Updates (`.at[ids].set`).
    With duplicate ids, which write wins is unspecified here as in the
    reference (ROADMAP C31)."""
    x = ins["X"][0]
    idx = ins["Ids"][0]
    if idx.dim() == 2 and idx.shape[-1] == 1:
        idx = idx.squeeze(-1)
    return {"Out": [x.index_put((idx.long(),), ins["Updates"][0])]}


@register_op("where", differentiable=False)
def _where_index(ctx, ins, attrs):
    raise NotImplementedError(
        "`where` (nonzero indices) has a data-dependent output shape and "
        "cannot be compiled for TPU; use masked ops instead")


@register_op("cumsum")
def _cumsum(ctx, ins, attrs):
    """The reference's formulas: `reverse` flips around the cumsum,
    `exclusive` subtracts X from the inclusive sum (not a shifted scan,
    which rounds otherwise)."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis),
                         (axis,))
    else:
        out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = out - x
    return {"Out": [out]}


@register_op("range", differentiable=False)
def _range(ctx, ins, attrs):
    """arange from the static attrs: nothing is read on the host."""
    return {"Out": [torch.arange(attrs["start"], attrs["end"],
                                 attrs.get("step", 1),
                                 dtype=torch_dtype(attrs.get("dtype",
                                                             "int64")),
                                 device=ctx.device)]}


@register_op("multiplex")
def _multiplex(ctx, ins, attrs):
    """Row i of the output is row i of X[Ids[i]]."""
    ids = ins["Ids"][0]
    if ids.dim() == 2:
        ids = ids.squeeze(-1)
    stacked = torch.stack(ins["X"], dim=0)              # [k, N, D]
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return {"Out": [stacked[ids.long(), rows]]}


@register_op("print")
def _print(ctx, ins, attrs):
    """X unchanged, and `message shape=... values=...` (the first
    `summarize` values) printed on the host: a device -> host read, so
    one sync a call on the card, counted on `print.host_syncs` with the
    monitor on. Shape inference (meta tensors) prints nothing."""
    x = ins["X"][0]
    if x.device.type != "meta":
        from .. import monitor
        summarize = attrs.get("summarize", 20)
        flat = x.reshape(-1)[:summarize] if summarize and summarize > 0 \
            else x
        vals = flat.detach().cpu().numpy()
        monitor.counter_inc("print.host_syncs")
        print(f"{attrs.get('message', '')} shape={tuple(x.shape)} "
              f"values={vals}", flush=True)
    return {"Out": [x]}
