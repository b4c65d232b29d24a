"""Creation and random op lowerings (the port of the part of
`paddle_tpu/ops/tensor_ops.py` the training path and its startup
program run). The random ops draw from the executor's
`torch.Generator` (`ctx.generator`, seeded from `Program.seed`) on the
executor's device, where the reference splits its threaded PRNG key:
the same seed gives other numbers than the JAX package's.
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
