"""NN op lowerings (the port of the part of `paddle_tpu/ops/nn_ops.py`
the training path runs: the gelu activation, layer_norm and the
square_error_cost regression loss)."""

from __future__ import annotations

import torch

from .registry import register_op


@register_op("gelu")
def _gelu(ctx, ins, attrs):
    # jax.nn.gelu(approximate=True) is the tanh form
    approx = "tanh" if attrs.get("approximate", True) else "none"
    return {"Out": [torch.nn.functional.gelu(ins["X"][0],
                                             approximate=approx)]}


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """Normalise over the axes from begin_norm_axis on, in f32; Mean and
    Variance are the per-row statistics (squeezed, as the reference)."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    norm_shape = (1,) * begin + tuple(x.shape[begin:])
    if ins.get("Scale"):
        y = y * ins["Scale"][0].float().reshape(norm_shape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].float().reshape(norm_shape)
    return {"Y": [y.to(x.dtype)],
            "Mean": [mean.squeeze()], "Variance": [var.squeeze()]}


@register_op("square_error_cost")
def _square_error_cost(ctx, ins, attrs):
    return {"Out": [(ins["X"][0] - ins["Y"][0]).square()]}
