"""Elementwise / scalar math layers + Variable operator-sugar support
(the port's copy of the part of `paddle_tpu/layers/math_ops.py` the
training path calls)."""

from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper

__all__ = ["elementwise_add", "scale", "floor"]


def _elementwise(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
        out.seq_len_var = x.seq_len_var
        helper.append_op(op_type, {"X": [x.name], "Y": [y.name]},
                         {"Out": [out.name]}, {"axis": axis})
        return helper.append_activation(out, act)
    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise("elementwise_add")


def binary_helper(x, other, op_type, reverse=False):
    """Implements Variable `+` with a scalar (a scale op) or another
    Variable (elementwise_add), as the JAX package emits them."""
    if np.isscalar(other):
        return scale(x, scale=1.0, bias=float(other))
    if reverse:
        return _elementwise(op_type)(other, x)
    return _elementwise(op_type)(x, other)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    out.seq_len_var = x.seq_len_var
    helper.append_op("scale", {"X": [x.name]}, {"Out": [out.name]},
                     {"scale": float(scale), "bias": float(bias),
                      "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def floor(x, name=None):
    helper = LayerHelper("floor", name=name)
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    out.seq_len_var = x.seq_len_var
    helper.append_op("floor", {"X": [x.name]}, {"Out": [out.name]}, {})
    return out
