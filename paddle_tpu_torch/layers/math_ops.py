"""Elementwise / scalar math layers + Variable operator-sugar support
(the port's copy of the part of `paddle_tpu/layers/math_ops.py` the
training path, the LR schedules, the gradient clips, the sequence
models and `max_sequence_len` call, and the rest of its layers)."""

from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper

__all__ = ["elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow", "scale", "sums", "matmul", "clip",
           "clip_by_norm", "sqrt", "square", "abs", "exp", "log", "sign",
           "pow", "cos", "sin", "floor", "ceil", "round", "reciprocal",
           "rsqrt", "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod", "cumsum"]


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
elementwise_sub = _elementwise("elementwise_sub")
elementwise_mul = _elementwise("elementwise_mul")
elementwise_div = _elementwise("elementwise_div")
elementwise_max = _elementwise("elementwise_max")
elementwise_min = _elementwise("elementwise_min")
elementwise_pow = _elementwise("elementwise_pow")


def binary_helper(x, other, op_type, reverse=False):
    """Implements Variable + - * / with a scalar (a scale op; a scalar
    divided by a Variable: a [1] constant and elementwise_div) or another
    Variable (elementwise_*), as the JAX package emits them."""
    from . import tensor as tensor_layers
    if np.isscalar(other):
        if op_type == "elementwise_add":
            return scale(x, scale=1.0, bias=float(other))
        if op_type == "elementwise_sub":
            if reverse:
                return scale(x, scale=-1.0, bias=float(other))
            return scale(x, scale=1.0, bias=-float(other))
        if op_type == "elementwise_mul":
            return scale(x, scale=float(other))
        if op_type == "elementwise_div":
            if not reverse:
                return scale(x, scale=1.0 / float(other))
            other = tensor_layers.fill_constant(
                shape=[1], dtype=x.dtype, value=float(other))
            return _elementwise(op_type)(other, x)
        raise NotImplementedError(op_type)
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


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    """Batched matmul of the last two axes (fluid layers matmul), with
    optional transposes and an output scale."""
    helper = LayerHelper("matmul", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("matmul", {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name]},
                     {"transpose_X": transpose_x, "transpose_Y": transpose_y,
                      "alpha": float(alpha)})
    return out


def sums(input, name=None):
    helper = LayerHelper("sum", name=name)
    out = helper.create_tmp_variable(input[0].dtype)
    helper.append_op("sum", {"X": [v.name for v in input]},
                     {"Out": [out.name]}, {})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("clip", {"X": [x.name]}, {"Out": [out.name]},
                     {"min": float(min), "max": float(max)})
    return out


def floor(x, name=None):
    helper = LayerHelper("floor", name=name)
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    out.seq_len_var = x.seq_len_var
    helper.append_op("floor", {"X": [x.name]}, {"Out": [out.name]}, {})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("clip_by_norm", {"X": [x.name]}, {"Out": [out.name]},
                     {"max_norm": float(max_norm)})
    return out


def _unary(op_type, attr_names=()):
    def layer(x, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
        out.seq_len_var = x.seq_len_var
        attrs = {k: kwargs[k] for k in attr_names if k in kwargs}
        helper.append_op(op_type, {"X": [x.name]}, {"Out": [out.name]}, attrs)
        return out
    layer.__name__ = op_type
    return layer


sqrt = _unary("sqrt")
square = _unary("square")
abs = _unary("abs")
exp = _unary("exp")
log = _unary("log")
sign = _unary("sign")
cos = _unary("cos")
sin = _unary("sin")
pow = _unary("pow", ("factor",))
ceil = _unary("ceil")
round = _unary("round")
reciprocal = _unary("reciprocal")
rsqrt = _unary("rsqrt")


def _reduce(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(input.dtype)
        attrs = {"keep_dim": keep_dim}
        if dim is None:
            attrs["reduce_all"] = True
        else:
            attrs["dim"] = [dim] if isinstance(dim, int) else list(dim)
        helper.append_op(op_type, {"X": [input.name]}, {"Out": [out.name]},
                         attrs)
        return out
    layer.__name__ = op_type
    return layer


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")
reduce_max = _reduce("reduce_max")
reduce_min = _reduce("reduce_min")
reduce_prod = _reduce("reduce_prod")


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    helper = LayerHelper("cumsum", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("cumsum", {"X": [x.name]}, {"Out": [out.name]},
                     {"axis": axis, "exclusive": exclusive, "reverse": reverse})
    return out
