"""Tensor creation / manipulation layers (the port's copy of the part of
`paddle_tpu/layers/tensor.py` the training path and the image models
call)."""

from __future__ import annotations

from .. import framework
from ..layer_helper import LayerHelper

__all__ = ["create_parameter", "cast", "concat", "fill_constant", "slice",
           "uniform_random", "argmax", "assign", "increment", "less_than"]


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, name=None):
    """Fresh uniform sample each run, drawn from the executor's
    generator (bench.py's synthetic token source)."""
    helper = LayerHelper("uniform_random", name=name)
    out = helper.create_tmp_variable(dtype, shape=list(shape))
    helper.append_op("uniform_random", {}, {"Out": [out.name]},
                     {"shape": list(shape), "dtype": dtype,
                      "min": min, "max": max})
    return out


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    from ..param_attr import ParamAttr
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def cast(x, dtype, name=None):
    helper = LayerHelper("cast", name=name)
    dtype = framework.canonical_dtype(dtype)
    out = helper.create_tmp_variable(dtype, lod_level=x.lod_level)
    helper.append_op("cast", {"X": [x.name]}, {"Out": [out.name]},
                     {"out_dtype": dtype, "in_dtype": x.dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_tmp_variable(input[0].dtype,
                                     lod_level=input[0].lod_level)
    helper.append_op("concat", {"X": [v.name for v in input]},
                     {"Out": [out.name]}, {"axis": axis})
    return out


def fill_constant(shape, dtype, value, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    dtype = framework.canonical_dtype(dtype)
    if out is None:
        out = helper.create_tmp_variable(dtype)
    helper.append_op("fill_constant", {}, {"Out": [out.name]},
                     {"shape": list(shape), "dtype": dtype,
                      "value": float(value)})
    return out


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("slice", {"X": [input.name]}, {"Out": [out.name]},
                     {"axes": list(axes), "starts": list(starts),
                      "ends": list(ends)})
    return out


def argmax(x, axis=-1, name=None):
    """Index of the largest element along `axis` (the first one on ties),
    int64."""
    helper = LayerHelper("arg_max", name=name)
    out = helper.create_tmp_variable("int64")
    helper.append_op("arg_max", {"X": [x.name]}, {"Out": [out.name]},
                     {"axis": axis})
    return out


def assign(input, output=None, name=None):
    helper = LayerHelper("assign", name=name)
    if output is None:
        output = helper.create_tmp_variable(input.dtype)
    helper.append_op("assign", {"X": [input.name]}, {"Out": [output.name]}, {})
    return output


def increment(x, value=1.0, in_place=True, name=None):
    helper = LayerHelper("increment", name=name)
    out = x if in_place else helper.create_tmp_variable(x.dtype)
    helper.append_op("increment", {"X": [x.name]}, {"Out": [out.name]},
                     {"step": float(value)})
    return out


def less_than(x, y, cond=None, name=None):
    """x < y elementwise, bool; `cond` is an existing var to write."""
    helper = LayerHelper("less_than", name=name)
    out = cond if cond is not None else helper.create_tmp_variable("bool")
    helper.append_op("less_than", {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name]}, {})
    return out
