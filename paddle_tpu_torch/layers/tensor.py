"""Tensor creation / manipulation layers (the port's copy of the part of
`paddle_tpu/layers/tensor.py` the training path, the image models, the
sequence models, the CTR models, the evaluators, the control-flow
programs and the OCR model call)."""

from __future__ import annotations

from .. import framework
from ..layer_helper import LayerHelper

__all__ = ["create_parameter", "cast", "concat", "fill_constant", "slice",
           "uniform_random", "argmax", "assign", "increment", "less_than",
           "equal", "greater_than", "logical_and", "logical_or",
           "logical_not", "shape", "transpose", "squeeze", "unsqueeze",
           "reshape", "topk"]


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
    out.seq_len_var = x.seq_len_var
    out.sub_seq_len_var = x.sub_seq_len_var
    helper.append_op("cast", {"X": [x.name]}, {"Out": [out.name]},
                     {"out_dtype": dtype, "in_dtype": x.dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_tmp_variable(input[0].dtype,
                                     lod_level=input[0].lod_level)
    out.seq_len_var = input[0].seq_len_var
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


def _cmp(op_type):
    def layer(x, y, cond=None, name=None):
        """Elementwise, bool; `cond` is an existing var to write (how a
        While body updates its loop condition)."""
        helper = LayerHelper(op_type, name=name)
        out = cond if cond is not None else helper.create_tmp_variable("bool")
        helper.append_op(op_type, {"X": [x.name], "Y": [y.name]},
                         {"Out": [out.name]}, {})
        return out
    layer.__name__ = op_type
    return layer


less_than = _cmp("less_than")
equal = _cmp("equal")
greater_than = _cmp("greater_than")
logical_and = _cmp("logical_and")
logical_or = _cmp("logical_or")


def logical_not(x, name=None):
    helper = LayerHelper("logical_not", name=name)
    out = helper.create_tmp_variable("bool")
    helper.append_op("logical_not", {"X": [x.name]}, {"Out": [out.name]}, {})
    return out


def shape(input, name=None):
    helper = LayerHelper("shape", name=name)
    out = helper.create_tmp_variable("int64")
    helper.append_op("shape", {"Input": [input.name]}, {"Out": [out.name]}, {})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("transpose", {"X": [x.name]}, {"Out": [out.name]},
                     {"axis": list(perm)})
    return out


def squeeze(input, axes=None, name=None):
    """Drop the size-1 axes `axes` (every size-1 axis when empty)."""
    helper = LayerHelper("squeeze", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("squeeze", {"X": [input.name]}, {"Out": [out.name]},
                     {"axes": list(axes or [])})
    return out


def unsqueeze(input, axes, name=None):
    """Insert size-1 axes at `axes` (in ascending order)."""
    helper = LayerHelper("unsqueeze", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("unsqueeze", {"X": [input.name]}, {"Out": [out.name]},
                     {"axes": list(axes)})
    return out


def reshape(x, shape, act=None, name=None):
    helper = LayerHelper("reshape", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("reshape", {"X": [x.name]}, {"Out": [out.name]},
                     {"shape": list(shape)})
    return helper.append_activation(out, act)


def topk(input, k, name=None):
    """(values, int64 indices) of the k largest of the last axis, the
    lower index first among equal values."""
    helper = LayerHelper("topk", name=name)
    values = helper.create_tmp_variable(input.dtype)
    indices = helper.create_tmp_variable("int64")
    helper.append_op("topk", {"X": [input.name]},
                     {"Out": [values.name], "Indices": [indices.name]},
                     {"k": k})
    return values, indices
