"""Tensor creation / manipulation layers (the port's copy of the part of
`paddle_tpu/layers/tensor.py` the training path, the image models, the
sequence models, the CTR models, the evaluators, the control-flow
programs and the OCR model call, and the rest of its layers)."""

from __future__ import annotations

import builtins

from .. import framework
from ..layer_helper import LayerHelper

__all__ = [
    "create_tensor", "create_parameter", "cast", "concat", "split",
    "reshape", "transpose", "squeeze", "unsqueeze", "stack", "expand",
    "fill_constant", "ones", "zeros", "assign", "increment", "argmax",
    "one_hot", "gather", "scatter", "slice", "shape", "less_than", "equal",
    "greater_than", "logical_and", "logical_or", "logical_not", "topk",
    "range", "multiplex", "isfinite", "uniform_random", "gaussian_random",
]


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, name=None):
    """Fresh uniform sample each run, drawn from the executor's
    generator (bench.py's synthetic token source)."""
    helper = LayerHelper("uniform_random", name=name)
    out = helper.create_tmp_variable(dtype, shape=list(shape))
    helper.append_op("uniform_random", {}, {"Out": [out.name]},
                     {"shape": list(shape), "dtype": dtype,
                      "min": min, "max": max})
    return out


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, name=None):
    helper = LayerHelper("gaussian_random", name=name)
    out = helper.create_tmp_variable(dtype, shape=list(shape))
    helper.append_op("gaussian_random", {}, {"Out": [out.name]},
                     {"shape": list(shape), "dtype": dtype,
                      "mean": mean, "std": std})
    return out


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.block.create_var(name=helper.name, dtype=dtype,
                                   persistable=persistable)


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


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
    else:
        num = len(num_or_sections)
        sections = list(num_or_sections)
    # builtins.range: this module's `range` is the layer (the
    # reference's split calls the layer here and raises, ROADMAP C34)
    outs = [helper.create_tmp_variable(input.dtype)
            for _ in builtins.range(num)]
    helper.append_op("split", {"X": [input.name]},
                     {"Out": [o.name for o in outs]},
                     {"axis": dim, "num": 0 if sections else num,
                      "sections": sections})
    return outs


def stack(x, axis=0, name=None):
    helper = LayerHelper("stack", name=name)
    out = helper.create_tmp_variable(x[0].dtype)
    helper.append_op("stack", {"X": [v.name for v in x]},
                     {"Out": [out.name]}, {"axis": axis})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("expand", {"X": [x.name]}, {"Out": [out.name]},
                     {"expand_times": list(expand_times)})
    return out


def ones(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 1.0, name=name)


def zeros(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 0.0, name=name)


def one_hot(input, depth, name=None):
    helper = LayerHelper("one_hot", name=name)
    out = helper.create_tmp_variable("float32")
    helper.append_op("one_hot", {"X": [input.name]}, {"Out": [out.name]},
                     {"depth": depth})
    return out


def gather(input, index, name=None):
    helper = LayerHelper("gather", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("gather", {"X": [input.name], "Index": [index.name]},
                     {"Out": [out.name]}, {})
    return out


def scatter(input, index, updates, name=None):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("scatter",
                     {"X": [input.name], "Ids": [index.name],
                      "Updates": [updates.name]},
                     {"Out": [out.name]}, {})
    return out


def range(start, end, step=1, dtype="int64", name=None):
    helper = LayerHelper("range", name=name)
    out = helper.create_tmp_variable(dtype)
    helper.append_op("range", {}, {"Out": [out.name]},
                     {"start": start, "end": end, "step": step,
                      "dtype": framework.canonical_dtype(dtype)})
    return out


def multiplex(inputs, index, name=None):
    helper = LayerHelper("multiplex", name=name)
    out = helper.create_tmp_variable(inputs[0].dtype)
    helper.append_op("multiplex",
                     {"X": [v.name for v in inputs], "Ids": [index.name]},
                     {"Out": [out.name]}, {})
    return out


def isfinite(x, name=None):
    helper = LayerHelper("isfinite", name=name)
    out = helper.create_tmp_variable("bool")
    helper.append_op("isfinite", {"X": [x.name]}, {"Out": [out.name]}, {})
    return out
