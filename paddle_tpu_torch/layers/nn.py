"""Neural-network layers (the port's copy of the part of
`paddle_tpu/layers/nn.py` the GPT-2 training program calls: fc,
embedding, layer_norm, the fused lm-head cross-entropy, mean and the
fused attention; and square_error_cost, for regressions). Layer
functions build IR; the work happens in the op lowerings (ops/)."""

from __future__ import annotations

import numpy as np

from ..initializer import ConstantInitializer, XavierInitializer
from ..layer_helper import LayerHelper

__all__ = ["fc", "embedding", "layer_norm", "fused_lm_head_xent", "mean",
           "square_error_cost", "scaled_dot_product_attention"]


def _num_cols(input, num_flatten_dims):
    if num_flatten_dims < 0:
        return len(input.shape) + num_flatten_dims
    return num_flatten_dims


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected (fluid layers/nn.py:75): out = act(X W + b)."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    dtype = helper.input_dtype(inputs)

    mul_results = []
    for inp in inputs:
        xnc = _num_cols(inp, num_flatten_dims)
        in_features = int(np.prod([s for s in inp.shape[xnc:]]))
        w = helper.create_parameter(param_attr, [in_features, size], dtype)
        out = helper.create_tmp_variable(dtype, lod_level=inp.lod_level)
        helper.append_op("mul", {"X": [inp.name], "Y": [w.name]},
                         {"Out": [out.name]},
                         {"x_num_col_dims": xnc, "y_num_col_dims": 1})
        mul_results.append(out)

    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype,
                                              lod_level=inputs[0].lod_level)
        helper.append_op("sum", {"X": [v.name for v in mul_results]},
                         {"Out": [pre_bias.name]}, {})

    if bias_attr is False:
        pre_act = pre_bias
    else:
        b = helper.create_parameter(bias_attr, [size], dtype, is_bias=True)
        pre_act = helper.create_tmp_variable(dtype,
                                             lod_level=pre_bias.lod_level)
        helper.append_op("elementwise_add",
                         {"X": [pre_bias.name], "Y": [b.name]},
                         {"Out": [pre_act.name]},
                         {"axis": len(pre_bias.shape) - 1})
    return helper.append_activation(pre_act, act)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", name=None):
    """Lookup table (fluid layers/nn.py:196). The gradient is dense
    (a scatter-add into the table); `is_sparse` is kept as an attr so
    the program text matches, and the port has no SelectedRows path."""
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, size, dtype,
                                default_initializer=XavierInitializer())
    out = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    helper.append_op("lookup_table", {"W": [w.name], "Ids": [input.name]},
                     {"Out": [out.name]},
                     {"is_sparse": is_sparse,
                      "padding_idx": -1 if padding_idx is None
                      else padding_idx})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", name=name)
    dtype = input.dtype
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    ins = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(
            param_attr, norm_shape, dtype,
            default_initializer=ConstantInitializer(1.0))
        ins["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(bias_attr, norm_shape, dtype,
                                    is_bias=True)
        ins["Bias"] = [b.name]
    y = helper.create_tmp_variable(dtype)
    m = helper.create_tmp_variable(dtype)
    v = helper.create_tmp_variable(dtype)
    helper.append_op("layer_norm", ins,
                     {"Y": [y.name], "Mean": [m.name], "Variance": [v.name]},
                     {"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(y, act)


def fused_lm_head_xent(input, label, vocab_size, param_attr=None,
                       num_chunks=0, cache_logits="auto", name=None):
    """Classifier projection fused with softmax-cross-entropy
    (ops/chunked_ce.py): the [N, vocab] logits are never materialized.
    `input` [.., H] hidden states, `label` [.., 1] int. Returns the
    per-position loss [.., 1] f32. num_chunks 0 = auto (~8k columns per
    chunk of the backward)."""
    helper = LayerHelper("fused_lm_head_xent", name=name)
    in_features = int(input.shape[-1])
    w = helper.create_parameter(param_attr, [in_features, vocab_size],
                                helper.input_dtype([input]))
    loss = helper.create_tmp_variable("float32",
                                      lod_level=input.lod_level)
    helper.append_op("fused_lm_head_xent",
                     {"X": [input.name], "W": [w.name],
                      "Label": [label.name]},
                     {"Loss": [loss.name]},
                     {"num_chunks": int(num_chunks),
                      "cache_logits": cache_logits})
    return loss


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("mean", {"X": [x.name]}, {"Out": [out.name]}, {})
    return out


def square_error_cost(input, label, name=None):
    helper = LayerHelper("square_error_cost", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("square_error_cost",
                     {"X": [input.name], "Y": [label.name]},
                     {"Out": [out.name]}, {})
    return out


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 causal=False, seq_axis=None, name=None):
    """Fused multi-head attention over [B, T, H] planes (head h owns
    columns h*D:(h+1)*D). `seq_axis` (ring attention over a mesh axis in
    the JAX package) is kept as an attr so the program text matches;
    the port runs one card and refuses a sequence-sharded program at
    run time."""
    helper = LayerHelper("sdpa", name=name)
    out = helper.create_tmp_variable(queries.dtype,
                                     lod_level=queries.lod_level)
    ins = {"Q": [queries.name], "K": [keys.name], "V": [values.name]}
    helper.append_op("scaled_dot_product_attention", ins,
                     {"Out": [out.name]},
                     {"num_heads": num_heads, "causal": causal,
                      "seq_axis": seq_axis or ""})
    return out
