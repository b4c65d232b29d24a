"""Neural-network layers (the port's copy of the part of
`paddle_tpu/layers/nn.py` the GPT-2 training program and the image
models call: fc, embedding, conv2d, conv2d_transpose, pool2d,
batch_norm, layer_norm, dropout, the activations, the classification
losses, the fused lm-head cross-entropy, mean and the fused attention;
and square_error_cost, for regressions). Layer functions build IR; the
work happens in the op lowerings (ops/)."""

from __future__ import annotations

import numpy as np

from .. import framework
from ..initializer import (ConstantInitializer, NormalInitializer,
                           XavierInitializer)
from ..layer_helper import LayerHelper

__all__ = ["fc", "embedding", "conv2d", "conv2d_transpose", "pool2d",
           "batch_norm", "layer_norm", "dropout", "softmax", "log_softmax",
           "relu", "sigmoid", "tanh", "lrn", "maxout", "l2_normalize",
           "cross_entropy", "softmax_with_cross_entropy",
           "sigmoid_cross_entropy_with_logits", "smooth_l1",
           "fused_lm_head_xent", "mean", "square_error_cost",
           "scaled_dot_product_attention"]


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


def _pair_attr(v):
    return [v, v] if isinstance(v, int) else list(v)


def _bias_act(helper, pre_bias, num_filters, bias_attr, act):
    """The conv layers' channel bias (elementwise_add at axis 1) and
    activation."""
    if bias_attr is False:
        pre_act = pre_bias
    else:
        b = helper.create_parameter(bias_attr, [num_filters],
                                    pre_bias.dtype, is_bias=True)
        pre_act = helper.create_tmp_variable(pre_bias.dtype)
        helper.append_op("elementwise_add",
                         {"X": [pre_bias.name], "Y": [b.name]},
                         {"Out": [pre_act.name]}, {"axis": 1})
    return helper.append_activation(pre_act, act)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           use_cudnn=True, name=None):
    """NCHW convolution (fluid layers/nn.py:1138); the filter starts
    He-normal, std sqrt(2 / fan_in). `use_cudnn` is kept for the API."""
    helper = LayerHelper("conv2d", name=name)
    dtype = input.dtype
    C = int(input.shape[1])
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    w_shape = [num_filters, C // groups] + list(filter_size)
    fan_in = (C // groups) * filter_size[0] * filter_size[1]
    std = (2.0 / fan_in) ** 0.5
    w = helper.create_parameter(param_attr, w_shape, dtype,
                                default_initializer=NormalInitializer(0.0,
                                                                      std))
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op("conv2d",
                     {"Input": [input.name], "Filter": [w.name]},
                     {"Output": [pre_bias.name]},
                     {"strides": _pair_attr(stride),
                      "paddings": _pair_attr(padding),
                      "dilations": _pair_attr(dilation),
                      "groups": groups})
    return _bias_act(helper, pre_bias, num_filters, bias_attr, act)


def conv2d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     dilation=1, param_attr=None, bias_attr=None, act=None,
                     name=None):
    helper = LayerHelper("conv2d_transpose", name=name)
    dtype = input.dtype
    C = int(input.shape[1])
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    w = helper.create_parameter(param_attr,
                                [C, num_filters] + list(filter_size),
                                dtype, default_initializer=XavierInitializer())
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op("conv2d_transpose",
                     {"Input": [input.name], "Filter": [w.name]},
                     {"Output": [pre_bias.name]},
                     {"strides": _pair_attr(stride),
                      "paddings": _pair_attr(padding),
                      "dilations": _pair_attr(dilation)})
    return _bias_act(helper, pre_bias, num_filters, bias_attr, act)


def pool2d(input, pool_size=2, pool_type="max", pool_stride=None,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, use_cudnn=True, name=None):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_tmp_variable(input.dtype)
    if pool_stride is None:
        pool_stride = pool_size
    helper.append_op("pool2d", {"X": [input.name]}, {"Out": [out.name]},
                     {"pooling_type": pool_type,
                      "ksize": _pair_attr(pool_size),
                      "strides": _pair_attr(pool_stride),
                      "paddings": _pair_attr(pool_padding),
                      "global_pooling": global_pooling,
                      "ceil_mode": ceil_mode,
                      "exclusive": exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               moving_mean_name=None, moving_variance_name=None, name=None):
    """Batch normalisation (fluid layers/nn.py:1483); the running mean
    and variance are persistable vars the op reads and writes back."""
    helper = LayerHelper("batch_norm", name=name)
    dtype = input.dtype
    C = int(input.shape[1] if data_layout == "NCHW" or len(input.shape) == 2
            else input.shape[-1])
    scale = helper.create_parameter(
        param_attr, [C], dtype, default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, [C], dtype, is_bias=True)
    mean = helper.create_persistable_var(
        moving_mean_name or framework.unique_name(f"{helper.name}.mean"),
        [C], dtype, ConstantInitializer(0.0))
    variance = helper.create_persistable_var(
        moving_variance_name or framework.unique_name(f"{helper.name}.var"),
        [C], dtype, ConstantInitializer(1.0))
    y = helper.create_tmp_variable(dtype)
    saved_mean = helper.create_tmp_variable(dtype)
    saved_var = helper.create_tmp_variable(dtype)
    helper.append_op(
        "batch_norm",
        {"X": [input.name], "Scale": [scale.name], "Bias": [bias.name],
         "Mean": [mean.name], "Variance": [variance.name]},
        {"Y": [y.name], "MeanOut": [mean.name], "VarianceOut": [variance.name],
         "SavedMean": [saved_mean.name], "SavedVariance": [saved_var.name]},
        {"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
         "data_layout": data_layout})
    return helper.append_activation(y, act)


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


def dropout(x, dropout_prob, is_test=False, seed=None, name=None):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    mask = helper.create_tmp_variable(x.dtype)
    helper.append_op("dropout", {"X": [x.name]},
                     {"Out": [out.name], "Mask": [mask.name]},
                     {"dropout_prob": dropout_prob, "is_test": is_test})
    return out


def _simple(op_type, out_slot="Out"):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
        helper.append_op(op_type, {"X": [x.name]}, {out_slot: [out.name]},
                         attrs)
        return out
    layer.__name__ = op_type
    return layer


softmax = _simple("softmax")
log_softmax = _simple("log_softmax")
relu = _simple("relu")
sigmoid = _simple("sigmoid")
tanh = _simple("tanh")
lrn = _simple("lrn")


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("maxout", {"X": [x.name]}, {"Out": [out.name]},
                     {"groups": groups})
    return out


def l2_normalize(x, axis=-1, epsilon=1e-10, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_tmp_variable(x.dtype)
    norm = helper.create_tmp_variable(x.dtype)
    helper.append_op("l2_normalize", {"X": [x.name]},
                     {"Out": [out.name], "Norm": [norm.name]},
                     {"axis": axis, "epsilon": epsilon})
    return out


def cross_entropy(input, label, soft_label=False, name=None):
    helper = LayerHelper("cross_entropy", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("cross_entropy",
                     {"X": [input.name], "Label": [label.name]},
                     {"Y": [out.name]}, {"soft_label": soft_label})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               return_softmax=False, name=None):
    helper = LayerHelper("softmax_with_cross_entropy", name=name)
    softmax_out = helper.create_tmp_variable(logits.dtype)
    loss = helper.create_tmp_variable(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     {"Logits": [logits.name], "Label": [label.name]},
                     {"Softmax": [softmax_out.name], "Loss": [loss.name]},
                     {"soft_label": soft_label})
    if return_softmax:
        return loss, softmax_out
    return loss


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


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     {"X": [x.name], "Label": [label.name]},
                     {"Out": [out.name]}, {})
    return out


def smooth_l1(x, y, sigma=1.0, name=None):
    helper = LayerHelper("smooth_l1_loss", name=name)
    out = helper.create_tmp_variable(x.dtype)
    diff = helper.create_tmp_variable(x.dtype)
    helper.append_op("smooth_l1_loss", {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name], "Diff": [diff.name]},
                     {"sigma": sigma})
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
