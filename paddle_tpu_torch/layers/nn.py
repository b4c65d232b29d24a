"""Neural-network layers (the port's copy of the part of
`paddle_tpu/layers/nn.py` the GPT-2 training program, the image models
and the sequence models call: fc, embedding, conv2d, conv2d_transpose,
pool2d, batch_norm, layer_norm, dropout, the activations, the
classification losses, the fused lm-head cross-entropy, mean, the fused
attention and square_error_cost; the recurrences (dynamic_lstm,
dynamic_gru, simple_rnn, lstm_unit), the sequence layers, cos_sim,
edit_distance, row_conv and the beam-search steps; the CTC loss and
greedy decoder, and the linear-chain CRF's loss and Viterbi decoder). Layer functions
build IR; the work happens in the op lowerings (ops/).

A sequence input (lod_level >= 1) is a padded [B, T, ...] tensor whose
`seq_len_var` names its lengths: the layers carry it to their outputs
and wire it into the sequence ops' "SeqLen" slot."""

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
           "fused_lm_head_xent", "mean", "accuracy", "square_error_cost",
           "scaled_dot_product_attention", "dynamic_lstm", "dynamic_gru",
           "simple_rnn", "lstm_unit", "cos_sim", "sequence_pool",
           "sequence_first_step", "sequence_last_step", "sequence_softmax",
           "sequence_expand", "sequence_conv", "sequence_reshape",
           "sequence_concat", "sequence_mask", "edit_distance", "row_conv",
           "beam_search", "beam_search_decode", "warpctc",
           "ctc_greedy_decoder", "linear_chain_crf", "crf_decoding",
           "im2sequence", "nce", "hsigmoid", "Print"]


def _sequence_aware_num_cols(input, num_flatten_dims):
    shape = input.shape
    if num_flatten_dims == 1 and input.lod_level > 0 and len(shape) >= 3:
        # padded sequence [B, T, ...]: flatten all but the feature dim
        return len(shape) - 1
    if num_flatten_dims < 0:
        return len(shape) + num_flatten_dims
    return num_flatten_dims


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected (fluid layers/nn.py:75): out = act(sum_i X_i W_i
    + b). A padded sequence input multiplies as one [B*T, D] product."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    dtype = helper.input_dtype(inputs)

    mul_results = []
    for inp in inputs:
        xnc = _sequence_aware_num_cols(inp, num_flatten_dims)
        in_features = int(np.prod([s for s in inp.shape[xnc:]]))
        w = helper.create_parameter(param_attr, [in_features, size], dtype)
        out = helper.create_tmp_variable(dtype, lod_level=inp.lod_level)
        out.seq_len_var = inp.seq_len_var
        out.sub_seq_len_var = inp.sub_seq_len_var
        helper.append_op("mul", {"X": [inp.name], "Y": [w.name]},
                         {"Out": [out.name]},
                         {"x_num_col_dims": xnc, "y_num_col_dims": 1})
        mul_results.append(out)

    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype,
                                              lod_level=inputs[0].lod_level)
        pre_bias.seq_len_var = inputs[0].seq_len_var
        helper.append_op("sum", {"X": [v.name for v in mul_results]},
                         {"Out": [pre_bias.name]}, {})

    if bias_attr is False:
        pre_act = pre_bias
    else:
        b = helper.create_parameter(bias_attr, [size], dtype, is_bias=True)
        pre_act = helper.create_tmp_variable(dtype,
                                             lod_level=pre_bias.lod_level)
        pre_act.seq_len_var = pre_bias.seq_len_var
        pre_act.sub_seq_len_var = pre_bias.sub_seq_len_var
        helper.append_op("elementwise_add",
                         {"X": [pre_bias.name], "Y": [b.name]},
                         {"Out": [pre_act.name]},
                         {"axis": len(pre_bias.shape) - 1})
    return helper.append_activation(pre_act, act)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", name=None):
    """Lookup table (fluid layers/nn.py:196). The gradient is a dense
    scatter-add into the table; with `is_sparse=True` it is a
    SelectedRows of the looked-up rows instead, under the `sparse_grad`
    flag's dispatch (ops/math_ops.py `_lookup_table_sparse_grad`), and
    the optimizers' sparse branches move only those rows."""
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, size, dtype,
                                default_initializer=XavierInitializer())
    out = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    out.seq_len_var = input.seq_len_var
    out.sub_seq_len_var = input.sub_seq_len_var
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
    out.seq_len_var = x.seq_len_var
    out.sub_seq_len_var = x.sub_seq_len_var
    mask = helper.create_tmp_variable(x.dtype)
    helper.append_op("dropout", {"X": [x.name]},
                     {"Out": [out.name], "Mask": [mask.name]},
                     {"dropout_prob": dropout_prob, "is_test": is_test})
    return out


def _simple(op_type, out_slot="Out"):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
        out.seq_len_var = x.seq_len_var
        out.sub_seq_len_var = x.sub_seq_len_var
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
    loss.seq_len_var = input.seq_len_var
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


def accuracy(input, label, k=1, name=None):
    """Top-k accuracy (fluid layers accuracy): `input` = logits or
    probabilities [N, C], `label` int64 [N, 1]; the batch's accuracy
    [1] f32 (the op's Correct and Total, int64 [1], are its other
    outputs)."""
    from . import tensor as T
    helper = LayerHelper("accuracy", name=name)
    _, indices = T.topk(input, k)
    acc = helper.create_tmp_variable("float32")
    correct = helper.create_tmp_variable("int64")
    total = helper.create_tmp_variable("int64")
    helper.append_op("accuracy",
                     {"Out": [indices.name], "Label": [label.name]},
                     {"Accuracy": [acc.name], "Correct": [correct.name],
                      "Total": [total.name]}, {})
    return acc


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
    columns h*D:(h+1)*D). A sequence `keys` masks its padded keys by its
    lengths. `seq_axis` (ring attention over a mesh axis in the JAX
    package) is kept as an attr so the program text matches; the port
    runs one card and refuses a sequence-sharded program at run time."""
    helper = LayerHelper("sdpa", name=name)
    out = helper.create_tmp_variable(queries.dtype,
                                     lod_level=queries.lod_level)
    out.seq_len_var = queries.seq_len_var
    out.sub_seq_len_var = queries.sub_seq_len_var
    ins = {"Q": [queries.name], "K": [keys.name], "V": [values.name]}
    if keys.seq_len_var:
        ins["SeqLen"] = [keys.seq_len_var]
    helper.append_op("scaled_dot_product_attention", ins,
                     {"Out": [out.name]},
                     {"num_heads": num_heads, "causal": causal,
                      "seq_axis": seq_axis or ""})
    return out


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """Fused LSTM over padded sequences (fluid layers/nn.py:255).

    `input` is the pre-projected gate input [B, T, 4D] (size == 4D), as in
    the reference where an fc feeds dynamic_lstm. Returns (hidden, cell).
    """
    helper = LayerHelper("lstm", name=name)
    D = size // 4
    w = helper.create_parameter(param_attr, [D, 4 * D], dtype)
    bias_size = 7 * D if use_peepholes else 4 * D
    b = helper.create_parameter(bias_attr, [1, bias_size], dtype, is_bias=True)
    hidden = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    cell = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    hidden.seq_len_var = input.seq_len_var
    hidden.sub_seq_len_var = input.sub_seq_len_var
    cell.seq_len_var = input.seq_len_var
    cell.sub_seq_len_var = input.sub_seq_len_var
    ins = {"Input": [input.name], "Weight": [w.name], "Bias": [b.name],
           "SeqLen": [input.seq_len_var]}
    if h_0 is not None:
        ins["H0"] = [h_0.name]
    if c_0 is not None:
        ins["C0"] = [c_0.name]
    helper.append_op("lstm", ins,
                     {"Hidden": [hidden.name], "Cell": [cell.name]},
                     {"use_peepholes": use_peepholes,
                      "is_reverse": is_reverse,
                      "gate_activation": gate_activation,
                      "cell_activation": cell_activation,
                      "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_gru(input, size, h_0=None, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", dtype="float32", name=None):
    """Fused GRU over padded sequences; input [B, T, 3*size]."""
    helper = LayerHelper("gru", name=name)
    D = size
    w = helper.create_parameter(param_attr, [D, 3 * D], dtype)
    b = helper.create_parameter(bias_attr, [1, 3 * D], dtype, is_bias=True)
    hidden = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    hidden.seq_len_var = input.seq_len_var
    hidden.sub_seq_len_var = input.sub_seq_len_var
    ins = {"Input": [input.name], "Weight": [w.name], "Bias": [b.name],
           "SeqLen": [input.seq_len_var]}
    if h_0 is not None:
        ins["H0"] = [h_0.name]
    helper.append_op("gru", ins, {"Hidden": [hidden.name]},
                     {"is_reverse": is_reverse,
                      "gate_activation": gate_activation,
                      "activation": candidate_activation})
    return hidden


def simple_rnn(input, size, h_0=None, param_attr=None, act="tanh",
               is_reverse=False, dtype="float32", name=None):
    helper = LayerHelper("simple_rnn", name=name)
    w = helper.create_parameter(param_attr, [size, size], dtype)
    hidden = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    hidden.seq_len_var = input.seq_len_var
    hidden.sub_seq_len_var = input.sub_seq_len_var
    ins = {"Input": [input.name], "Weight": [w.name],
           "SeqLen": [input.seq_len_var]}
    if h_0 is not None:
        ins["H0"] = [h_0.name]
    helper.append_op("simple_rnn", ins, {"Hidden": [hidden.name]},
                     {"activation": act, "is_reverse": is_reverse})
    return hidden


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """Single LSTM step (fluid layers/nn.py lstm_unit) for custom loops."""
    from . import tensor as T
    helper = LayerHelper("lstm_unit", name=name)
    size = int(cell_t_prev.shape[-1])
    concat_in = T.concat([x_t, hidden_t_prev], axis=-1)
    gates = fc(concat_in, 4 * size, param_attr=param_attr,
               bias_attr=bias_attr)
    ig, fg, cg, og = (T.slice(gates, [len(gates.shape) - 1], [i * size],
                              [(i + 1) * size]) for i in range(4))
    i = sigmoid(ig)
    f = sigmoid(fg + forget_bias) if forget_bias else sigmoid(fg)
    c = f * cell_t_prev + i * tanh(cg)
    o = sigmoid(og)
    h = o * tanh(c)
    return h, c


def cos_sim(x, y, name=None):
    helper = LayerHelper("cos_sim", name=name)
    out = helper.create_tmp_variable(x.dtype)
    xn = helper.create_tmp_variable(x.dtype)
    yn = helper.create_tmp_variable(x.dtype)
    helper.append_op("cos_sim", {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name], "XNorm": [xn.name],
                      "YNorm": [yn.name]}, {})
    return out


# -- sequence layers --------------------------------------------------------


def _require_level1(x, op):
    """Ops whose nested (lod_level=2) semantics are not implemented must
    refuse rather than silently apply OUTER lengths to the sub-sequence
    axis (feeding nested data became possible with _pad_level2)."""
    _require_seq(x, op)
    if x.lod_level >= 2:
        raise NotImplementedError(
            f"{op}: nested (lod_level=2) input is not supported — pool "
            "the inner level first (sequence_pool) to get a level-1 "
            "sequence")


def _require_seq(x, op):
    if not x.seq_len_var:
        raise ValueError(f"{op} requires a sequence input (lod_level>=1)")


def sequence_pool(input, pool_type="average", name=None):
    """Level-1 input [B, T, ...] pools to [B, ...]. NESTED input
    (lod_level=2, [B, S, T, ...]) pools the INNER level over its
    sub-sequence lengths, producing a level-1 sequence [B, S, ...] that
    keeps the outer lengths — the reference's sequence_pool over the
    deepest LoD level (sequence_pool_op.cc on a 2-level LoDTensor)."""
    _require_seq(input, "sequence_pool")
    helper = LayerHelper("sequence_pool", name=name)
    if input.lod_level >= 2:
        out = helper.create_tmp_variable(input.dtype, lod_level=1)
        out.seq_len_var = input.seq_len_var        # outer level remains
        helper.append_op("sequence_pool",
                         {"X": [input.name],
                          "SeqLen": [input.sub_seq_len_var]},
                         {"Out": [out.name]},
                         {"pooltype": pool_type.upper()})
        return out
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("sequence_pool",
                     {"X": [input.name], "SeqLen": [input.seq_len_var]},
                     {"Out": [out.name]}, {"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input, name=None, level="top"):
    """First timestep. Nested (lod_level=2) input: level="top" gives
    the first token of the first subsequence ([B, ...]); level="inner"
    gives the first token of EACH subsequence ([B, S, ...] level-1
    sequence)."""
    _require_seq(input, "sequence_first_step")
    if level == "inner" and input.lod_level < 2:
        raise ValueError(
            "sequence_first_step(level='inner') needs a nested "
            f"(lod_level=2) input; this input is level {input.lod_level}")
    helper = LayerHelper("sequence_first_step", name=name)
    ins = {"X": [input.name], "SeqLen": [input.seq_len_var]}
    attrs = {}
    if input.lod_level >= 2:
        ins["SubSeqLen"] = [input.sub_seq_len_var]
        if level == "inner":
            attrs["inner_level"] = True
            out = helper.create_tmp_variable(input.dtype, lod_level=1)
            out.seq_len_var = input.seq_len_var
            helper.append_op("sequence_first_step", ins,
                             {"Out": [out.name]}, attrs)
            return out
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("sequence_first_step", ins, {"Out": [out.name]},
                     attrs)
    return out


def sequence_last_step(input, name=None, level="top"):
    """Last VALID timestep. Nested (lod_level=2) input: level="top"
    yields the last token of the last subsequence ([B, ...], the
    reference's LastSeqLayer over the top LoD level); level="inner"
    yields the last token of EACH subsequence ([B, S, ...] level-1
    sequence — legacy AggregateLevel.TO_SEQUENCE)."""
    _require_seq(input, "sequence_last_step")
    if level == "inner" and input.lod_level < 2:
        raise ValueError(
            "sequence_last_step(level='inner') needs a nested "
            "(lod_level=2) input; this input is level "
            f"{input.lod_level}")
    helper = LayerHelper("sequence_last_step", name=name)
    ins = {"X": [input.name], "SeqLen": [input.seq_len_var]}
    attrs = {}
    if input.lod_level >= 2:
        ins["SubSeqLen"] = [input.sub_seq_len_var]
        if level == "inner":
            attrs["inner_level"] = True
            out = helper.create_tmp_variable(input.dtype, lod_level=1)
            out.seq_len_var = input.seq_len_var
            helper.append_op("sequence_last_step", ins,
                             {"Out": [out.name]}, attrs)
            return out
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("sequence_last_step", ins, {"Out": [out.name]},
                     attrs)
    return out


def sequence_softmax(input, name=None):
    _require_level1(input, "sequence_softmax")
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_tmp_variable(input.dtype, lod_level=input.lod_level)
    out.seq_len_var = input.seq_len_var
    out.sub_seq_len_var = input.sub_seq_len_var
    helper.append_op("sequence_softmax",
                     {"X": [input.name], "SeqLen": [input.seq_len_var]},
                     {"Out": [out.name]}, {})
    return out


def sequence_expand(x, y, name=None):
    _require_seq(y, "sequence_expand")
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_tmp_variable(x.dtype, lod_level=y.lod_level)
    out.seq_len_var = y.seq_len_var
    out.sub_seq_len_var = y.sub_seq_len_var
    helper.append_op("sequence_expand", {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name]}, {})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, act=None, param_attr=None, bias_attr=None,
                  name=None):
    _require_level1(input, "sequence_conv")
    helper = LayerHelper("sequence_conv", name=name)
    dtype = input.dtype
    D = int(input.shape[-1])
    w = helper.create_parameter(param_attr, [filter_size * D, num_filters],
                                dtype)
    pre_bias = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    pre_bias.seq_len_var = input.seq_len_var
    pre_bias.sub_seq_len_var = input.sub_seq_len_var
    helper.append_op("sequence_conv",
                     {"X": [input.name], "Filter": [w.name],
                      "SeqLen": [input.seq_len_var]},
                     {"Out": [pre_bias.name]},
                     {"contextLength": filter_size,
                      "contextStart": -(filter_size // 2),
                      "contextStride": filter_stride})
    if bias_attr is False:
        pre_act = pre_bias
    else:
        b = helper.create_parameter(bias_attr, [num_filters], dtype,
                                    is_bias=True)
        pre_act = helper.create_tmp_variable(dtype,
                                             lod_level=input.lod_level)
        pre_act.seq_len_var = input.seq_len_var
        pre_act.sub_seq_len_var = input.sub_seq_len_var
        helper.append_op("elementwise_add",
                         {"X": [pre_bias.name], "Y": [b.name]},
                         {"Out": [pre_act.name]},
                         {"axis": len(pre_bias.shape or (0, 0, 0)) - 1})
    return helper.append_activation(pre_act, act)


def sequence_reshape(input, new_dim, name=None):
    _require_level1(input, "sequence_reshape")
    helper = LayerHelper("sequence_reshape", name=name)
    out = helper.create_tmp_variable(input.dtype, lod_level=input.lod_level)
    out.seq_len_var = input.seq_len_var
    out.sub_seq_len_var = input.sub_seq_len_var
    helper.append_op("sequence_reshape", {"X": [input.name]},
                     {"Out": [out.name]}, {"new_dim": new_dim})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_tmp_variable(input[0].dtype,
                                     lod_level=input[0].lod_level)
    out.seq_len_var = input[0].seq_len_var
    helper.append_op("sequence_concat", {"X": [v.name for v in input]},
                     {"Out": [out.name]}, {})
    return out


def sequence_mask(x, dtype="float32", name=None):
    """[B, T] 0/1 validity mask for a padded sequence tensor — the explicit
    form of the reference's LoD bounds, used for masked attention and
    masked losses."""
    _require_seq(x, "sequence_mask")
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_tmp_variable(dtype)
    helper.append_op("sequence_mask",
                     {"X": [x.name], "SeqLen": [x.seq_len_var]},
                     {"Out": [out.name]}, {"dtype": dtype})
    return out


def edit_distance(input, label, normalized=True, name=None):
    _require_seq(input, "edit_distance")
    _require_seq(label, "edit_distance")
    helper = LayerHelper("edit_distance", name=name)
    out = helper.create_tmp_variable("float32")
    seq_num = helper.create_tmp_variable("int64")
    helper.append_op("edit_distance",
                     {"Hyps": [input.name], "HypsLen": [input.seq_len_var],
                      "Refs": [label.name], "RefsLen": [label.seq_len_var]},
                     {"Out": [out.name], "SequenceNum": [seq_num.name]},
                     {"normalized": normalized})
    return out, seq_num


def beam_search(pre_scores, probs, pre_finished=None, beam_size=4,
                end_id=0, is_first_step=False, name=None):
    """One beam expansion step (fluid layers/nn.py:1911,
    operators/beam_search_op.cc) on the STATIC [batch, beam]
    layout: probs [B, K, V] post-softmax, pre_scores [B, K] cumulative
    log-probs. Returns (selected_ids, parent_idx, selected_scores,
    finished); a finished mask replaces the reference's shrinking LoD
    beam set."""
    helper = LayerHelper("beam_search", name=name)
    ids = helper.create_tmp_variable("int32")
    parents = helper.create_tmp_variable("int32")
    scores = helper.create_tmp_variable("float32")
    fin = helper.create_tmp_variable("int32")
    ins = {"PreScores": [pre_scores.name], "Probs": [probs.name]}
    if pre_finished is not None:
        ins["PreFinished"] = [pre_finished.name]
    helper.append_op("beam_search", ins,
                     {"SelectedIds": [ids.name], "ParentIdx": [parents.name],
                      "SelectedScores": [scores.name],
                      "Finished": [fin.name]},
                     {"beam_size": beam_size, "end_id": end_id,
                      "is_first_step": is_first_step})
    return ids, parents, scores, fin


def beam_search_decode(ids, parent_idx, final_scores, name=None):
    """Backtrack stacked beam_search steps into ranked sentences
    (operators/beam_search_decode_op.cc). ids/parent_idx [L, B, K],
    final_scores [B, K] -> (sentence_ids [B, K, L], sentence_scores)."""
    helper = LayerHelper("beam_search_decode", name=name)
    sids = helper.create_tmp_variable("int32")
    sscores = helper.create_tmp_variable("float32")
    helper.append_op("beam_search_decode",
                     {"Ids": [ids.name], "ParentIdx": [parent_idx.name],
                      "FinalScores": [final_scores.name]},
                     {"SentenceIds": [sids.name],
                      "SentenceScores": [sscores.name]}, {})
    return sids, sscores


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    """Lookahead row convolution (fluid layers/nn.py row_conv,
    operators/row_conv_op.cc — DeepSpeech2's streaming-friendly context
    layer). input: padded [B, T, D] sequence."""
    _require_seq(input, "row_conv")
    helper = LayerHelper("row_conv", name=name)
    D = input.shape[-1]
    # fluid contract: the filter covers the CURRENT step plus
    # future_context_size future steps -> future_context_size + 1 rows
    filt = helper.create_parameter(param_attr,
                                   [future_context_size + 1, D],
                                   input.dtype)
    out = helper.create_tmp_variable(input.dtype, shape=input.shape,
                                     lod_level=input.lod_level)
    out.seq_len_var = input.seq_len_var
    out.sub_seq_len_var = input.sub_seq_len_var
    helper.append_op("row_conv",
                     {"X": [input.name], "Filter": [filt.name],
                      "SeqLen": [input.seq_len_var]},
                     {"Out": [out.name]}, {})
    return helper.append_activation(out, act)


def linear_chain_crf(input, label, param_attr=None, name=None):
    """CRF negative log-likelihood (reference layers/nn.py linear_chain_crf
    + operators/linear_chain_crf_op.cc). input: emissions [B, T, K]
    (lod_level=1), label: int ids [B, T(,1)]. Returns NLL [B, 1]; the
    transition parameter is `<name>.w_0` shaped [K+2, K]."""
    _require_seq(input, "linear_chain_crf")
    helper = LayerHelper("linear_chain_crf", name=name)
    K = int(input.shape[-1])
    transition = helper.create_parameter(param_attr, [K + 2, K], input.dtype)
    nll = helper.create_tmp_variable(input.dtype)
    alpha = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        "linear_chain_crf",
        {"Emission": [input.name], "Transition": [transition.name],
         "Label": [label.name], "SeqLen": [input.seq_len_var]},
        {"LogLikelihood": [nll.name], "Alpha": [alpha.name]}, {})
    return nll


def crf_decoding(input, param_attr, label=None, name=None):
    """Viterbi decode using a trained CRF's transition parameter; pass the
    same param_attr (by name) used in linear_chain_crf."""
    from ..param_attr import ParamAttr
    attr = ParamAttr.to_attr(param_attr)
    if attr is None or attr.name is None:
        raise ValueError(
            "crf_decoding needs the NAMED param_attr of the transition "
            "parameter trained by linear_chain_crf (e.g. "
            "ParamAttr(name='crfw')); otherwise it would decode with a "
            "fresh random transition matrix")
    _require_seq(input, "crf_decoding")
    helper = LayerHelper("crf_decoding", name=name)
    K = int(input.shape[-1])
    transition = helper.create_parameter(param_attr, [K + 2, K], input.dtype)
    path = helper.create_tmp_variable("int64", lod_level=input.lod_level)
    path.seq_len_var = input.seq_len_var
    path.sub_seq_len_var = input.sub_seq_len_var
    ins = {"Emission": [input.name], "Transition": [transition.name],
           "SeqLen": [input.seq_len_var]}
    if label is not None:
        ins["Label"] = [label.name]
    helper.append_op("crf_decoding", ins, {"ViterbiPath": [path.name]}, {})
    return path


def warpctc(input, label, blank=0, norm_by_times=False, name=None):
    """CTC loss (fluid layers/nn.py:2660, operators/warpctc_op.cc).

    input: padded logits [B, T, C] with @SEQLEN lengths; label: padded
    int ids [B, U] with @SEQLEN lengths. Returns per-sequence loss
    [B, 1]. The warp-ctc CUDA library the reference dynloads
    (hl_warpctc_wrap.h) is replaced by a log-space forward recursion
    (ops/ctc_ops.py) whose autograd IS the CTC gradient.
    """
    _require_seq(input, "warpctc")
    _require_seq(label, "warpctc")
    helper = LayerHelper("warpctc", name=name)
    loss = helper.create_tmp_variable(
        input.dtype, shape=[input.shape[0] if input.shape else -1, 1])
    helper.append_op(
        "warpctc",
        {"Logits": [input.name], "LogitsLen": [input.seq_len_var],
         "Label": [label.name], "LabelLen": [label.seq_len_var]},
        {"Loss": [loss.name]},
        {"blank": blank, "norm_by_times": norm_by_times})
    return loss


def ctc_greedy_decoder(input, blank, name=None):
    """Greedy CTC decode (ctc_align_op.h semantics: merge repeats, drop
    blanks). input: [B, T, C] probs/logits or [B, T] int ids, with
    @SEQLEN lengths. Returns padded ids [B, T] whose @SEQLEN carries the
    decoded lengths (the reference compacts to a LoD tensor instead)."""
    _require_seq(input, "ctc_greedy_decoder")
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    from .tensor import argmax, cast
    ids = input
    if len(input.shape) == 3:
        ids = cast(argmax(input, axis=-1), "int32")
        ids.seq_len_var = input.seq_len_var
        ids.sub_seq_len_var = input.sub_seq_len_var
        ids.lod_level = input.lod_level
    out = helper.create_tmp_variable("int32", lod_level=1)
    out_len = helper.block.create_var(
        name=framework.seq_len_name(out.name), shape=None, dtype="int32")
    helper.append_op(
        "ctc_align",
        {"Input": [ids.name], "InLen": [ids.seq_len_var]},
        {"Output": [out.name], "OutLen": [out_len.name]},
        {"blank": blank, "merge_repeated": True})
    out.seq_len_var = out_len.name
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    helper = LayerHelper("im2sequence", name=name)
    out = helper.create_tmp_variable(input.dtype, lod_level=1)
    helper.append_op("im2sequence", {"X": [input.name]}, {"Out": [out.name]},
                     {"kernels": [filter_size, filter_size]
                      if isinstance(filter_size, int) else list(filter_size),
                      "strides": [stride, stride] if isinstance(stride, int)
                      else list(stride),
                      "paddings": [padding] * 4 if isinstance(padding, int)
                      else list(padding)})
    return out


def nce(input, label, num_total_classes, num_neg_samples=10,
        param_attr=None, bias_attr=None, sample_weight=None,
        custom_samples=None, name=None):
    """Noise-contrastive estimation loss (operators/nce_op.cc): a
    large-vocabulary classifier trained against uniformly sampled
    negatives instead of a full [B, V] softmax. Per-example cost [B, 1]."""
    helper = LayerHelper("nce", name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, [num_total_classes, dim],
                                input.dtype)
    b = helper.create_parameter(bias_attr, [num_total_classes], input.dtype,
                                is_bias=True)
    cost = helper.create_tmp_variable(
        input.dtype, shape=[input.shape[0] if input.shape else -1, 1])
    ins = {"Input": [input.name], "Label": [label.name], "Weight": [w.name],
           "Bias": [b.name]}
    if sample_weight is not None:
        ins["SampleWeight"] = [sample_weight.name]
    if custom_samples is not None:
        ins["CustomSamples"] = [custom_samples.name]
    helper.append_op("nce", ins, {"Cost": [cost.name]},
                     {"num_total_classes": num_total_classes,
                      "num_neg_samples": num_neg_samples})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """Hierarchical sigmoid loss over the complete binary tree's bit code
    (HierarchicalSigmoidLayer.cpp, MatrixBitCode.cpp). Per-example cost
    [B, 1]."""
    helper = LayerHelper("hsigmoid", name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, [num_classes - 1, dim],
                                input.dtype)
    b = helper.create_parameter(bias_attr, [num_classes - 1], input.dtype,
                                is_bias=True)
    cost = helper.create_tmp_variable(
        input.dtype, shape=[input.shape[0] if input.shape else -1, 1])
    helper.append_op("hsigmoid",
                     {"X": [input.name], "Label": [label.name],
                      "W": [w.name], "Bias": [b.name]},
                     {"Cost": [cost.name]},
                     {"num_classes": num_classes})
    return cost


def Print(input, message="", summarize=20, name=None):
    """Debug print pass-through (operators/print_op.cc): `input`'s value
    unchanged, printed on the host when the op runs (a sync on the
    card)."""
    helper = LayerHelper("print", name=name)
    out = helper.create_tmp_variable(input.dtype, shape=input.shape,
                                     lod_level=input.lod_level)
    out.seq_len_var = input.seq_len_var
    out.sub_seq_len_var = input.sub_seq_len_var
    helper.append_op("print", {"X": [input.name]}, {"Out": [out.name]},
                     {"message": message, "summarize": summarize})
    return out
