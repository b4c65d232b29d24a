"""v2 layer DSL (reference python/paddle/v2/layer.py re-exposing
trainer_config_helpers/layers.py's ~150 wrappers as composable v2
layers).

The strategy SURVEY §7.7 prescribes: the legacy 102-layer surface is
covered by TRANSLATION onto the fluid-shaped layer set rather than a
reimplementation of gserver — each v2 layer function here builds the
same Program IR the fluid layers build, so v2-style book scripts run on
the port's executor unchanged in shape. Activation/pooling come in as
objects (v2.activation / v2.pooling) and are mapped to op types.
"""

from __future__ import annotations

import numpy as np

from .. import layers as flayers
from ..framework import default_main_program

__all__ = [
    "data", "fc", "embedding", "lstmemory", "gru", "img_conv", "img_pool",
    "batch_norm", "dropout", "concat", "addto", "pooling", "last_seq",
    "first_seq", "max_id", "classification_cost", "cross_entropy_cost",
    "mse_cost", "square_error_cost", "regression_cost", "crf",
    "crf_decoding", "ctc", "nce", "hsigmoid",
]

_DATA_LAYER_ORDER = []   # creation order = default feeding order


def _act_name(act):
    if act is None:
        return None
    return getattr(act, "op_type", None)


def data(name, type, **kw):
    """v2 data layer: shape comes from the data_type declaration."""
    from . import data_type as dt
    shape, dtype, lod = dt.to_var_spec(type)
    var = flayers.data(name=name, shape=shape, dtype=dtype, lod_level=lod)
    if type.kind == "index":
        # remembered so embedding() can size its table (v2 semantics:
        # vocab comes from the data declaration)
        var._v2_value_range = type.dim
    if name not in _DATA_LAYER_ORDER:
        _DATA_LAYER_ORDER.append(name)
    return var


def fc(input, size, act=None, param_attr=None, bias_attr=None, name=None):
    return flayers.fc(input, size, act=_act_name(act),
                      param_attr=param_attr, bias_attr=bias_attr,
                      name=name)


def embedding(input, size, param_attr=None, name=None):
    # v2 embedding infers vocab from the data layer's declared range
    vocab = _vocab_of(input)
    return flayers.embedding(input, size=[vocab, size],
                             param_attr=param_attr, name=name)


def _vocab_of(var):
    vocab = getattr(var, "_v2_value_range", None)
    if vocab is None:
        raise ValueError(
            f"embedding over {var.name!r}: input must be a v2 data layer "
            "declared with integer_value(_sequence)(range)")
    return vocab


def lstmemory(input, size=None, reverse=False, act=None, name=None,
              **_compat):
    """v2 lstmemory: input is the pre-projected gate input [.., 4*size]
    (mixed/fc of 4x size in the reference)."""
    size = size or input.shape[-1] // 4
    hidden, _cell = flayers.dynamic_lstm(input, size * 4,
                                         is_reverse=reverse, name=name)
    return hidden


def gru(input, size=None, reverse=False, name=None, **_compat):
    size = size or input.shape[-1] // 3
    return flayers.dynamic_gru(input, size, is_reverse=reverse, name=name)


def img_conv(input, filter_size, num_filters, num_channels=None,
             stride=1, padding=0, act=None, param_attr=None,
             bias_attr=None, name=None, **_compat):
    return flayers.conv2d(input, num_filters, filter_size, stride=stride,
                          padding=padding, act=_act_name(act),
                          param_attr=param_attr, bias_attr=bias_attr,
                          name=name)


def img_pool(input, pool_size, stride=None, padding=0, pool_type=None,
             name=None, **_compat):
    from . import pooling as pooling_mod
    kind = "max"
    if isinstance(pool_type, pooling_mod.Avg):
        kind = "avg"
    return flayers.pool2d(input, pool_size=pool_size, pool_type=kind,
                          pool_stride=stride or pool_size,
                          pool_padding=padding, name=name)


def batch_norm(input, act=None, name=None, **_compat):
    return flayers.batch_norm(input, act=_act_name(act), name=name)


def dropout(input, dropout_rate, name=None):
    return flayers.dropout(input, dropout_prob=dropout_rate, name=name)


def concat(input, name=None):
    return flayers.concat(input, axis=-1, name=name)


def addto(input, act=None, name=None):
    out = input[0]
    for v in input[1:]:
        out = out + v
    if act is not None:
        from ..layer_helper import LayerHelper
        helper = LayerHelper("addto", name=name)
        out = helper.append_activation(out, _act_name(act))
    return out


def pooling(input, pooling_type=None, name=None):
    """Sequence pooling (v2 layer.pooling). Default is MAX pooling,
    matching the reference (layers.py:1417 wrap_param_default
    MaxPooling)."""
    from . import pooling as pooling_mod
    kind = "max"
    if isinstance(pooling_type, pooling_mod.Avg):
        kind = "average"
    elif isinstance(pooling_type, pooling_mod.Sum):
        kind = "sum"
    return flayers.sequence_pool(input, pool_type=kind, name=name)


def last_seq(input, name=None):
    return flayers.sequence_last_step(input, name=name)


def first_seq(input, name=None):
    return flayers.sequence_first_step(input, name=name)


def max_id(input, name=None):
    return flayers.argmax(input, axis=-1, name=name)


def classification_cost(input, label, name=None):
    """softmax output + cross-entropy (v2 classification_cost)."""
    return flayers.mean(flayers.cross_entropy(input, label), name=name)


def cross_entropy_cost(input, label, name=None):
    return flayers.mean(flayers.cross_entropy(input, label), name=name)


def mse_cost(input, label, name=None):
    return flayers.mean(flayers.square_error_cost(input, label),
                        name=name)


square_error_cost = mse_cost
regression_cost = mse_cost


def crf(input, label, size=None, param_attr=None, name=None):
    return flayers.linear_chain_crf(input, label, param_attr=param_attr,
                                    name=name)


def crf_decoding(input, size=None, label=None, param_attr=None,
                 name=None):
    return flayers.crf_decoding(input, param_attr, label=label, name=name)


def ctc(input, label, size=None, blank=0, norm_by_times=False,
        name=None):
    return flayers.warpctc(input, label, blank=blank,
                           norm_by_times=norm_by_times, name=name)


def nce(input, label, num_classes, num_neg_samples=10, param_attr=None,
        bias_attr=None, name=None):
    return flayers.nce(input, label, num_total_classes=num_classes,
                       num_neg_samples=num_neg_samples,
                       param_attr=param_attr, bias_attr=bias_attr,
                       name=name)


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    return flayers.hsigmoid(input, label, num_classes=num_classes,
                            param_attr=param_attr, bias_attr=bias_attr,
                            name=name)


def default_feed_order(feeding=None):
    """Resolve the reader-tuple order: an explicit v2 `feeding` dict
    (name -> tuple index) or data-layer creation order."""
    if feeding:
        return [n for n, _ in sorted(feeding.items(), key=lambda kv: kv[1])]
    block = default_main_program().global_block()
    return [n for n in _DATA_LAYER_ORDER if block.has_var(n)]


def reset_data_order():
    _DATA_LAYER_ORDER.clear()
