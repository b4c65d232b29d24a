"""Composed network blocks (the port's copy of `paddle_tpu/nets.py`,
fluid nets.py: simple_img_conv_pool, img_conv_group, sequence_conv_pool,
glu and scaled_dot_product_attention)."""

from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act=None, pool_type="max",
                         param_attr=None):
    conv_out = layers.conv2d(input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act)
    return layers.pool2d(conv_out, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1,
                   pool_type="max"):
    tmp = input
    if isinstance(conv_with_batchnorm, bool):
        conv_with_batchnorm = [conv_with_batchnorm] * len(conv_num_filter)
    if not isinstance(conv_batchnorm_drop_rate, (list, tuple)):
        conv_batchnorm_drop_rate = ([conv_batchnorm_drop_rate]
                                    * len(conv_num_filter))
    for i, nf in enumerate(conv_num_filter):
        local_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(tmp, num_filters=nf,
                            filter_size=conv_filter_size,
                            padding=conv_padding, act=local_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(tmp, conv_batchnorm_drop_rate[i])
    return layers.pool2d(tmp, pool_size=pool_size, pool_stride=pool_stride,
                         pool_type=pool_type)


def sequence_conv_pool(input, num_filters, filter_size, act="sigmoid",
                       pool_type="max"):
    conv_out = layers.sequence_conv(input, num_filters=num_filters,
                                    filter_size=filter_size, act=act)
    return layers.sequence_pool(conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return a * layers.sigmoid(b)


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Single-block attention (fluid nets.py dot-product attention) as
    matmul, softmax, matmul: q [B, Lq, D], k / v [B, Lk, D]. Not the
    fused attention op: no attention kernel runs."""
    d = int(queries.shape[-1])
    scores = layers.matmul(queries, keys, transpose_y=True,
                           alpha=d ** -0.5)
    weights = layers.softmax(scores)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_rate)
    return layers.matmul(weights, values)
