"""v2 network helpers (reference trainer_config_helpers/networks.py:
simple_lstm :632, simple_gru :1076, simple_img_conv_pool, ...)."""

from __future__ import annotations

from .. import layers as flayers
from .. import nets as fnets
from . import layer as v2_layer

__all__ = ["simple_lstm", "simple_gru", "simple_img_conv_pool",
           "bidirectional_lstm", "sequence_conv_pool"]


def simple_lstm(input, size, reverse=False, act=None, name=None,
                **_compat):
    """fc(4*size) + lstm (networks.py:632): returns hidden sequence."""
    proj = flayers.fc(input, size * 4, name=f"{name or 'lstm'}_proj")
    hidden, _ = flayers.dynamic_lstm(proj, size * 4, is_reverse=reverse,
                                     name=name)
    return hidden


def simple_gru(input, size, reverse=False, name=None, **_compat):
    proj = flayers.fc(input, size * 3, name=f"{name or 'gru'}_proj")
    return flayers.dynamic_gru(proj, size, is_reverse=reverse, name=name)


def bidirectional_lstm(input, size, return_seq=True, name=None,
                       **_compat):
    fwd = simple_lstm(input, size, reverse=False,
                      name=f"{name or 'bilstm'}_fw")
    bwd = simple_lstm(input, size, reverse=True,
                      name=f"{name or 'bilstm'}_bw")
    if not return_seq:
        # reference networks.py: last_seq(fwd) ++ FIRST_seq(bwd) — the
        # reverse LSTM's informative final state sits at t=0
        return flayers.concat([flayers.sequence_last_step(fwd),
                               flayers.sequence_first_step(bwd)], axis=-1)
    return flayers.concat([fwd, bwd], axis=-1)


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_stride=None, act=None, **_compat):
    return fnets.simple_img_conv_pool(
        input, num_filters=num_filters, filter_size=filter_size,
        pool_size=pool_size, pool_stride=pool_stride or pool_size,
        act=v2_layer._act_name(act))


def sequence_conv_pool(input, context_len, hidden_size, act=None,
                       **_compat):
    return fnets.sequence_conv_pool(
        input, num_filters=hidden_size, filter_size=context_len,
        act=v2_layer._act_name(act))
