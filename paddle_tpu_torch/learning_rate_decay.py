"""In-graph learning-rate schedules (the port's copy of
`paddle_tpu/learning_rate_decay.py`).

The schedule is *ops in the main program* over the persistable
`@LR_DECAY_COUNTER@` (incremented in place once a step), so the decayed
LR is computed on the card inside the step, and a checkpoint carries the
schedule's position. Five schedules: exponential, natural-exp,
inverse-time, polynomial and piecewise.
"""

from __future__ import annotations

import math

from . import layers as T   # scale/fill_constant/... one namespace
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .layers.math_ops import elementwise_div, elementwise_min

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay"]


def _global_step_var(helper):
    gs = helper.create_persistable_var(
        "@LR_DECAY_COUNTER@", [1], "float32", ConstantInitializer(0.0))
    helper.append_op("increment", {"X": [gs.name]}, {"Out": [gs.name]},
                     {"step": 1.0}, infer_shape=False)
    return gs


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    helper = LayerHelper("exponential_decay")
    gs = _global_step_var(helper)
    div = T.scale(gs, scale=1.0 / decay_steps)
    if staircase:
        div = _floor(helper, div)
    lr = helper.create_tmp_variable("float32")
    # lr = base * decay_rate ^ div  ==  base * exp(div * ln(decay_rate))
    expo = T.scale(div, scale=math.log(decay_rate))
    helper.append_op("exp", {"X": [expo.name]}, {"Out": [lr.name]}, {},
                     infer_shape=False)
    return T.scale(helper.block.var(lr.name), scale=float(learning_rate))


def _floor(helper, x):
    out = helper.create_tmp_variable("float32")
    helper.append_op("floor", {"X": [x.name]}, {"Out": [out.name]}, {},
                     infer_shape=False)
    return out


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    helper = LayerHelper("natural_exp_decay")
    gs = _global_step_var(helper)
    div = T.scale(gs, scale=1.0 / decay_steps)
    if staircase:
        div = _floor(helper, div)
    expo = T.scale(div, scale=-decay_rate)
    lr = helper.create_tmp_variable("float32")
    helper.append_op("exp", {"X": [expo.name]}, {"Out": [lr.name]}, {},
                     infer_shape=False)
    return T.scale(helper.block.var(lr.name), scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    helper = LayerHelper("inverse_time_decay")
    gs = _global_step_var(helper)
    div = T.scale(gs, scale=1.0 / decay_steps)
    if staircase:
        div = _floor(helper, div)
    denom = T.scale(div, scale=decay_rate, bias=1.0)
    base = T.fill_constant([1], "float32", float(learning_rate))
    return elementwise_div(base, denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    helper = LayerHelper("polynomial_decay")
    gs = _global_step_var(helper)
    # frac = min(gs, decay_steps) / decay_steps  (cycle unsupported notes)
    capped = T.fill_constant([1], "float32", float(decay_steps))
    frac = elementwise_div(elementwise_min(gs, capped), capped)
    one_minus = T.scale(frac, scale=-1.0, bias=1.0)
    poly = helper.create_tmp_variable("float32")
    helper.append_op("pow", {"X": [one_minus.name]}, {"Out": [poly.name]},
                     {"factor": float(power)}, infer_shape=False)
    return T.scale(helper.block.var(poly.name),
                   scale=float(learning_rate - end_learning_rate),
                   bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    """lr = values[i] for step in (boundaries[i-1], boundaries[i]]."""
    helper = LayerHelper("piecewise_decay")
    gs = _global_step_var(helper)
    lr = T.fill_constant([1], "float32", float(values[-1]))
    # build nested selects from the last boundary backwards
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        bound = T.fill_constant([1], "float32", float(b))
        cond = T.less_than(gs, bound)
        vv = T.fill_constant([1], "float32", float(v))
        sel = helper.create_tmp_variable("float32")
        helper.append_op("select_where",
                         {"Condition": [cond.name], "X": [vv.name],
                          "Y": [lr.name]},
                         {"Out": [sel.name]}, {}, infer_shape=False)
        lr = helper.block.var(sel.name)
    return lr
