"""The rest of the op corpus in the port (ops/math_ops.py, tensor_ops.py,
misc_ops.py, vision_ops.py and ctc_ops.py's nce / hsigmoid) against the
JAX package's lowerings, on the CPU.

Each case hands both lowerings the same seeded numpy inputs
(`torch_parity_helpers.run_both`): every output slot the reference
returns within 1e-5 absolute, integer, bool and selecting outputs
exactly, and the gradients of the primary output with respect to the
listed float inputs within 1e-4 of each gradient's largest element.
Each case also runs the port's lowering on meta tensors (build-time
shape inference) and must give the CPU run's shapes and dtypes.

The tie cases: `round` at halves (half to even), `cumsum` reversed and
exclusive (the reference's formulas), `reduce_min` over tied minima and
the `with_index` pools over tied windows (the gradient split equally,
ROADMAP C33), `spp` max over a tied window (all to the first maximum,
C10). `where` raises as the reference's does; `scatter` is held with
distinct ids (C31); the random ops' draws differ from the JAX package's
(C32) and are held by their distributions.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import monitor
from paddle_tpu_torch.ops import registry as preg
from torch_parity_helpers import (check_grads, check_outputs, run_both,
                                  uniform)
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _rs(seed):
    return np.random.RandomState(seed)


def _meta_matches(op, ins, attrs, pout):
    """The port's lowering on meta tensors gives the CPU run's shapes and
    dtypes."""
    meta = {k: [torch.empty(np.shape(v), device="meta",
                            dtype=torch.from_numpy(
                                np.asarray(v)[..., :0]).dtype)
                for v in vs] for k, vs in ins.items()}
    with torch.no_grad():
        mout = preg.get_op(op).lowering(preg._MetaCtx(), meta, dict(attrs))
    for slot, vals in pout.items():
        for p, m in zip(vals, mout[slot]):
            assert tuple(m.shape) == tuple(p.shape), (op, slot)
            assert m.dtype == p.dtype, (op, slot)


def _case(op, ins, attrs=None, out="Out", grad=(), cot=None):
    attrs = dict(attrs or {})
    jout, pout, jg, pg = run_both(op, ins, attrs, out=out, grad=grad,
                                  cot=cot)
    check_outputs(jout, pout)
    if grad:
        check_grads(jg, pg)
    _meta_matches(op, {k: [np.asarray(v) for v in vs]
                       for k, vs in ins.items()}, attrs, pout)
    return jout, pout, jg, pg


def _pos(seed, shape):
    return uniform(seed, shape, 0.5, 2.0)


HALVES = np.asarray([[-2.5, -1.5, -0.5, 0.5], [1.5, 2.5, 3.5, -3.5],
                     [0.49999997, 1.2, -1.7, 0.0]], np.float32)

# (id, op, inputs, attrs, output slot, gradient slots)
CASES = [
    # -- math_ops ------------------------------------------------------
    ("elementwise_pow", "elementwise_pow",
     {"X": [_pos(0, (3, 4))], "Y": [uniform(1, (3, 4), -2, 2)]}, {}, "Out",
     ("X", "Y")),
    ("elementwise_pow_axis", "elementwise_pow",
     {"X": [_pos(2, (2, 3, 4))], "Y": [uniform(3, (3,), -1, 2)]},
     {"axis": 1}, "Out", ("X", "Y")),
    ("rsqrt", "rsqrt", {"X": [_pos(4, (5, 6))]}, {}, "Out", ("X",)),
    ("abs", "abs", {"X": [uniform(5, (5, 6))]}, {}, "Out", ("X",)),
    ("log", "log", {"X": [_pos(6, (5, 6))]}, {}, "Out", ("X",)),
    ("ceil", "ceil", {"X": [uniform(7, (5, 6), -3, 3)]}, {}, "Out", ()),
    ("round_half_to_even", "round", {"X": [HALVES]}, {}, "Out", ()),
    ("reciprocal", "reciprocal", {"X": [_pos(8, (5, 6))]}, {}, "Out",
     ("X",)),
    ("cos", "cos", {"X": [uniform(9, (5, 6), -4, 4)]}, {}, "Out", ("X",)),
    ("sin", "sin", {"X": [uniform(10, (5, 6), -4, 4)]}, {}, "Out", ("X",)),
    ("reduce_mean_dim", "reduce_mean", {"X": [uniform(11, (3, 4, 5))]},
     {"dim": [1]}, "Out", ("X",)),
    ("reduce_mean_all_keep", "reduce_mean", {"X": [uniform(12, (3, 4, 5))]},
     {"reduce_all": True, "keep_dim": True}, "Out", ("X",)),
    ("reduce_mean_negative_dims", "reduce_mean",
     {"X": [uniform(13, (3, 4, 5))]}, {"dim": [-1, 0]}, "Out", ("X",)),
    ("reduce_min_ties", "reduce_min",
     {"X": [np.asarray([[1., 0., 0., 2.], [3., 3., 3., 4.]], np.float32)]},
     {"dim": [1]}, "Out", ("X",)),
    ("reduce_min_keep", "reduce_min", {"X": [uniform(14, (3, 4, 5))]},
     {"dim": [0, 2], "keep_dim": True}, "Out", ("X",)),
    ("reduce_prod_dim", "reduce_prod", {"X": [uniform(15, (3, 4, 5))]},
     {"dim": [2]}, "Out", ("X",)),
    ("reduce_prod_two_dims", "reduce_prod", {"X": [uniform(16, (3, 4, 5))]},
     {"dim": [0, 2]}, "Out", ("X",)),
    ("reduce_prod_all", "reduce_prod", {"X": [uniform(17, (2, 3))]},
     {"reduce_all": True}, "Out", ("X",)),
    ("split_sections", "split", {"X": [uniform(18, (3, 9))]},
     {"axis": 1, "sections": [2, 3, 4]}, "Out", ("X",)),
    ("split_num", "split", {"X": [uniform(19, (4, 6))]},
     {"axis": 0, "num": 2}, "Out", ("X",)),
    ("stack", "stack",
     {"X": [uniform(20, (3, 4)), uniform(21, (3, 4)), uniform(22, (3, 4))]},
     {"axis": 1}, "Out", ()),
    ("expand", "expand", {"X": [uniform(23, (2, 3))]},
     {"expand_times": [2, 3]}, "Out", ("X",)),
    ("expand_fewer_times", "expand", {"X": [uniform(24, (2, 3, 2))]},
     {"expand_times": [2, 1]}, "Out", ("X",)),
    ("pad", "pad", {"X": [uniform(25, (2, 3, 4))]},
     {"paddings": [0, 1, 2, 0, 1, 3], "pad_value": 0.5}, "Out", ("X",)),
    ("isfinite_true", "isfinite",
     {"X": [uniform(26, (3, 4)), uniform(27, (2,))]}, {}, "Out", ()),
    ("isfinite_inf", "isfinite",
     {"X": [uniform(28, (3, 4)),
            np.asarray([1.0, np.inf], np.float32)]}, {}, "Out", ()),
    ("isfinite_nan", "isfinite",
     {"X": [np.asarray([[np.nan, 1.0]], np.float32)]}, {}, "Out", ()),
    # -- tensor_ops ----------------------------------------------------
    ("gather", "gather",
     {"X": [uniform(30, (6, 4))],
      "Index": [np.asarray([4, 0, 4, 2], np.int32)]}, {}, "Out", ("X",)),
    ("gather_column_index", "gather",
     {"X": [uniform(31, (6, 2, 3))],
      "Index": [np.asarray([[5], [1], [1]], np.int64)]}, {}, "Out", ("X",)),
    ("scatter_distinct", "scatter",
     {"X": [uniform(32, (6, 4))], "Ids": [np.asarray([4, 0, 2], np.int32)],
      "Updates": [uniform(33, (3, 4))]}, {}, "Out", ("X", "Updates")),
    ("cumsum", "cumsum", {"X": [uniform(34, (3, 5))]}, {"axis": 1}, "Out",
     ("X",)),
    ("cumsum_reverse", "cumsum", {"X": [uniform(35, (3, 5))]},
     {"axis": 1, "reverse": True}, "Out", ("X",)),
    ("cumsum_exclusive", "cumsum", {"X": [uniform(36, (3, 5))]},
     {"axis": 0, "exclusive": True}, "Out", ("X",)),
    ("cumsum_reverse_exclusive", "cumsum", {"X": [uniform(37, (4, 6))]},
     {"axis": -1, "reverse": True, "exclusive": True}, "Out", ("X",)),
    ("range_int64", "range", {}, {"start": 2, "end": 17, "step": 3},
     "Out", ()),
    ("range_float32", "range", {},
     {"start": 0.5, "end": 3.0, "step": 0.25, "dtype": "float32"}, "Out",
     ()),
    ("multiplex", "multiplex",
     {"X": [uniform(38, (4, 3)), uniform(39, (4, 3)), uniform(40, (4, 3))],
      "Ids": [np.asarray([[2], [0], [1], [2]], np.int32)]}, {}, "Out",
     ()),
    # -- misc_ops ------------------------------------------------------
    ("hard_shrink", "hard_shrink", {"X": [uniform(41, (4, 5), -2, 2)]},
     {"threshold": 0.7}, "Out", ("X",)),
    ("tanh_shrink", "tanh_shrink", {"X": [uniform(42, (4, 5), -2, 2)]},
     {}, "Out", ("X",)),
    ("soft_relu_at_threshold", "soft_relu",
     {"X": [np.asarray([[-5.0, -2.0, 0.3, 2.0, 5.0]], np.float32)]},
     {"threshold": 2.0}, "Out", ("X",)),
    ("prelu_all", "prelu",
     {"X": [uniform(43, (2, 3, 4))], "Alpha": [np.asarray([0.2],
                                                           np.float32)]},
     {"mode": "all"}, "Out", ("X", "Alpha")),
    ("prelu_channel", "prelu",
     {"X": [uniform(44, (2, 3, 4, 2))], "Alpha": [uniform(45, (3,))]},
     {"mode": "channel"}, "Out", ("X", "Alpha")),
    ("prelu_element", "prelu",
     {"X": [uniform(46, (2, 3, 4))], "Alpha": [uniform(47, (2, 3, 4))]},
     {"mode": "element"}, "Out", ("X", "Alpha")),
    ("minus", "minus", {"X": [uniform(48, (3, 4))],
                        "Y": [uniform(49, (3, 4))]}, {}, "Out", ("X", "Y")),
    ("log_loss", "log_loss",
     {"Predicted": [uniform(50, (6, 1), 0.05, 0.95)],
      "Labels": [(_rs(51).rand(6, 1) > 0.5).astype(np.float32)]},
     {"epsilon": 1e-4}, "Loss", ("Predicted",)),
    ("margin_rank_loss", "margin_rank_loss",
     {"X1": [uniform(52, (6, 1))], "X2": [uniform(53, (6, 1))],
      "Label": [np.sign(uniform(54, (6, 1))).astype(np.float32)]},
     {"margin": 0.1}, "Out", ("X1", "X2")),
    ("modified_huber_loss", "modified_huber_loss",
     {"X": [uniform(55, (8, 1), -3, 3)],
      "Y": [(_rs(56).rand(8, 1) > 0.5).astype(np.float32)]}, {}, "Out",
     ("X",)),
    ("squared_l2_distance", "squared_l2_distance",
     {"X": [uniform(57, (4, 3, 2))], "Y": [uniform(58, (4, 3, 2))]}, {},
     "Out", ("X", "Y")),
    ("squared_l2_distance_broadcast", "squared_l2_distance",
     {"X": [uniform(59, (4, 5))], "Y": [uniform(60, (1, 5))]}, {}, "Out",
     ("X", "Y")),
    ("l1_norm", "l1_norm", {"X": [uniform(61, (4, 5))]}, {}, "Out", ("X",)),
    ("squared_l2_norm", "squared_l2_norm", {"X": [uniform(62, (4, 5))]},
     {}, "Out", ("X",)),
    ("label_smooth", "label_smooth",
     {"X": [np.eye(5, dtype=np.float32)[[1, 3, 0]]]}, {"epsilon": 0.1},
     "Out", ("X",)),
    ("label_smooth_prior", "label_smooth",
     {"X": [np.eye(4, dtype=np.float32)[[1, 3]]],
      "PriorDist": [np.asarray([[0.1, 0.2, 0.3, 0.4]], np.float32)]},
     {"epsilon": 0.2}, "Out", ("X", "PriorDist")),
    ("assign_value_fp32", "assign_value", {},
     {"shape": [2, 3], "fp32_values": [0.5, 1, 2, 3, 4, -1.25]}, "Out", ()),
    ("assign_value_int32", "assign_value", {},
     {"shape": [3], "int32_values": [7, -2, 5]}, "Out", ()),
    ("fill", "fill", {},
     {"shape": [2, 2], "value": [1.5, 2.5, 3.5, 4.5], "dtype": "float32"},
     "Out", ()),
    ("fill_int64", "fill", {},
     {"shape": [3], "value": [1, 2, 3], "dtype": "int64"}, "Out", ()),
    ("bilinear_tensor_product", "bilinear_tensor_product",
     {"X": [uniform(63, (4, 3))], "Y": [uniform(64, (4, 5))],
      "Weight": [uniform(65, (2, 3, 5))], "Bias": [uniform(66, (1, 2))]},
     {}, "Out", ("X", "Y", "Weight", "Bias")),
    ("bilinear_tensor_product_no_bias", "bilinear_tensor_product",
     {"X": [uniform(67, (3, 2))], "Y": [uniform(68, (3, 4))],
      "Weight": [uniform(69, (5, 2, 4))]}, {}, "Out", ("X", "Y", "Weight")),
    ("conv_shift", "conv_shift",
     {"X": [uniform(70, (3, 7))], "Y": [uniform(71, (3, 3))]}, {}, "Out",
     ("X", "Y")),
    ("sampling_id_one_hot", "sampling_id",
     {"X": [np.eye(6, dtype=np.float32)[[3, 0, 5, 5, 1]]]}, {}, "Out", ()),
    # -- vision_ops ----------------------------------------------------
    ("conv3d", "conv3d",
     {"Input": [uniform(80, (2, 2, 4, 5, 4))],
      "Filter": [uniform(81, (3, 2, 2, 3, 2), -0.5, 0.5)]},
     {"strides": [1, 2, 1], "paddings": [1, 1, 0]}, "Output",
     ("Input", "Filter")),
    ("conv3d_groups_dilation", "conv3d",
     {"Input": [uniform(82, (1, 4, 6, 6, 6))],
      "Filter": [uniform(83, (4, 2, 2, 2, 2), -0.5, 0.5)]},
     {"groups": 2, "dilations": [2, 1, 2]}, "Output", ("Input", "Filter")),
    ("conv3d_transpose", "conv3d_transpose",
     {"Input": [uniform(84, (2, 3, 3, 3, 3))],
      "Filter": [uniform(85, (3, 2, 2, 2, 2), -0.5, 0.5)]},
     {"strides": [2, 2, 2]}, "Output", ("Input", "Filter")),
    ("conv3d_transpose_padded_dilated", "conv3d_transpose",
     {"Input": [uniform(86, (1, 2, 4, 3, 4))],
      "Filter": [uniform(87, (2, 3, 3, 3, 3), -0.5, 0.5)]},
     {"strides": [2, 1, 2], "paddings": [1, 1, 0], "dilations": [1, 2, 1]},
     "Output", ("Input", "Filter")),
    ("pool3d_max", "pool3d", {"X": [uniform(88, (2, 2, 4, 6, 5))]},
     {"pooling_type": "max", "ksize": [2, 3, 2], "strides": [2, 2, 1],
      "paddings": [0, 1, 1]}, "Out", ("X",)),
    ("pool3d_avg_exclusive", "pool3d", {"X": [uniform(89, (2, 2, 4, 4, 4))]},
     {"pooling_type": "avg", "ksize": [3, 3, 3], "strides": [2, 2, 2],
      "paddings": [1, 1, 1]}, "Out", ("X",)),
    ("pool3d_avg_inclusive", "pool3d", {"X": [uniform(90, (1, 2, 4, 4, 4))]},
     {"pooling_type": "avg", "ksize": [2, 2, 2], "paddings": [1, 0, 1],
      "exclusive": False}, "Out", ("X",)),
    ("pool3d_global", "pool3d", {"X": [uniform(91, (2, 3, 3, 4, 5))]},
     {"pooling_type": "max", "global_pooling": True}, "Out", ("X",)),
    ("max_pool2d_with_index", "max_pool2d_with_index",
     {"X": [uniform(92, (2, 3, 6, 7))]},
     {"ksize": [3, 2], "strides": [2, 2], "paddings": [1, 1]}, "Out",
     ("X",)),
    ("max_pool2d_with_index_ties", "max_pool2d_with_index",
     {"X": [np.maximum(uniform(93, (2, 2, 6, 6)), 0.0)]},
     {"ksize": [2, 2], "strides": [2, 2]}, "Out", ("X",)),
    ("max_pool2d_with_index_overlap_ties", "max_pool2d_with_index",
     {"X": [np.round(uniform(94, (1, 2, 7, 7), 0, 2))]},
     {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}, "Out",
     ("X",)),
    ("max_pool3d_with_index", "max_pool3d_with_index",
     {"X": [uniform(95, (2, 2, 4, 5, 4))]},
     {"ksize": [2, 2, 2], "strides": [2, 2, 2], "paddings": [0, 1, 0]},
     "Out", ("X",)),
    ("max_pool3d_with_index_ties", "max_pool3d_with_index",
     {"X": [np.maximum(uniform(96, (1, 2, 4, 4, 4)), 0.0)]},
     {"ksize": [2, 2, 2]}, "Out", ("X",)),
    ("spp_max", "spp", {"X": [uniform(97, (2, 3, 7, 9))]},
     {"pyramid_height": 3, "pooling_type": "max"}, "Out", ("X",)),
    ("spp_max_ties", "spp", {"X": [np.maximum(uniform(98, (1, 2, 5, 6)),
                                              0.0)]},
     {"pyramid_height": 3, "pooling_type": "max"}, "Out", ("X",)),
    ("spp_avg", "spp", {"X": [uniform(99, (2, 2, 6, 5))]},
     {"pyramid_height": 2, "pooling_type": "avg"}, "Out", ("X",)),
    ("crop_shape", "crop", {"X": [uniform(100, (2, 3, 6, 7))]},
     {"shape": [4, 3], "offsets": [1, 2]}, "Out", ("X",)),
    ("crop_y", "crop", {"X": [uniform(101, (3, 6, 5))],
                        "Y": [np.zeros((2, 4, 3), np.float32)]},
     {"offsets": [1, 1, 2]}, "Out", ("X",)),
    ("norm", "norm", {"X": [uniform(102, (2, 4, 3, 5))],
                      "Scale": [uniform(103, (4,), 0.5, 2)]},
     {"epsilon": 1e-10}, "Out", ("X", "Scale")),
    ("bilinear_interp_up", "bilinear_interp",
     {"X": [uniform(104, (2, 3, 4, 5))]}, {"out_h": 7, "out_w": 11}, "Out",
     ("X",)),
    ("bilinear_interp_down", "bilinear_interp",
     {"X": [uniform(105, (1, 2, 9, 8))]}, {"out_h": 4, "out_w": 1}, "Out",
     ("X",)),
    ("rotate", "rotate", {"X": [uniform(106, (2, 3, 4, 5))]}, {}, "Out",
     ("X",)),
    ("scale_sub_region", "scale_sub_region",
     {"X": [uniform(107, (2, 3, 4, 5))],
      "Indices": [np.asarray([[1, 2, 2, 3, 1, 5], [3, 3, 1, 4, 2, 2]],
                             np.int32)]}, {"value": 2.5}, "Out", ("X",)),
    ("dynamic_conv2d", "dynamic_conv2d",
     {"X": [uniform(108, (3, 2, 6, 5))],
      "Filter": [uniform(109, (3, 4 * 2 * 3 * 2), -0.5, 0.5)]},
     {"num_filters": 4, "num_channels": 2, "kh": 3, "kw": 2, "sh": 2,
      "sw": 1, "ph": 1, "pw": 0}, "Out", ("X", "Filter")),
    # -- ctc_ops: the sampled losses -----------------------------------
    ("nce_custom_samples", "nce",
     {"Input": [uniform(110, (5, 8))],
      "Label": [_rs(111).randint(0, 20, (5, 1)).astype(np.int64)],
      "Weight": [uniform(112, (20, 8), -0.3, 0.3)],
      "Bias": [uniform(113, (20,), -0.1, 0.1)],
      "CustomSamples": [_rs(114).randint(0, 20, (5, 6)).astype(np.int64)]},
     {"num_total_classes": 20, "num_neg_samples": 6}, "Cost",
     ("Input", "Weight", "Bias")),
    ("nce_custom_samples_two_true_weighted", "nce",
     {"Input": [uniform(115, (4, 6))],
      "Label": [_rs(116).randint(0, 11, (4, 2)).astype(np.int32)],
      "Weight": [uniform(117, (11, 6), -0.3, 0.3)],
      "SampleWeight": [uniform(118, (4,), 0.5, 1.5)],
      "CustomSamples": [_rs(119).randint(0, 11, (4, 3)).astype(np.int32)]},
     {"num_total_classes": 11, "num_neg_samples": 3}, "Cost",
     ("Input", "Weight")),
    ("hsigmoid", "hsigmoid",
     {"X": [uniform(120, (6, 5))],
      "Label": [np.asarray([0, 1, 6, 3, 5, 2], np.int64)[:, None]],
      "W": [uniform(121, (6, 5), -0.5, 0.5)],
      "Bias": [uniform(122, (6,), -0.1, 0.1)]}, {"num_classes": 7}, "Cost",
     ("X", "W", "Bias")),
    ("hsigmoid_power_of_two_no_bias", "hsigmoid",
     {"X": [uniform(123, (5, 4))],
      "Label": [np.asarray([0, 7, 3, 4, 7], np.int32)],
      "W": [uniform(124, (7, 4), -0.5, 0.5)]}, {"num_classes": 8}, "Cost",
     ("X", "W")),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax_lowering(case):
    _, op, ins, attrs, out, grad = case
    _case(op, ins, attrs, out=out, grad=grad)


@pytest.mark.parametrize("op,ins,attrs", [
    ("stack", {"X": [uniform(140, (3, 4)), uniform(141, (3, 4)),
                     uniform(142, (3, 4))]}, {"axis": 1}),
    ("multiplex", {"X": [uniform(143, (4, 3)), uniform(144, (4, 3)),
                         uniform(145, (4, 3))],
                   "Ids": [np.asarray([[2], [0], [1], [2]], np.int32)]}, {}),
], ids=["stack", "multiplex"])
def test_gradients_of_every_input_of_a_list_slot(op, ins, attrs):
    """The gradient of each X of a multi-input slot (run_both replaces a
    slot by its first input)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops import registry as jreg
    xs = ins["X"]
    cot = _rs(146).randn(*run_both(op, ins, attrs)[1]["Out"][0].shape) \
        .astype(np.float32)
    rest = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()
            if k != "X"}

    def jf(*vals):
        return jreg.get_op(op).lowering(None, {**rest, "X": list(vals)},
                                        dict(attrs))["Out"][0]

    _, vjp = jax.vjp(jf, *[jnp.asarray(x) for x in xs])
    jg = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in xs]
    prest = {k: [torch.from_numpy(np.asarray(v)) for v in vs]
             for k, vs in ins.items() if k != "X"}
    out = preg.get_op(op).lowering(None, {**prest, "X": leaves},
                                   dict(attrs))["Out"][0]
    pg = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    check_grads(jg, [g.detach() for g in pg])


def test_round_is_half_to_even():
    _, pout, _, _ = _case("round", {"X": [HALVES]})
    np.testing.assert_array_equal(pout["Out"][0][0].numpy(),
                                  [-2., -2., -0., 0.])
    np.testing.assert_array_equal(pout["Out"][0][1].numpy(),
                                  [2., 2., 4., -4.])


def test_reduce_min_gradient_splits_among_ties():
    x = np.asarray([[1., 0., 0., 2.], [3., 3., 3., 4.]], np.float32)
    _, _, jg, pg = _case("reduce_min", {"X": [x]}, {"dim": [1]},
                         grad=("X",), cot=np.ones((2,), np.float32))
    np.testing.assert_array_equal(pg[0].numpy(), np.asarray(jg[0]))
    np.testing.assert_allclose(pg[0].numpy(),
                               [[0, .5, .5, 0], [1 / 3, 1 / 3, 1 / 3, 0]],
                               rtol=1e-6)


def test_cumsum_reverse_and_exclusive_follow_the_reference_formulas():
    """reverse flips around the cumsum and exclusive is out - x, bit for
    bit within the port (a shifted scan would round otherwise), and
    within 1e-5 of the JAX package's over a long axis."""
    x = uniform(130, (3, 256))
    xt = torch.from_numpy(x)
    low = preg.get_op("cumsum").lowering
    inc = low(None, {"X": [xt]}, {"axis": 1})["Out"][0]
    rev = low(None, {"X": [xt]}, {"axis": 1, "reverse": True})["Out"][0]
    exc = low(None, {"X": [xt]}, {"axis": 1, "exclusive": True})["Out"][0]
    rex = low(None, {"X": [xt]}, {"axis": 1, "reverse": True,
                                  "exclusive": True})["Out"][0]
    assert torch.equal(rev, torch.flip(torch.cumsum(torch.flip(xt, (1,)),
                                                    1), (1,)))
    assert torch.equal(exc, inc - xt)
    assert torch.equal(rex, rev - xt)
    for attrs in ({"axis": 1, "reverse": True},
                  {"axis": 1, "exclusive": True},
                  {"axis": 1, "reverse": True, "exclusive": True}):
        jout, pout, _, _ = run_both("cumsum", {"X": [x]}, attrs)
        check_outputs(jout, pout)


@pytest.mark.parametrize("op", ["max_pool2d_with_index",
                                "max_pool3d_with_index"])
def test_with_index_pool_splits_the_gradient_among_tied_maxima(op):
    """A window of four equal values gives each a quarter (jnp.max's
    rule, C33), and Mask is the first of them in window order."""
    nd = 2 if op.startswith("max_pool2d") else 3
    x = np.zeros((1, 1) + (4,) * nd, np.float32)
    x[(0, 0) + (slice(0, 2),) * nd] = 1.0
    attrs = {"ksize": [2] * nd, "strides": [2] * nd}
    cot = np.ones((1, 1) + (2,) * nd, np.float32)
    _, pout, jg, pg = _case(op, {"X": [x]}, attrs, grad=("X",), cot=cot)
    g = pg[0].numpy()
    np.testing.assert_array_equal(g, np.asarray(jg[0]))
    window = 2 ** nd
    assert np.allclose(g[(0, 0) + (slice(0, 2),) * nd], 1.0 / window)
    assert pout["Mask"][0].reshape(-1)[0].item() == 0
    # F.max_pool's index rule would give the whole gradient to one cell
    assert np.count_nonzero(g[(0, 0) + (slice(0, 2),) * nd]) == window


def test_unpool_after_pool_matches_jax():
    x = uniform(131, (2, 3, 6, 8))
    attrs = {"ksize": [2, 2], "strides": [2, 2]}
    jout, pout, _, _ = run_both("max_pool2d_with_index", {"X": [x]}, attrs)
    mask = pout["Mask"][0].numpy()
    np.testing.assert_array_equal(mask, np.asarray(jout["Mask"][0]))
    pooled = pout["Out"][0].numpy()
    _case("unpool", {"X": [pooled], "Indices": [mask]}, attrs,
          grad=("X",))


def test_unpool_overlapping_windows_matches_jax():
    x = uniform(132, (1, 2, 7, 7))
    attrs = {"ksize": [3, 3], "strides": [2, 2]}
    _, pout, _, _ = run_both("max_pool2d_with_index", {"X": [x]}, attrs)
    _case("unpool", {"X": [pout["Out"][0].numpy()],
                     "Indices": [pout["Mask"][0].numpy()]}, attrs,
          grad=("X",))


def test_lambda_rank_cost_matches_jax():
    rs = _rs(133)
    B, T = 4, 7
    score = rs.randn(B, T).astype(np.float32)
    label = rs.randint(0, 4, (B, T)).astype(np.float32)
    lens = np.asarray([7, 5, 3, 1], np.int32)
    for mss in (-1, 3):
        _case("lambda_rank_cost",
              {"Score": [score], "Label": [label], "SeqLen": [lens]},
              {"NDCG_num": 3, "max_sort_size": mss}, grad=("Score",))


def test_where_raises_as_the_reference_does():
    x = np.ones((3,), np.float32)
    with pytest.raises(NotImplementedError):
        run_both("where", {"Condition": [x > 0]})
    with pytest.raises(NotImplementedError):
        preg.get_op("where").lowering(None, {"Condition": [
            torch.ones(3, dtype=torch.bool)]}, {})


def test_scatter_duplicate_ids_write_one_of_the_updates():
    """With duplicate ids either package may keep either update (C31):
    the row holds one of them, the other rows are X's."""
    x = uniform(134, (5, 3))
    upd = uniform(135, (3, 3))
    _, pout, _, _ = run_both("scatter", {
        "X": [x], "Ids": [np.asarray([1, 3, 1], np.int32)],
        "Updates": [upd]})
    out = pout["Out"][0].numpy()
    assert any(np.array_equal(out[1], upd[i]) for i in (0, 2))
    np.testing.assert_array_equal(out[3], upd[1])
    np.testing.assert_array_equal(out[[0, 2, 4]], x[[0, 2, 4]])


def test_print_passes_x_through_prints_and_counts(capsys):
    x = uniform(136, (2, 3))
    monitor.reset()
    monitor.set_enabled(True)
    try:
        jout, pout, _, _ = run_both("print", {"X": [x]},
                                    {"message": "probe", "summarize": 4})
        n = monitor.snapshot()["counters"].get("print.host_syncs")
    finally:
        monitor.set_enabled(False)
        monitor.reset()
    check_outputs(jout, pout)
    assert n == 1
    out = capsys.readouterr().out
    assert "probe shape=(2, 3)" in out
    _meta_matches("print", {"X": [x]}, {}, pout)


def _chi2_ok(counts, probs, n):
    """Pearson's chi-square statistic below the 0.999 quantile of its
    distribution (Wilson-Hilferty), for counts of n draws."""
    exp = n * np.asarray(probs)
    stat = float(np.sum((counts - exp) ** 2 / exp))
    k = len(probs) - 1
    z = 3.09
    q = k * (1 - 2 / (9 * k) + z * np.sqrt(2 / (9 * k))) ** 3
    return stat < q, stat, q


def test_nce_without_custom_samples_draws_uniform_negatives():
    """The negatives come from the executor's generator: in [0, V),
    uniform by chi-square, and the cost is the reference's formula on
    the ids drawn (recomputed with them as CustomSamples)."""
    V, k, B = 13, 10, 400
    ins = {"Input": [uniform(137, (B, 4))],
           "Label": [_rs(138).randint(0, V, (B, 1)).astype(np.int64)],
           "Weight": [uniform(139, (V, 4), -0.3, 0.3)]}
    attrs = {"num_total_classes": V, "num_neg_samples": k}
    drawn = []
    real_randint = torch.randint

    def spy(*a, **kw):
        out = real_randint(*a, **kw)
        drawn.append(out.clone())
        return out

    class Ctx:
        device = torch.device("cpu")
        generator = torch.Generator().manual_seed(5)

    pins = {s: [torch.from_numpy(v[0])] for s, v in ins.items()}
    torch.randint = spy
    try:
        cost = preg.get_op("nce").lowering(Ctx(), pins, attrs)["Cost"][0]
    finally:
        torch.randint = real_randint
    neg = drawn[0].numpy()
    assert neg.shape == (B, k) and neg.min() >= 0 and neg.max() < V
    ok, stat, q = _chi2_ok(np.bincount(neg.reshape(-1), minlength=V),
                           [1.0 / V] * V, neg.size)
    assert ok, (stat, q)
    jout, _, _, _ = run_both("nce", {**ins, "CustomSamples": [neg]}, attrs)
    np.testing.assert_allclose(cost.numpy(), np.asarray(jout["Cost"][0]),
                               rtol=0, atol=1e-5)


def test_sampling_id_draws_follow_the_row_distribution():
    p = np.asarray([0.05, 0.15, 0.3, 0.5], np.float32)
    n = 20000

    class Ctx:
        device = torch.device("cpu")
        generator = torch.Generator().manual_seed(7)

    ids = preg.get_op("sampling_id").lowering(
        Ctx(), {"X": [torch.from_numpy(np.tile(p, (n, 1)))]}, {})["Out"][0]
    assert ids.dtype == torch.int64
    ok, stat, q = _chi2_ok(np.bincount(ids.numpy(), minlength=4), p, n)
    assert ok, (stat, q)


def test_random_ops_take_the_executor_generator():
    """Two contexts on generators with the same seed draw the same ids;
    another seed draws others."""
    def draw(seed):
        class Ctx:
            device = torch.device("cpu")
            generator = torch.Generator().manual_seed(seed)
        x = torch.full((50, 6), 1.0 / 6)
        return preg.get_op("sampling_id").lowering(Ctx(), {"X": [x]},
                                                   {})["Out"][0]
    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))
