"""The port's sequence lowerings (paddle_tpu_torch/ops/sequence_ops.py)
against the JAX package's (paddle_tpu/ops/sequence_ops.py) on the CPU.

Every case hands both lowerings the same seeded numpy inputs, with
ragged lengths that include a full row and a zero-length row, and
compares every output slot; then the gradients of the primary output
with respect to the float inputs (`jax.vjp` against
`torch.autograd.grad`, one seeded cotangent). Level-2 (nested) inputs
go through sequence_pool, the first / last step ops, sub_nested_seq,
seq_slice and kmax_seq_score. The golden inputs of
tests/test_sequence_op_suite.py and tests/test_nested_lod.py are reused
where they exist.

Tolerances (tests/torch_parity_helpers.py): 1e-5 absolute on float32
forward values, 1e-4 of the largest reference element on gradients;
integer outputs exact. The tie cases compare exactly: MAX pooling
splits its gradient equally among tied maxima, as JAX's reduce-max.
"""

import re

import numpy as np
import pytest

from paddle_tpu_torch.ops import registry as preg
from paddle_tpu.ops import registry as jreg
from torch_parity_helpers import (check_grads, check_outputs, lengths,
                                  run_both, uniform)
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, T, D = 4, 6, 3


def _ragged(seed, shape, lens):
    """Values with the padded tail zeroed (as the DataFeeder pads)."""
    x = uniform(seed, shape)
    t = np.arange(shape[1])[None, :] < lens[:, None]
    return x * t.reshape(t.shape + (1,) * (len(shape) - 2))


def test_every_reference_sequence_op_is_registered():
    import paddle_tpu.ops.sequence_ops as ref
    names = set(re.findall(r'register_op\("(\w+)"', open(ref.__file__).read()))
    assert len(names) == 19
    for n in names:
        assert preg.has_op(n), n
        assert preg.get_op(n).differentiable == jreg.get_op(n).differentiable


POOLS = ["SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"]


@pytest.mark.parametrize("ptype", POOLS)
def test_sequence_pool_level1(ptype):
    lens = lengths(1, B, T)
    x = uniform(2, (B, T, D))
    jout, pout, jg, pg = run_both("sequence_pool",
                                  {"X": [x], "SeqLen": [lens]},
                                  {"pooltype": ptype}, grad=("X",))
    check_outputs(jout, pout)
    check_grads(jg, pg)


@pytest.mark.parametrize("ptype", POOLS)
def test_sequence_pool_level2_pools_the_inner_axis(ptype):
    """Nested [B, S, T, D] with inner lengths [B, S] (zeros where an
    example has fewer sub-sequences) pools to [B, S, D]."""
    S = 3
    inner = np.random.RandomState(3).randint(0, T + 1, (B, S)).astype(
        np.int32)
    inner[0] = T
    x = uniform(4, (B, S, T, D))
    jout, pout, jg, pg = run_both("sequence_pool",
                                  {"X": [x], "SeqLen": [inner]},
                                  {"pooltype": ptype}, grad=("X",))
    check_outputs(jout, pout)
    check_grads(jg, pg)


def test_max_pool_gradient_splits_among_ties():
    """[1, 3, 3, 2] -> gradient [0, .5, .5, 0] in both packages (JAX's
    reduce-max rule; torch.max(x, dim) would give one index all of it);
    the masked tail (len 4 of 6) gets nothing even when it holds the
    largest value."""
    x = np.array([[1, 3, 3, 2, 9, 9]], np.float32)[..., None]
    lens = np.array([4], np.int32)
    cot = np.ones((1, 1), np.float32)
    jout, pout, jg, pg = run_both("sequence_pool",
                                  {"X": [x], "SeqLen": [lens]},
                                  {"pooltype": "MAX"}, grad=("X",), cot=cot)
    check_outputs(jout, pout)
    want = np.array([0, .5, .5, 0, 0, 0], np.float32)[None, :, None]
    np.testing.assert_array_equal(np.asarray(jg[0]), want)
    np.testing.assert_array_equal(pg[0].numpy(), want)


def test_zero_length_rows_average_over_one_and_take_step_zero():
    x = uniform(5, (2, 4, 2))
    lens = np.array([0, 2], np.int32)
    for ptype in ("AVERAGE", "LAST"):
        jout, pout, _, _ = run_both("sequence_pool",
                                    {"X": [x], "SeqLen": [lens]},
                                    {"pooltype": ptype})
        check_outputs(jout, pout)
    np.testing.assert_array_equal(pout["Out"][0][0].numpy(), x[0, 0])


@pytest.mark.parametrize("trailing", [False, True], ids=["BT", "BT1"])
def test_sequence_softmax(trailing):
    lens = lengths(6, B, T)
    x = uniform(7, (B, T, 1) if trailing else (B, T), -3, 3)
    jout, pout, jg, pg = run_both("sequence_softmax",
                                  {"X": [x], "SeqLen": [lens]}, grad=("X",))
    check_outputs(jout, pout)
    check_grads(jg, pg)


def test_sequence_expand_concat_reshape_slice_scale():
    y = uniform(9, (B, T, D))
    jout, pout, jg, pg = run_both("sequence_expand",
                                  {"X": [uniform(10, (B, D))], "Y": [y]},
                                  grad=("X",))
    check_outputs(jout, pout)
    check_grads(jg, pg)
    a, b = uniform(11, (B, T, D)), uniform(12, (B, T, 2))
    jout, pout, jg, pg = run_both("sequence_concat", {"X": [a, b]})
    check_outputs(jout, pout)
    jout, pout, _, _ = run_both("sequence_concat",
                                {"X": [a[..., 0], b[..., 0]]})
    check_outputs(jout, pout)
    jout, pout, jg, pg = run_both("sequence_reshape",
                                  {"X": [uniform(13, (B, 4, 6))]},
                                  {"new_dim": 8}, grad=("X",))
    check_outputs(jout, pout)
    check_grads(jg, pg)
    jout, pout, jg, pg = run_both("sequence_slice", {"X": [y]},
                                  {"offset": 1, "length": 3}, grad=("X",))
    check_outputs(jout, pout)
    check_grads(jg, pg)
    jout, pout, jg, pg = run_both(
        "sequence_scale", {"X": [y], "Scale": [uniform(14, (B,))]},
        grad=("X", "Scale"))
    check_outputs(jout, pout)
    check_grads(jg, pg)


@pytest.mark.parametrize("ctx_len,ctx_start", [(3, -1), (4, -2), (2, 0)])
def test_sequence_conv(ctx_len, ctx_start):
    lens = lengths(15, B, T)
    x = _ragged(16, (B, T, D), lens)
    w = uniform(17, (ctx_len * D, 5))
    jout, pout, jg, pg = run_both(
        "sequence_conv", {"X": [x], "Filter": [w], "SeqLen": [lens]},
        {"contextLength": ctx_len, "contextStart": ctx_start},
        grad=("X", "Filter"))
    check_outputs(jout, pout)
    check_grads(jg, pg)


def test_first_and_last_step_level1():
    lens = lengths(18, B, T)
    x = uniform(19, (B, T, D))
    for op in ("sequence_first_step", "sequence_last_step"):
        jout, pout, jg, pg = run_both(op, {"X": [x], "SeqLen": [lens]},
                                      grad=("X",))
        check_outputs(jout, pout)
        check_grads(jg, pg)


@pytest.mark.parametrize("inner_level", [False, True], ids=["top", "inner"])
def test_first_and_last_step_level2(inner_level):
    S = 3
    outer = np.array([3, 1, 2, 0], np.int32)
    sub = np.array([[2, 5, 1], [4, 0, 0], [1, 6, 0], [0, 0, 0]], np.int32)
    x = uniform(20, (B, S, T, D))
    attrs = {"inner_level": True} if inner_level else {}
    for op in ("sequence_first_step", "sequence_last_step"):
        jout, pout, jg, pg = run_both(
            op, {"X": [x], "SeqLen": [outer], "SubSeqLen": [sub]}, attrs,
            grad=("X",))
        check_outputs(jout, pout)
        check_grads(jg, pg)


def test_sequence_mask_and_max_len():
    lens = lengths(21, B, T)
    x = uniform(22, (B, T, 1))
    for attrs in ({}, {"dtype": "int64"}, {"dtype": "bool"}):
        jout, pout, _, _ = run_both("sequence_mask",
                                    {"X": [x], "SeqLen": [lens]}, attrs)
        check_outputs(jout, pout)
        assert str(pout["Out"][0].dtype).endswith(
            attrs.get("dtype", "float32"))
    jout, pout, _, _ = run_both("sequence_mask", {"SeqLen": [lens]},
                                {"maxlen": 9})
    check_outputs(jout, pout)
    jout, pout, _, _ = run_both("max_sequence_len",
                                {"X": [x], "SeqLen": [lens]})
    check_outputs(jout, pout)


def test_sequence_erase_golden_and_random():
    # tests/test_sequence_op_suite.py's golden case
    x = np.asarray([[2, 1, 3, 1, 5, 0], [1, 2, 2, 0, 0, 0]], np.int64)
    lens = np.asarray([5, 3], np.int32)
    jout, pout, _, _ = run_both("sequence_erase",
                                {"X": [x], "SeqLen": [lens]},
                                {"tokens": [1]})
    check_outputs(jout, pout)
    np.testing.assert_array_equal(pout["Out"][0].numpy(),
                                  [[2, 3, 5, 0, 0, 0], [2, 2, 0, 0, 0, 0]])
    x = np.random.RandomState(23).randint(0, 5, (B, 8)).astype(np.int64)
    jout, pout, _, _ = run_both("sequence_erase",
                                {"X": [x], "SeqLen": [lengths(24, B, 8)]},
                                {"tokens": [0, 3]})
    check_outputs(jout, pout)


@pytest.mark.parametrize("normalized", [True, False])
def test_edit_distance(normalized):
    rng = np.random.RandomState(25)
    hyp = rng.randint(0, 4, (B, 5, 1)).astype(np.int64)
    ref = rng.randint(0, 4, (B, 4, 1)).astype(np.int64)
    hl = np.array([5, 3, 0, 2], np.int32)
    rl = np.array([4, 4, 2, 0], np.int32)
    jout, pout, _, _ = run_both(
        "edit_distance", {"Hyps": [hyp], "HypsLen": [hl], "Refs": [ref],
                          "RefsLen": [rl]}, {"normalized": normalized})
    check_outputs(jout, pout)


@pytest.mark.parametrize("with_len", [True, False])
def test_row_conv(with_len):
    lens = lengths(26, B, T)
    ins = {"X": [uniform(27, (B, T, D))], "Filter": [uniform(28, (3, D))]}
    if with_len:
        ins["SeqLen"] = [lens]
    jout, pout, jg, pg = run_both("row_conv", ins, grad=("X", "Filter"))
    check_outputs(jout, pout)
    check_grads(jg, pg)


def test_nested_expand_sub_nested_seq_and_seq_slice():
    S = 3
    inner = np.array([[2, 5, 1], [4, 0, 0], [1, 6, 3], [0, 0, 0]], np.int32)
    x = uniform(29, (B, S, T, D))
    jout, pout, jg, pg = run_both(
        "sequence_expand_nested",
        {"X": [uniform(30, (B, S, D))], "Ref": [x]}, grad=("X",))
    check_outputs(jout, pout)
    check_grads(jg, pg)
    ids = np.array([[2, 0], [0, -1], [-1, 1], [1, 2]], np.int64)
    jout, pout, jg, pg = run_both(
        "sub_nested_seq", {"X": [x], "InnerLens": [inner], "Ids": [ids]},
        grad=("X",))
    check_outputs(jout, pout)
    check_grads(jg, pg)
    # nested input, per-row and per-example index rows, ends past a
    # row's length
    starts = np.random.RandomState(31).randint(-1, 4, (B, S, 2))
    ends = starts + np.random.RandomState(32).randint(0, 4, (B, S, 2))
    ends[starts == -1] = -1
    for ins in ({"Starts": [starts], "Ends": [ends]},
                {"Starts": [starts[:, 0]]}, {"Ends": [ends[:, 1]]}):
        jout, pout, jg, pg = run_both(
            "seq_slice", dict({"X": [x], "InnerLens": [inner]}, **ins),
            grad=("X",))
        check_outputs(jout, pout)
        check_grads(jg, pg)
    # level-1 input
    lens = lengths(33, B, T)
    jout, pout, jg, pg = run_both(
        "seq_slice", {"X": [uniform(34, (B, T, D))], "InnerLens": [lens],
                      "Starts": [starts[:, 0]], "Ends": [ends[:, 0]]},
        grad=("X",))
    check_outputs(jout, pout)
    check_grads(jg, pg)


@pytest.mark.parametrize("nested", [False, True])
def test_kmax_seq_score_ties_take_the_lower_index(nested):
    """Scores with exact ties: the ids equal jax.lax.top_k's, which puts
    the lower index first among equal values; tail slots -1."""
    rng = np.random.RandomState(35)
    shape = (B, 3, T, 1) if nested else (B, T, 1)
    x = rng.randint(0, 3, shape).astype(np.float32)    # many ties
    lens = (np.random.RandomState(36).randint(0, T + 1, shape[:-2])
            .astype(np.int32))
    for k in (2, T + 2):
        jout, pout, _, _ = run_both("kmax_seq_score",
                                    {"X": [x], "Lens": [lens]},
                                    {"beam_size": k})
        check_outputs(jout, pout)
