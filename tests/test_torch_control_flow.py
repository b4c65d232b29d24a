"""Control flow in the port (While / IfElse / Switch / the tensor arrays)
against the JAX package, on the CPU.

The twin of each case of tests/test_control_flow.py: the same program is
built in both packages (their main Program dicts are equal, sub-blocks
included), run on the same feeds and parameters, and the fetches are
held to the JAX package's: integer and bool values exactly, float
values within 1e-6 relative (the while-RNN within 1e-5 relative and
1e-5 absolute, as the original). Also here:

  * the tensor-array index clamp: `lax.dynamic_index_in_dim` /
    `dynamic_update_index_in_dim` wrap a negative index once and clamp
    it into [0, max_len - 1]; the port does the same on the device
    (exact, indices -5 .. 9 on a capacity of 4);
  * the random-number semantics of the two loops: a `while` body draws
    afresh each iteration (both packages), while a dropout inside a
    `recurrent_group` step applies ONE mask at every time step (the
    reference traces the step once; the port replays the generator
    state each step);
  * gradients through an ifelse branch: its ops must run in the grad
    mode of the taped ifelse, or the gradient of the captured parameter
    would come back zero;
  * shape inference through sub-blocks on meta tensors, and the
    inference prune keeping a While's sub-block and loop vars;
  * the 26 ops of the control-flow, CTC and CRF slice are registered
    with the reference's flags, and the small tensor ops they need
    (shape, the comparisons and logical ops, fill_zeros_like,
    transpose, reduce_max, fill_constant_batch_size_like, is_empty,
    lod_reset) equal the JAX package's lowerings: values exactly,
    dtypes and shapes included.
"""

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import registry as preg
from torch_parity_helpers import run_both
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_programs():
    for P in (jpt, pt):
        P.framework.reset_default_programs()
    yield


def _cf(P):
    return P.layers.control_flow


def _run(P, fetch, feed=None, params=None, startup=True, program=None):
    exe, scope = P.Executor(P.CPUPlace()), P.Scope()
    if startup:
        exe.run(P.default_startup_program(), scope=scope)
    for k, v in (params or {}).items():
        scope.set(k, v)
    return exe.run(program or P.default_main_program(), feed=feed or {},
                   fetch_list=fetch, scope=scope)


def _both(build, feed=None, params=None, startup=True, rtol=RTOL, atol=0):
    """`build(P)` -> fetch list, in both packages; the main Program dicts
    are equal and every fetch agrees. Returns the port's fetches."""
    jpt.framework.reset_default_programs()
    jfetch = build(jpt)
    jdict = jpt.default_main_program().to_dict()
    jout = _run(jpt, jfetch, feed, params, startup)
    pt.framework.reset_default_programs()
    pfetch = build(pt)
    assert pt.default_main_program().to_dict() == jdict
    pout = _run(pt, pfetch, feed, params, startup)
    for j, p in zip(jout, pout):
        j, p = np.asarray(j), np.asarray(p)
        assert p.shape == j.shape and p.dtype == j.dtype, (p, j)
        if j.dtype.kind == "f":
            np.testing.assert_allclose(p, j, rtol=rtol, atol=atol)
        else:
            np.testing.assert_array_equal(p, j)
    return pout


def _counter_loop(P, n_iters, body, max_iters=0):
    """i = 0; while i < n: body(); i += 1. Returns i."""
    i = P.layers.fill_constant([1], "int64", 0)
    n = P.layers.fill_constant([1], "int64", n_iters)
    cond = P.layers.less_than(i, n)
    w = _cf(P).While(cond, max_iters=max_iters)
    with w.block():
        body()
        P.layers.increment(i)
        P.layers.less_than(i, n, cond=cond)
    return i


def test_while_accumulates():
    def build(P):
        s = P.layers.fill_constant([1], "float32", 0.0)
        box = {}

        def body():
            fi = P.layers.cast(box["i"], "float32")
            P.layers.assign(s + fi, output=s)

        i = P.layers.fill_constant([1], "int64", 0)
        box["i"] = i
        n = P.layers.fill_constant([1], "int64", 10)
        cond = P.layers.less_than(i, n)
        w = _cf(P).While(cond)
        with w.block():
            body()
            P.layers.increment(i)
            P.layers.less_than(i, n, cond=cond)
        return [s, i]

    s_v, i_v = _both(build, startup=False)
    assert float(s_v[0]) == sum(range(10)) and int(i_v[0]) == 10


def test_while_requires_cond_update():
    i = pt.layers.fill_constant([1], "int64", 0)
    n = pt.layers.fill_constant([1], "int64", 10)
    w = _cf(pt).While(pt.layers.less_than(i, n))
    with pytest.raises(ValueError, match="never updates"):
        with w.block():
            pt.layers.increment(i)


def test_while_reads_captured_parameter():
    def build(P):
        step = P.layers.fill_constant([1], "float32", 2.5)
        s = P.layers.fill_constant([1], "float32", 0.0)
        _counter_loop(P, 4, lambda: P.layers.assign(s + step, output=s))
        return [s]

    s_v, = _both(build, startup=False)
    np.testing.assert_allclose(s_v, [10.0], rtol=1e-6)
    # the captured var is declared in the op's X slot
    op = pt.default_main_program().global_block().ops[-1]
    assert op.type == "while" and op.attrs["x_names"] == op.inputs["X"]
    assert "fill_constant_0.tmp_0" in op.inputs["X"]


def test_while_with_rng_inside_body():
    def build(P):
        s = P.layers.fill_constant([1], "float32", 0.0)
        _counter_loop(P, 5, lambda: P.layers.assign(
            s + P.layers.uniform_random([1], min=1.0, max=1.0), output=s))
        return [s]

    s_v, = _both(build, startup=False)
    np.testing.assert_allclose(s_v, [5.0], rtol=1e-6)


def test_while_max_iters_guard():
    def build(P):
        return [_counter_loop(P, 1000000, lambda: None, max_iters=7)]

    i_v, = _both(build, startup=False)
    assert int(i_v[0]) == 7


def test_while_rnn_matches_scan_rnn():
    """A stepwise RNN built from While + array_read equals the fused
    simple_rnn op, in each package, and the port's equals the JAX
    package's on the same weight."""
    B, T, D = 4, 6, 8
    rng = np.random.RandomState(0)
    x_np = rng.randn(B, T, D).astype(np.float32)
    w_np = rng.uniform(-.3, .3, (D, D)).astype(np.float32)

    def build(P):
        x = P.layers.data(name="x", shape=[D], dtype="float32", lod_level=1)
        hidden = P.layers.simple_rnn(x, D, act="tanh",
                                     param_attr=P.ParamAttr(name="w_rnn"))
        w_param = P.default_main_program().global_block().var("w_rnn")
        x_tbd = P.layers.transpose(x, [1, 0, 2])
        h = P.layers.fill_constant([B, D], "float32", 0.0)

        def body():
            x_t = _cf(P).array_read(x_tbd, box["i"])
            h_new = P.layers.tanh(x_t + P.layers.matmul(h, w_param))
            P.layers.assign(h_new, output=h)

        box = {}
        i = P.layers.fill_constant([1], "int64", 0)
        box["i"] = i
        n = P.layers.fill_constant([1], "int64", T)
        cond = P.layers.less_than(i, n)
        w = _cf(P).While(cond)
        with w.block():
            body()
            P.layers.increment(i)
            P.layers.less_than(i, n, cond=cond)
        return [hidden, h]

    hid_v, h_v = _both(build, feed={"x": x_np,
                                    "x@SEQLEN": np.full([B], T, np.int32)},
                       params={"w_rnn": w_np}, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_v, hid_v[:, -1, :], rtol=1e-5, atol=1e-5)


def _ifelse_grad_program(P, N, D):
    p = P.layers.create_parameter(
        [N, D], "float32", name="p",
        default_initializer=P.initializer.ConstantInitializer(0.0))
    m = P.layers.data(name="m", shape=[1], dtype="bool")
    ie = _cf(P).IfElse(m)
    with ie.true_block():
        ie.output(ie.input(p) * 3.0)
    with ie.false_block():
        ie.output(ie.input(p) + 1.0)
    out, = ie()
    loss = P.layers.mean(out)
    (_param, grad), = P.backward.append_backward(loss)
    return [out, grad]


def test_ifelse_rowwise_merge_and_grad():
    """The gradient of the captured parameter reaches it through the
    taped ifelse's branch ops: run under no_grad, they would leave it
    zero."""
    N, D = 6, 3
    rng = np.random.RandomState(1)
    p_np = rng.randn(N, D).astype(np.float32)
    mask_np = rng.rand(N, 1) > 0.5
    out_v, g_v = _both(lambda P: _ifelse_grad_program(P, N, D),
                       feed={"m": mask_np}, params={"p": p_np})
    np.testing.assert_allclose(out_v, np.where(mask_np, p_np * 3.0,
                                               p_np + 1.0), rtol=1e-6)
    np.testing.assert_allclose(
        g_v, np.broadcast_to(np.where(mask_np, 3.0, 1.0) / (N * D), (N, D)),
        rtol=1e-6)


def test_ifelse_1d_output_mask_squeeze():
    N = 4
    mask_np = np.array([[True], [False], [True], [False]])
    x_np = np.arange(N * 2, dtype=np.float32).reshape(N, 2)

    def build(P):
        m = P.layers.data(name="m", shape=[1], dtype="bool")
        x = P.layers.data(name="x", shape=[2], dtype="float32")
        ie = _cf(P).IfElse(m)
        with ie.true_block():
            ie.output(P.layers.reduce_sum(x, dim=[1]))
        with ie.false_block():
            ie.output(P.layers.reduce_sum(x * 0.0, dim=[1]))
        return list(ie())

    out_v, = _both(build, feed={"m": mask_np, "x": x_np}, startup=False)
    assert out_v.shape == (N,)
    np.testing.assert_allclose(out_v, np.where(mask_np[:, 0],
                                               x_np.sum(1), 0.0))


def test_ifelse_dropout_in_branch_with_backward():
    """A dropout in a taped branch: its mask is drawn once in the
    forward, and the gradient replays that mask: with p = 1 the
    gradient of mean(out) is out / (N * D) on the true rows (0 where
    dropped) and 1 / (N * D) on the false rows."""
    N, D = 4, 3
    mask_np = np.array([[True], [True], [False], [False]])
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        m = P.layers.data(name="m", shape=[1], dtype="bool")
        p = P.layers.create_parameter(
            [N, D], "float32", name="p2",
            default_initializer=P.initializer.ConstantInitializer(1.0))
        ie = _cf(P).IfElse(m)
        with ie.true_block():
            ie.output(P.layers.dropout(p * 2.0, dropout_prob=0.5))
        with ie.false_block():
            ie.output(p * 1.0)
        out, = ie()
        loss = P.layers.mean(out)
        (_p, grad), = P.backward.append_backward(loss)
        out_v, g_v = _run(P, [out, grad], feed={"m": mask_np})
        np.testing.assert_array_equal(out_v[2:], 1.0)
        assert 0 < (out_v[:2] == 0).sum() < 2 * D
        np.testing.assert_allclose(g_v[:2], out_v[:2] / (N * D), rtol=1e-6)
        np.testing.assert_allclose(g_v[2:], 1.0 / (N * D), rtol=1e-6)


def test_ifelse_branch_write_to_outer_var_raises():
    m = pt.layers.data(name="m", shape=[1], dtype="bool")
    flag = pt.layers.fill_constant([1], "float32", 0.0)
    one = pt.layers.fill_constant([1], "float32", 1.0)
    x = pt.layers.data(name="x", shape=[2], dtype="float32")
    ie = _cf(pt).IfElse(m)
    with ie.true_block():
        pt.layers.assign(one, output=flag)
        ie.output(x * 2.0)
    with ie.false_block():
        ie.output(x * 1.0)
    with pytest.raises(ValueError, match="do not persist"):
        ie()


def test_ifelse_mismatched_outputs_raises():
    m = pt.layers.data(name="m", shape=[1], dtype="bool")
    x = pt.layers.data(name="x", shape=[3], dtype="float32")
    ie = _cf(pt).IfElse(m)
    with ie.true_block():
        ie.output(x * 2.0)
    with ie.false_block():
        pass
    with pytest.raises(ValueError, match="different output counts"):
        ie()


@pytest.mark.parametrize("step,want", [(3, 0.1), (7, 0.01), (12, 0.001)])
def test_switch_piecewise_first_true_wins(step, want):
    def build(P):
        s = P.layers.data(name="step", shape=[1], dtype="int64",
                          append_batch_size=False)
        lr = P.layers.fill_constant([1], "float32", 0.0)
        b1 = P.layers.fill_constant([1], "int64", 5)
        b2 = P.layers.fill_constant([1], "int64", 10)
        v1 = P.layers.fill_constant([1], "float32", 0.1)
        v2 = P.layers.fill_constant([1], "float32", 0.01)
        v3 = P.layers.fill_constant([1], "float32", 0.001)
        with _cf(P).Switch() as sw:
            with sw.case(P.layers.less_than(s, b1)):
                P.layers.assign(v1, output=lr)
            with sw.case(P.layers.less_than(s, b2)):
                P.layers.assign(v2, output=lr)
            with sw.default():
                P.layers.assign(v3, output=lr)
        return [lr]

    lr_v, = _both(build, feed={"step": np.array([step], np.int64)},
                  startup=False)
    np.testing.assert_allclose(lr_v, [want], rtol=1e-6)


def test_array_write_read_roundtrip():
    def build(P):
        cf = _cf(P)
        arr = cf.create_array("float32", [2], max_len=4)
        x = P.layers.fill_constant([2], "float32", 3.5)
        i = P.layers.fill_constant([1], "int64", 2)
        cf.array_write(x, i, arr)
        return [arr, cf.array_read(arr, i)]

    arr_v, y_v = _both(build, startup=False)
    np.testing.assert_allclose(y_v, [3.5, 3.5])
    expect = np.zeros((4, 2), np.float32)
    expect[2] = 3.5
    np.testing.assert_allclose(arr_v, expect)


@pytest.mark.parametrize("index", [-5, -4, -1, 0, 3, 4, 9])
def test_array_index_clamps_as_the_reference(index):
    """An index past either end: the JAX package's dynamic index wraps a
    negative index once and clamps into [0, 3]; the port's read and
    write land on the same slot, with no host read of the index."""
    arr = np.arange(8, dtype=np.float32).reshape(4, 2)
    i = np.array([index], np.int64)
    jout, pout, _, _ = run_both("array_read", {"Array": [arr], "I": [i]})
    np.testing.assert_array_equal(pout["Out"][0].numpy(),
                                  np.asarray(jout["Out"][0]))
    x = np.array([-1.0, -2.0], np.float32)
    jout, pout, jg, pg = run_both("array_write",
                                  {"Array": [arr], "X": [x], "I": [i]},
                                  grad=("Array", "X"))
    np.testing.assert_array_equal(pout["Out"][0].numpy(),
                                  np.asarray(jout["Out"][0]))
    for j, p in zip(jg, pg):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    slot = min(max(index + 4 if index < 0 else index, 0), 3)
    np.testing.assert_array_equal(pout["Out"][0].numpy()[slot], x)


def test_while_program_serialization_roundtrip():
    def build(P):
        s = P.layers.fill_constant([1], "float32", 1.0)
        _counter_loop(P, 6, lambda: P.layers.assign(s * 2.0, output=s))
        return [s]

    s_v, = _both(build, startup=False)
    assert float(s_v[0]) == 64.0
    prog = pt.default_main_program()
    clone = pt.Program.from_json(prog.to_json())
    assert clone.to_dict()["blocks"] == prog.to_dict()["blocks"]
    # the JAX package's text loads into the port and runs the same
    jpt.framework.reset_default_programs()
    build(jpt)
    text = jpt.default_main_program().to_json()
    s2, = pt.Executor(pt.CPUPlace()).run(pt.Program.from_json(text),
                                         fetch_list=["fill_constant_0.tmp_0"])
    assert float(s2[0]) == 64.0


def test_ifelse_rejects_cross_row_branch():
    x = pt.layers.data("x", [4])
    c = pt.layers.data("c", [1], dtype="bool")
    ie = pt.layers.IfElse(c)
    with ie.true_block():
        ie.output(pt.layers.mean(ie.input(x)))
    with ie.false_block():
        ie.output(pt.layers.mean(ie.input(x)))
    out = ie()
    with pytest.raises(NotImplementedError, match="cross-row|batch"):
        _run(pt, [out[0]], feed={"x": np.ones((3, 4), np.float32),
                                 "c": np.asarray([[True], [False], [True]])})


def test_while_draws_afresh_each_iteration():
    """Both packages: a uniform draw inside a While body differs from
    one iteration to the next (the reference threads its key through
    the loop carry; the port's generator advances)."""
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        cf = _cf(P)
        arr = cf.create_array("float32", [8], max_len=3)
        box = {}

        def body(P=P, cf=cf, arr=arr, box=box):
            cf.array_write(P.layers.uniform_random([8]), box["i"], arr)

        i = P.layers.fill_constant([1], "int64", 0)
        box["i"] = i
        n = P.layers.fill_constant([1], "int64", 3)
        cond = P.layers.less_than(i, n)
        w = cf.While(cond)
        with w.block():
            body()
            P.layers.increment(i)
            P.layers.less_than(i, n, cond=cond)
        arr_v, = _run(P, [arr], startup=False)
        assert not np.array_equal(arr_v[0], arr_v[1])
        assert not np.array_equal(arr_v[1], arr_v[2])


def _dropout_group(P, B, T, F):
    x = P.layers.data("x", [F], lod_level=1)
    w = P.layers.create_parameter(
        [F], "float32", name="wp",
        default_initializer=P.initializer.ConstantInitializer(1.0))
    out = P.layers.recurrent_group(
        step=lambda y: P.layers.dropout(P.layers.elementwise_mul(y, w),
                                        dropout_prob=0.5), input=x)
    return out, P.layers.mean(out)


def _same_mask_every_step(o, T):
    assert 0 < (o == 0).mean() < 1
    for t in range(1, T):
        np.testing.assert_array_equal(o[:, t], o[:, 0])


def test_recurrent_group_dropout_shares_one_mask_across_steps():
    """A dropout inside a recurrent_group step draws ONE mask that every
    time step applies, in both packages (the program taped for
    training). The reference traces the step once inside its scan, so
    the step's one key is every step's key; the port replays the
    generator's state at each step to match. A second run draws a new
    mask. Forward-only, the JAX package leaks a tracer out of its scan
    (ROADMAP C19); the port runs and applies one mask there too."""
    import jax
    B, T, F = 4, 6, 16
    feed = {"x": np.ones((B, T, F), np.float32),
            "x@SEQLEN": np.full([B], T, np.int32)}
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        out, loss = _dropout_group(P, B, T, F)
        (_p, grad), = P.backward.append_backward(loss)
        exe, scope = P.Executor(P.CPUPlace()), P.Scope()
        exe.run(P.default_startup_program(), scope=scope)
        runs = [exe.run(feed=feed, fetch_list=[out, grad], scope=scope)
                for _ in range(2)]
        for o, g in runs:
            _same_mask_every_step(o, T)
            # the gradient replays the forward's mask
            np.testing.assert_allclose(g, o.sum(axis=(0, 1)) / o.size,
                                       rtol=1e-6)
        assert not np.array_equal(runs[0][0], runs[1][0])

    for P in (jpt, pt):
        P.framework.reset_default_programs()
        out, _loss = _dropout_group(P, B, T, F)
        exe, scope = P.Executor(P.CPUPlace()), P.Scope()
        exe.run(P.default_startup_program(), scope=scope)
        if P is jpt:
            with pytest.raises(jax.errors.UnexpectedTracerError):
                exe.run(feed=feed, fetch_list=[out], scope=scope)
        else:
            _same_mask_every_step(
                exe.run(feed=feed, fetch_list=[out], scope=scope)[0], T)


def test_while_shape_inference_on_meta_tensors():
    """eval_op_shapes through sub-blocks: a While gives its loop vars'
    shapes (its condition cannot be read on the meta device); a
    recurrent_group infers from one lowering of its step block."""
    B_, F = 3, 4
    h = pt.layers.fill_constant([B_, F], "float32", 0.0)
    _counter_loop(pt, 3, lambda: pt.layers.assign(h * 2.0, output=h))
    blk = pt.default_main_program().global_block()
    op = blk.ops[-1]
    assert op.type == "while"
    shapes = preg.eval_op_shapes(blk, op)
    assert dict(zip(op.outputs["Out"], shapes["Out"]))[h.name] == (
        (B_, F), "float32")

    pt.framework.reset_default_programs()
    x = pt.layers.data("x", [F], lod_level=1)
    pt.layers.recurrent_group(
        step=lambda y: pt.layers.fc(input=y, size=5, act="tanh"), input=x)
    blk = pt.default_main_program().global_block()
    op = blk.ops[-1]
    assert op.type == "recurrent_group"
    assert preg.eval_op_shapes(blk, op)["Out"] == [((-1, -1, 5), "float32")]


def test_inference_prune_keeps_the_while_body(tmp_path):
    """save_inference_model prunes the global block to what the fetch
    needs and carries the While's sub-block and the loop vars' first
    values; the loaded program computes the same."""
    x = pt.layers.data("x", [3])
    s = pt.layers.fill_constant([1], "float32", 0.0)
    acc = pt.layers.fill_constant([2, 3], "float32", 0.0)
    pt.layers.fill_constant([1], "float32", 7.0)          # dead
    _counter_loop(pt, 4, lambda: pt.layers.assign(acc + x, output=acc))
    del s
    exe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
    want, = exe.run(feed=feed, fetch_list=[acc])
    pt.io.save_inference_model(str(tmp_path), ["x"], [acc], exe)
    prog, feeds, fetches = pt.io.load_inference_model(str(tmp_path), exe)
    assert len(prog.blocks) == 2
    got, = exe.run(prog, feed=feed, fetch_list=fetches)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, 4 * feed["x"])


SLICE_OPS = ("while", "ifelse", "switch", "array_write", "array_read",
             "recurrent_group", "shape", "less_equal", "greater_than",
             "greater_equal", "equal", "not_equal", "logical_and",
             "logical_or", "logical_xor", "logical_not", "fill_zeros_like",
             "fill_constant_batch_size_like", "is_empty", "lod_reset",
             "transpose", "warpctc", "ctc_align", "linear_chain_crf",
             "crf_decoding", "chunk_eval")


def test_every_op_of_the_slice_is_registered_with_the_reference_flags():
    from paddle_tpu.ops import registry as jreg
    assert len(set(SLICE_OPS)) == 26
    for n in SLICE_OPS:
        j, p = jreg.get_op(n), preg.get_op(n)
        assert (p.differentiable, p.stateful) == (j.differentiable,
                                                  j.stateful), n


_A = np.array([[1, 2, 3], [3, 2, 1]], np.int64)
_B = np.array([[2, 2, 2], [1, 2, 3]], np.int64)
_P = np.array([[True, False, True], [False, False, True]])
_Q = np.array([[True, True, False], [False, True, True]])


@pytest.mark.parametrize("op,ins,attrs", [
    ("shape", {"Input": [np.zeros((2, 3, 5), np.float32)]}, {}),
    ("less_equal", {"X": [_A], "Y": [_B]}, {}),
    ("greater_than", {"X": [_A], "Y": [_B]}, {}),
    ("greater_equal", {"X": [_A.astype(np.float32)],
                       "Y": [_B.astype(np.float32)]}, {}),
    ("equal", {"X": [_A], "Y": [_B]}, {}),
    ("not_equal", {"X": [_A], "Y": [_B]}, {}),
    ("logical_and", {"X": [_P], "Y": [_Q]}, {}),
    ("logical_or", {"X": [_P], "Y": [_Q]}, {}),
    ("logical_xor", {"X": [_P], "Y": [_Q]}, {}),
    ("logical_not", {"X": [_P]}, {}),
    ("fill_zeros_like", {"X": [_A.astype(np.float32)]}, {}),
    ("transpose", {"X": [np.arange(24, dtype=np.float32).reshape(2, 3, 4)]},
     {"axis": [2, 0, 1]}),
    ("reduce_max", {"X": [_A.astype(np.float32)]}, {"dim": [1]}),
    ("reduce_max", {"X": [_A.astype(np.float32)]}, {"reduce_all": True}),
    ("fill_constant_batch_size_like",
     {"Input": [np.zeros((4, 3), np.float32)]},
     {"shape": [-1, 7], "value": 2.5, "dtype": "float32"}),
    ("fill_constant_batch_size_like",
     {"Input": [np.zeros((5, 3), np.float32)]},
     {"shape": [2, -1], "value": 3, "dtype": "int32",
      "input_dim_idx": 0, "output_dim_idx": 1}),
    ("is_empty", {"X": [np.zeros((0, 3), np.float32)]}, {}),
    ("is_empty", {"X": [np.zeros((2, 3), np.float32)]}, {}),
    ("lod_reset", {"X": [_A.astype(np.float32)],
                   "TargetLen": [np.array([3, 1], np.int32)]}, {}),
    ("lod_reset", {"X": [_A.astype(np.float32)]},
     {"target_lod": [0, 2, 3]}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_tensor_and_misc_ops_match_jax_package(op, ins, attrs):
    jout, pout, _, _ = run_both(op, ins, attrs)
    for slot, jvals in jout.items():
        for jv, pv in zip(jvals, pout[slot]):
            jv, pv = np.asarray(jv), pv.numpy()
            assert pv.shape == jv.shape and pv.dtype == jv.dtype, (slot, pv,
                                                                  jv)
            np.testing.assert_array_equal(pv, jv)


def test_transpose_and_reduce_max_gradients_match_jax_package():
    x = np.random.RandomState(9).randn(2, 3, 4).astype(np.float32)
    x[0, 1, :2] = 5.0                      # a tie: the gradient splits
    for op, attrs in (("transpose", {"axis": [1, 2, 0]}),
                      ("reduce_max", {"dim": [2]})):
        _j, _p, jg, pg = run_both(op, {"X": [x]}, attrs, grad=("X",))
        np.testing.assert_allclose(pg[0].numpy(), np.asarray(jg[0]),
                                   rtol=0, atol=1e-6)
