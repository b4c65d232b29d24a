"""recurrent_group in the port (the step block run once a time step)
against the JAX package (one lax.scan) and numpy step loops, on the CPU.

The twin of tests/test_recurrent_group.py: forward, reverse, a
StaticInput with a boot layer, training (the loss below 0.3 of its
first value in 80 Adam steps, as the original) and memory() outside a
group. Each program's main Program dict equals the JAX front end's,
and the port runs on the JAX package's initial parameters. Also a
nested group: an outer recurrent_group over a SubsequenceInput whose
step runs an inner group booted from the outer memory, built through
layers.rnn_group in both packages (the reference tests that mode only
through its v2 API, which the port does not have).

Tolerances: forward outputs within 1e-5 absolute of numpy (the
original's) and of the JAX package; gradients within 1e-5 of each
gradient's largest element against the JAX package (both sum the same
terms in other orders).
"""

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu_torch.weights import scope_from_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, T, F, H = 3, 5, 4, 6
_LENS = np.asarray([5, 3, 2], np.int64)
FWD_ATOL = 1e-5
GRAD_REL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_programs():
    for P in (jpt, pt):
        P.framework.reset_default_programs()
    yield


def _np_rnn(xd, Wy, Wh, b, lens, reverse=False, h0=None):
    h = np.zeros((B, H)) if h0 is None else h0.copy()
    ref = np.zeros((B, T, H))
    order = range(T - 1, -1, -1) if reverse else range(T)
    for t in order:
        hn = np.tanh(xd[:, t] @ Wy + h @ Wh + b)
        m = (t < lens)[:, None]
        h = np.where(m, hn, h)
        ref[:, t] = np.where(m, h, 0.0)
    return ref


def _run_both(build, feed, grads=False):
    """`build(P)` -> (fetch list, loss or None) in both packages; equal
    main Program dicts; the port starts from the JAX package's
    parameters. With `grads`, the gradient of every parameter is
    appended and fetched after the build's fetches. Returns (JAX
    fetches, port fetches, parameter values)."""
    outs, params = [], None
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        fetch, loss = build(P)
        if grads:
            fetch = list(fetch) + [g for _p, g in
                                   P.backward.append_backward(loss)]
        outs.append(P.default_main_program().to_dict())
        if P is jpt:
            exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
            exe.run(jpt.default_startup_program(), scope=scope)
            params = {k: np.array(scope.get(k)) for k in scope.keys()
                      if not k.startswith("__")}
        else:
            exe, scope = pt.Executor(pt.CPUPlace()), scope_from_numpy(
                params, "cpu")
        outs.append(exe.run(feed=feed, fetch_list=fetch, scope=scope))
    jdict, jout, pdict, pout = outs
    assert pdict == jdict
    return jout, pout, params


def _check(jout, pout, n_fwd):
    for i, (j, p) in enumerate(zip(jout, pout)):
        j, p = np.asarray(j), np.asarray(p)
        assert p.shape == j.shape, (i, p.shape, j.shape)
        if i < n_fwd:
            np.testing.assert_allclose(p, j, rtol=0, atol=FWD_ATOL)
        else:
            tol = GRAD_REL * max(float(np.abs(j).max()), 1e-30)
            np.testing.assert_allclose(p, j, rtol=0, atol=tol)


def _weights(params, prefix):
    """(Wy, Wh, b) of the step fc named `prefix`."""
    ws = {k: v for k, v in params.items() if k.startswith(prefix)}
    Wy = next(v for v in ws.values() if v.shape == (F, H))
    Wh = next(v for v in ws.values() if v.shape == (H, H))
    b = next(v for v in ws.values() if v.shape == (H,))
    return Wy, Wh, b


def _rnn_step(P, state):
    def step(y):
        mem = P.layers.memory(name=state, size=H)
        return P.layers.fc(input=[y, mem], size=H, act="tanh", name=state)
    return step


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_recurrent_group_matches_numpy_and_jax_package(reverse):
    """Forward and the gradients of every parameter and of the input
    (reached through an fc before the group)."""
    xd = np.random.RandomState(23).uniform(-1, 1, (B, T, F)).astype(
        np.float32)

    def build(P):
        x = P.layers.data("x", [F], lod_level=1)
        out = P.layers.recurrent_group(step=_rnn_step(P, "rnn_state"),
                                       input=x, reverse=reverse)
        assert out.lod_level == 1 and out.seq_len_var is not None
        return [out], P.layers.mean(out)

    feed = {"x": xd, "x@SEQLEN": _LENS}
    jout, pout, params = _run_both(build, feed, grads=True)
    assert len(pout) == 4
    _check(jout, pout, 1)
    ref = _np_rnn(xd, *_weights(params, "rnn_state"), _LENS,
                  reverse=reverse)
    np.testing.assert_allclose(pout[0], ref, atol=FWD_ATOL)


def test_recurrent_group_static_input_and_boot():
    rng = np.random.RandomState(24)
    xd = rng.uniform(-1, 1, (B, T, F)).astype(np.float32)
    cd = rng.uniform(-1, 1, (B, H)).astype(np.float32)

    def build(P):
        x = P.layers.data("x", [F], lod_level=1)
        ctxv = P.layers.data("ctx", [H], lod_level=0)

        def step(y, c):
            mem = P.layers.memory(name="st_state", size=H, boot_layer=c)
            return P.layers.fc(input=[y, mem], size=H, act="tanh",
                               name="st_state")

        out = P.layers.recurrent_group(
            step=step, input=[x, P.layers.StaticInput(ctxv)])
        return [out], P.layers.mean(out)

    jout, pout, params = _run_both(
        build, {"x": xd, "x@SEQLEN": _LENS, "ctx": cd}, grads=True)
    _check(jout, pout, 1)
    ref = _np_rnn(xd, *_weights(params, "st_state"), _LENS, h0=cd)
    np.testing.assert_allclose(pout[0], ref, atol=FWD_ATOL)


def test_recurrent_group_trains():
    """Gradients flow through the steps into the step's parameters AND
    upstream layers (an embedding): a last-token classification task
    learns, as in the original (from the port's own initialisation)."""
    V, C = 11, 3
    words = pt.layers.data("w", [], dtype="int64", lod_level=1)
    emb = pt.layers.embedding(words, size=[V, F])
    seq = pt.layers.recurrent_group(step=_rnn_step(pt, "cls_state"),
                                    input=emb)
    prob = pt.layers.fc(pt.layers.sequence_last_step(seq), C,
                        act="softmax")
    label = pt.layers.data("label", [1], dtype="int64")
    loss = pt.layers.mean(pt.layers.cross_entropy(prob, label))
    pt.AdamOptimizer(learning_rate=0.05).minimize(loss)

    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    rng = np.random.RandomState(5)
    wd = rng.randint(1, V, (8, T)).astype(np.int64)
    lab = (wd[:, 0] % C).reshape(8, 1).astype(np.int64)
    feed = {"w": wd, "w@SEQLEN": np.full((8,), T, np.int64), "label": lab}
    losses = [float(np.ravel(exe.run(feed=feed, fetch_list=[loss],
                                     scope=scope)[0])[0])
              for _ in range(80)]
    assert losses[-1] < losses[0] * 0.3, (losses[0], losses[-1])


def test_memory_outside_group_raises():
    with pytest.raises(RuntimeError):
        pt.layers.memory(name="nope", size=4)


def test_nested_subsequence_group_matches_jax_package():
    """An outer group over the subsequences of a nested (lod_level 2)
    input; its step runs an inner group over the subsequence's tokens
    whose memory boots from the outer memory, and feeds the inner
    group's last step back as the outer state. Rows have 3, 1 and 2
    subsequences of ragged inner lengths (a zero inner length past a
    row's count). Outputs and every parameter's gradient are held to
    the JAX package."""
    S, TI = 3, 4
    rng = np.random.RandomState(31)
    xd = rng.uniform(-1, 1, (B, S, TI, F)).astype(np.float32)
    outer = np.asarray([3, 1, 2], np.int32)
    inner = np.asarray([[4, 2, 3], [1, 0, 0], [2, 4, 0]], np.int32)

    def build(P):
        x = P.layers.data("x", [F], lod_level=2)

        def outer_step(sub):
            o_mem = P.layers.memory(name="outer_state", size=H)

            def inner_step(y):
                mem = P.layers.memory(name="inner_state", size=H,
                                      boot_layer=o_mem)
                return P.layers.fc(input=[y, mem], size=H, act="tanh",
                                   name="inner_state")

            seq = P.layers.recurrent_group(step=inner_step, input=sub)
            last = P.layers.sequence_last_step(seq)
            return P.layers.fc(input=[last, o_mem], size=H, act="tanh",
                               name="outer_state")

        out = P.layers.recurrent_group(
            step=outer_step, input=P.layers.SubsequenceInput(x))
        return [out], P.layers.mean(out)

    jout, pout, _params = _run_both(
        build, {"x": xd, "x@SEQLEN": outer, "x@SEQLEN@SUB": inner},
        grads=True)
    assert len(pout) == 7          # out + 6 parameters' gradients
    _check(jout, pout, 1)
    assert np.abs(pout[0][1, 1:]).max() == 0.0
    assert min(float(np.abs(g).max()) for g in pout[1:]) > 0


@pytest.mark.parametrize("T_", [1, 5])
def test_program_flops_counts_every_step(T_):
    """The static FLOP tally walks the step block (ROADMAP C12): one
    recurrent_group step forward and backward tallies the same as the
    JAX package's traced step, and T steps T times as much, where the
    reference's scan body counts once."""
    from paddle_tpu.monitor import introspect as ji
    from paddle_tpu_torch.monitor import introspect as pi
    feed = {"x": np.zeros((B, T_, F), np.float32),
            "x@SEQLEN": np.full([B], T_, np.int32)}
    tally = []
    for P, I in ((jpt, ji), (pt, pi)):
        P.framework.reset_default_programs()
        x = P.layers.data("x", [F], lod_level=1)
        out = P.layers.recurrent_group(step=_rnn_step(P, "f_state"), input=x)
        P.backward.append_backward(P.layers.mean(out))
        exe, scope = P.Executor(P.CPUPlace()), P.Scope()
        exe.run(P.default_startup_program(), scope=scope)
        tally.append(I.program_flops(P.default_main_program(), feed,
                                     scope=scope, executor=exe))
    assert tally[0] > 0
    assert tally[1] == T_ * tally[0]
