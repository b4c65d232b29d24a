"""The evaluators and their ops in the port, on the CPU.

Twins of tests/test_ingraph_evaluators.py's accuracy pass loop, in-graph
AUC and chunk tests and of tests/test_evaluators_profiler.py's AUC and
training-pass-loop tests (the pass loop scores with the port's host
Accuracy and Auc: the precision-recall evaluator is not ported yet);
the host ChunkEvaluator and EditDistance against the JAX package's, and
the in-graph chunk counts against the host's, exactly.
The ops against the JAX package's lowerings on the same numpy inputs:
`topk` and `accuracy` exactly, ties included (the lower index first,
as jax.lax.top_k); `scatter_add_1d` exactly (counts below 2^24 add
exactly in float32), out-of-range indices dropped; `auc_from_histograms`
within 1e-6. Histogram counts and accuracy counts are exact; an AUC is
held to 1e-6.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import evaluator as jev
import paddle_tpu_torch as pt
from paddle_tpu_torch import evaluator as ev
from paddle_tpu_torch.ops import registry as op_registry
from paddle_tpu_torch.weights import scope_from_numpy

AUC_TOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_programs():
    for P in (jpt, pt):
        P.framework.reset_default_programs()
    yield


def _classifier(P, nc=3):
    x = P.layers.data("x", [8])
    label = P.layers.data("label", [1], dtype="int64")
    probs = P.layers.fc(input=x, size=nc, act="softmax")
    cost = P.layers.mean(P.layers.cross_entropy(probs, label))
    return x, label, probs, cost


def _data(n, nc=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8).astype(np.float32)
    y = (np.abs(x[:, :nc]).argmax(axis=1)).astype(np.int64)[:, None]
    return x, y


def test_ingraph_accuracy_pass_loop_matches_numpy():
    """A pass of 8 training batches fetching only the cost: the in-graph
    correct / total states equal the sum of the batches' counts exactly
    (a second pass fetching each batch's accuracy), eval() is their
    ratio, and reset() zeroes them."""
    _, label, probs, cost = _classifier(pt)
    acc = ev.InGraphAccuracy(input=probs, label=label)
    pt.SGDOptimizer(learning_rate=0.5).minimize(cost)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)

    xs, ys = _data(64)
    for i in range(8):
        sl = slice(i * 8, (i + 1) * 8)
        exe.run(feed={"x": xs[sl], "label": ys[sl]}, fetch_list=[cost],
                scope=scope)
    assert 0.0 <= acc.eval(exe, scope) <= 1.0

    acc.reset(exe, scope)
    correct, total = acc.states
    n_correct = 0
    for i in range(8):
        sl = slice(i * 8, (i + 1) * 8)
        a, = exe.run(feed={"x": xs[sl], "label": ys[sl]},
                     fetch_list=[acc.batch_accuracy], scope=scope)
        n_correct += int(round(float(a[0]) * 8))
    assert scope.get(correct.name).tolist() == [float(n_correct)]
    assert scope.get(total.name).tolist() == [64.0]
    assert acc.eval(exe, scope) == np.float32(n_correct) / np.float32(64)

    acc.reset(exe, scope)
    a, = exe.run(feed={"x": xs[:8], "label": ys[:8]},
                 fetch_list=[acc.batch_accuracy], scope=scope)
    assert acc.eval(exe, scope) == float(a[0])


def test_ingraph_auc_matches_host_auc_and_jax_package():
    """The twin of the reference's in-graph AUC test, both packages from
    one initialisation: the port's histogram states equal the JAX
    package's exactly, its AUC the host Auc's within AUC_TOL."""
    progs = []
    for P, E in ((jpt, jev), (pt, ev)):
        P.framework.reset_default_programs()
        x = P.layers.data("x", [8])
        label = P.layers.data("label", [1], dtype="int64")
        score = P.layers.fc(input=x, size=1, act="sigmoid")
        P.layers.mean(P.layers.square(score))
        auc = E.InGraphAuc(scores=score, labels=label, num_thresholds=200)
        progs.append((P.default_main_program(),
                      P.default_startup_program(), score, auc))
    (jmain, jstart, jscore, jauc), (pmain, pstart, pscore, pauc) = progs
    assert pmain.to_dict() == jmain.to_dict()
    assert pstart.to_dict() == jstart.to_dict()
    assert pauc.eval_program.to_dict() == jauc.eval_program.to_dict()
    assert pauc.reset_program.to_dict() == jauc.reset_program.to_dict()
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    pscope = scope_from_numpy({k: np.array(v) for k, v in jscope.vars.items()
                               if not k.startswith("__")}, "cpu")
    pexe = pt.Executor(pt.CPUPlace())

    rng = np.random.RandomState(1)
    host = ev.Auc(num_thresholds=200)
    for _ in range(5):
        xs = rng.randn(16, 8).astype(np.float32)
        ys = rng.randint(0, 2, (16, 1)).astype(np.int64)
        s, = pexe.run(pmain, feed={"x": xs, "label": ys},
                      fetch_list=[pscore], scope=pscope)
        jexe.run(jmain, feed={"x": xs, "label": ys}, fetch_list=[jscore],
                 scope=jscope)
        host.update(np.asarray(s), ys)
    for st in pauc.states:
        np.testing.assert_array_equal(pscope.get(st.name).numpy(),
                                      np.asarray(jscope.get(st.name)))
    got = pauc.eval(pexe, pscope)
    assert abs(got - host.eval()) <= AUC_TOL, (got, host.eval())
    assert abs(got - jauc.eval(jexe, jscope)) <= AUC_TOL


def test_auc_ranks_perfect_and_random():
    """The host Auc: a perfect ranking scores > 0.99, a random one ~0.5,
    batched accumulation equals one shot; the same values as the JAX
    package's host Auc."""
    for E in (ev, jev):
        e = E.Auc(num_thresholds=500)
        rng = np.random.RandomState(0)
        labels = rng.randint(0, 2, size=4000)
        e.update(labels * 0.9 + 0.05, labels)
        assert e.eval() > 0.99
        e.reset()
        e.update(rng.rand(4000), labels)
        assert abs(e.eval() - 0.5) < 0.05
        e2 = E.Auc(num_thresholds=500)
        scores = rng.rand(1000) * 0.5 + labels[:1000] * 0.4
        e.reset()
        e.update(scores, labels[:1000])
        e2.update(scores[:500], labels[:500])
        e2.update(scores[500:1000], labels[500:1000])
        np.testing.assert_allclose(e.eval(), e2.eval())
    a, b = ev.Auc(77), jev.Auc(77)
    s = np.random.RandomState(3).rand(300)
    y = s + np.random.RandomState(4).randn(300) * 0.3 > 0.5
    a.update(s, y)
    b.update(s, y)
    assert a.eval() == b.eval()


def test_evaluators_in_training_pass_loop():
    """A logistic classifier trained for 15 passes of 4 batches, scored
    each pass by the host Accuracy (from the batches' accuracy fetch)
    and Auc: accuracy > 0.9, AUC > 0.95 at the end."""
    rng = np.random.RandomState(1)
    n, d = 256, 8
    w_true = rng.randn(d)
    x_np = rng.randn(n, d).astype(np.float32)
    y_np = (x_np @ w_true > 0).astype(np.int64)[:, None]

    x = pt.layers.data(name="x", shape=[d], dtype="float32")
    y = pt.layers.data(name="y", shape=[1], dtype="int64")
    probs = pt.layers.fc(x, 2, act="softmax")
    cost = pt.layers.mean(pt.layers.cross_entropy(probs, y))
    acc = ev.Accuracy(input=probs, label=y)
    pt.SGDOptimizer(learning_rate=0.5).minimize(cost)

    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    auc = ev.Auc()
    for _ in range(15):
        acc.reset()
        auc.reset()
        for i in range(0, n, 64):
            feed = {"x": x_np[i:i + 64], "y": y_np[i:i + 64]}
            p_v, a_v = exe.run(feed=feed, fetch_list=[probs] + acc.metrics,
                               scope=scope)
            acc.update(a_v, 64)
            auc.update(p_v[:, 1], y_np[i:i + 64])
    assert acc.eval() > 0.9, acc.eval()
    assert auc.eval() > 0.95


def _both(op, ins, attrs):
    import jax.numpy as jnp
    jout = jpt.ops.registry.get_op(op).lowering(
        None, {k: [jnp.asarray(v)] for k, v in ins.items()}, dict(attrs))
    pout = op_registry.get_op(op).lowering(
        None, {k: [torch.from_numpy(v.copy())] for k, v in ins.items()},
        dict(attrs))
    return jout, pout


@pytest.mark.parametrize("k", [1, 3])
def test_topk_and_accuracy_match_jax_package_with_ties(k):
    """Scores rounded to a quarter (ties in most rows): topk's values
    and indices and accuracy's Accuracy / Correct / Total equal the
    reference's exactly, dtypes and shapes included."""
    rng = np.random.RandomState(2)
    x = (np.round(rng.rand(32, 6) * 4) / 4).astype(np.float32)
    label = rng.randint(0, 6, (32, 1)).astype(np.int64)
    jout, pout = _both("topk", {"X": x}, {"k": k})
    for slot in ("Out", "Indices"):
        j, p = np.asarray(jout[slot][0]), pout[slot][0].numpy()
        assert p.dtype == j.dtype and p.shape == j.shape
        np.testing.assert_array_equal(p, j)
    idx = pout["Indices"][0].numpy()
    jout, pout = _both("accuracy", {"Out": idx, "Label": label}, {})
    for slot in ("Accuracy", "Correct", "Total"):
        j, p = np.asarray(jout[slot][0]), pout[slot][0].numpy()
        assert p.dtype == j.dtype and p.shape == j.shape == (1,), slot
        np.testing.assert_array_equal(p, j)


def test_metric_ops_match_jax_package():
    """scatter_add_1d: indices out of [0, n) add nothing, counts exact,
    with and without a Weight; auc_from_histograms within AUC_TOL."""
    rng = np.random.RandomState(3)
    hist = rng.randint(0, 50, 21).astype(np.float32)
    idx = rng.randint(-3, 25, 40).astype(np.float32)
    w = rng.randint(0, 2, 40).astype(np.float32)
    for ins in ({"X": hist, "Index": idx, "Weight": w},
                {"X": hist, "Index": idx}):
        jout, pout = _both("scatter_add_1d", ins, {})
        np.testing.assert_array_equal(pout["Out"][0].numpy(),
                                      np.asarray(jout["Out"][0]))
    pos = rng.randint(0, 30, 201).astype(np.float32)
    neg = rng.randint(0, 30, 201).astype(np.float32)
    jout, pout = _both("auc_from_histograms", {"Pos": pos, "Neg": neg}, {})
    p, j = pout["Auc"][0].numpy(), np.asarray(jout["Auc"][0])
    assert p.shape == j.shape == (1,)
    assert abs(float(p[0]) - float(j[0])) <= AUC_TOL


def _iob_batch(rng, B, T, n_types):
    """Random IOB tags [B, T, 1] (B-, I- and O tags, I-tags of the wrong
    type and after an O) with ragged lengths."""
    tags = rng.randint(0, 2 * n_types + 1, (B, T, 1)).astype(np.int64)
    lens = rng.randint(1, T + 1, (B,)).astype(np.int32)
    return tags, lens


def test_chunk_evaluator_host_matches_jax_package():
    rng = np.random.RandomState(5)
    a, b = ev.ChunkEvaluator(3), jev.ChunkEvaluator(3)
    for _ in range(20):
        inf = rng.randint(0, 7, 15)
        lab = np.where(rng.rand(15) < 0.3, rng.randint(0, 7, 15), inf)
        a.update(inf, lab)
        b.update(inf, lab)
    assert (a.tp, a.inferred_chunks, a.label_chunks) == (
        b.tp, b.inferred_chunks, b.label_chunks)
    assert a.eval() == b.eval()
    assert 0 < a.tp < a.inferred_chunks


def test_ingraph_chunk_evaluator_matches_host():
    """A pass of 3 batches through the in-graph chunk states: the Program
    dicts equal the JAX package's, the accumulated counts equal the host
    ChunkEvaluator's on the same tags exactly, eval() equals the host's
    eval(), and reset() zeroes the states."""
    n_types, B, T = 3, 8, 10

    def build(P):
        inf = P.layers.data("inf", [1], dtype="int64", lod_level=1)
        lab = P.layers.data("lab", [1], dtype="int64", lod_level=1)
        return P.evaluator.InGraphChunkEvaluator(inf, lab, n_types)

    jpt.framework.reset_default_programs()
    jchunk = build(jpt)
    jdicts = [p.to_dict() for p in (jpt.default_main_program(),
                                    jpt.default_startup_program(),
                                    jchunk.eval_program,
                                    jchunk.reset_program)]
    pt.framework.reset_default_programs()
    chunk = build(pt)
    assert [p.to_dict() for p in (pt.default_main_program(),
                                  pt.default_startup_program(),
                                  chunk.eval_program,
                                  chunk.reset_program)] == jdicts

    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    host = ev.ChunkEvaluator(n_types)
    rng = np.random.RandomState(6)
    for _ in range(3):
        inf, lens = _iob_batch(rng, B, T, n_types)
        lab = np.where(rng.rand(B, T, 1) < 0.3,
                       _iob_batch(rng, B, T, n_types)[0], inf)
        f1, = exe.run(feed={"inf": inf, "inf@SEQLEN": lens, "lab": lab,
                            "lab@SEQLEN": lens},
                      fetch_list=[chunk.batch_f1], scope=scope)
        assert 0.0 <= float(f1[0]) <= 1.0
        for b in range(B):
            host.update(inf[b, :lens[b], 0], lab[b, :lens[b], 0])
    cor, n_inf, n_lab = (float(np.ravel(v)[0]) for v in exe.run(
        chunk.eval_program, fetch_list=chunk._fetches, scope=scope))
    assert (cor, n_inf, n_lab) == (host.tp, host.inferred_chunks,
                                   host.label_chunks)
    assert chunk.eval(exe, scope) == host.eval()
    chunk.reset(exe, scope)
    assert chunk.eval(exe, scope) == (0.0, 0.0, 0.0)


def test_edit_distance_evaluator_matches_jax_package():
    """The edit_distance layer's per-sequence distances (exact) and the
    host EditDistance evaluator's mean distance and sequence error rate
    equal the JAX package's."""
    rng = np.random.RandomState(7)
    B, T = 6, 7
    hyps = rng.randint(1, 5, (B, T, 1)).astype(np.int64)
    refs = np.where(rng.rand(B, T, 1) < 0.6, hyps,
                    rng.randint(1, 5, (B, T, 1))).astype(np.int64)
    hl = rng.randint(1, T + 1, (B,)).astype(np.int32)
    rl = rng.randint(1, T + 1, (B,)).astype(np.int32)
    feed = {"h": hyps, "h@SEQLEN": hl, "r": refs, "r@SEQLEN": rl}
    res = []
    for P, E in ((jpt, jev), (pt, ev)):
        P.framework.reset_default_programs()
        h = P.layers.data("h", [1], dtype="int64", lod_level=1)
        r = P.layers.data("r", [1], dtype="int64", lod_level=1)
        dist, n = P.layers.edit_distance(h, r, normalized=False)
        d, = P.Executor(P.CPUPlace()).run(feed=feed, fetch_list=[dist],
                                          scope=P.Scope())
        e = E.EditDistance()
        e.update(d[:3])
        e.update(d[3:])
        res.append((np.asarray(d), e.eval()))
    np.testing.assert_array_equal(res[1][0], res[0][0])
    assert res[1][1] == res[0][1]
    assert res[1][1][1] > 0
