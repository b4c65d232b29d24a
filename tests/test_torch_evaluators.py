"""The evaluators and their ops in the port, on the CPU.

Twins of tests/test_ingraph_evaluators.py's accuracy pass loop, in-graph
AUC, precision-recall, chunk, pnpair and detection-mAP tests and of
tests/test_evaluators_profiler.py's precision-recall, AUC and
training-pass-loop tests (the pass loop scores with the port's host
Accuracy, PrecisionRecall and Auc, as the reference's scores with
PrecisionRecall and Auc); the host ChunkEvaluator, EditDistance,
PrecisionRecall, PnpairEvaluator and DetectionMAP against the JAX
package's, and the in-graph chunk, precision-recall, pnpair and mAP
states against the host's and the JAX package's, exactly.
The ops against the JAX package's lowerings on the same numpy inputs:
`topk` and `accuracy` exactly, ties included (the lower index first,
as jax.lax.top_k); `scatter_add_1d` exactly (counts below 2^24 add
exactly in float32), out-of-range indices dropped; `pnpair_eval` and
`detection_map_buckets` exactly, with tied scores (the mAP matcher's
stable order decides which tied detection takes a ground truth);
`auc_from_histograms` within 1e-6. Histogram counts and accuracy counts
are exact; an AUC is held to 1e-6, a precision, recall or F1 and a pnpair
ratio to 1e-6 relative.
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
    each pass by the host Accuracy (from the batches' accuracy fetch),
    PrecisionRecall (from the argmax ids) and Auc: accuracy > 0.9, macro
    F1 > 0.9, AUC > 0.95 at the end."""
    rng = np.random.RandomState(1)
    n, d = 256, 8
    w_true = rng.randn(d)
    x_np = rng.randn(n, d).astype(np.float32)
    y_np = (x_np @ w_true > 0).astype(np.int64)[:, None]

    x = pt.layers.data(name="x", shape=[d], dtype="float32")
    y = pt.layers.data(name="y", shape=[1], dtype="int64")
    probs = pt.layers.fc(x, 2, act="softmax")
    cost = pt.layers.mean(pt.layers.cross_entropy(probs, y))
    pred_id = pt.layers.argmax(probs, axis=-1)
    acc = ev.Accuracy(input=probs, label=y)
    pt.SGDOptimizer(learning_rate=0.5).minimize(cost)

    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    pr = ev.PrecisionRecall(num_classes=2)
    auc = ev.Auc()
    for _ in range(15):
        acc.reset()
        pr.reset()
        auc.reset()
        for i in range(0, n, 64):
            feed = {"x": x_np[i:i + 64], "y": y_np[i:i + 64]}
            p_v, ids, a_v = exe.run(
                feed=feed, fetch_list=[probs, pred_id] + acc.metrics,
                scope=scope)
            acc.update(a_v, 64)
            pr.update(ids, y_np[i:i + 64])
            auc.update(p_v[:, 1], y_np[i:i + 64])
    assert acc.eval() > 0.9, acc.eval()
    macro_p, macro_r, macro_f1 = pr.eval()
    assert macro_f1 > 0.9, (macro_p, macro_r, macro_f1)
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


def test_precision_recall_matches_manual():
    """The twin of the reference's hand-counted PrecisionRecall case."""
    e = ev.PrecisionRecall(num_classes=3)
    pred = [0, 0, 1, 2, 2, 1, 0]
    lab = [0, 1, 1, 2, 1, 1, 0]
    e.update(pred[:4], lab[:4])
    e.update(pred[4:], lab[4:])
    p, r, f1 = e.stats()
    np.testing.assert_allclose(p[0], 2 / 3)
    np.testing.assert_allclose(r[0], 1.0)
    np.testing.assert_allclose(p[1], 1.0)
    np.testing.assert_allclose(r[1], 0.5)
    macro_p, macro_r, macro_f1 = e.eval()
    assert 0 < macro_f1 <= 1


def _det_batch(rng, B, K, G, C, Nb, tied=False):
    """A detection-mAP batch (the reference test's construction): scores
    at bucket centres (distinct, or with `tied` drawn from 12 values so
    equal scores compete for one ground truth), 20 % padding rows, boxes
    of side 0.3 in the top-left quarter."""
    det = np.zeros((B, K, 6), np.float32)
    if tied:
        scores = (rng.randint(1, 13, (B, K)) * 40 + 0.5) / Nb
    else:
        scores = (rng.choice(np.arange(1, 500), size=(B, K), replace=False)
                  + 0.5) / Nb
    for b in range(B):
        for k in range(K):
            if rng.rand() < 0.2:
                det[b, k, 0] = -1
                continue
            det[b, k, 0] = rng.randint(1, C)
            det[b, k, 1] = scores[b, k]
            x, y = rng.rand(2) * 0.5
            det[b, k, 2:6] = [x, y, x + 0.3, y + 0.3]
    gtb = np.zeros((B, G, 4), np.float32)
    gtl = np.zeros((B, G, 1), np.int64)
    cnt = rng.randint(1, G + 1, (B,)).astype(np.int64)
    for b in range(B):
        for g in range(int(cnt[b])):
            gtl[b, g, 0] = rng.randint(1, C)
            x, y = rng.rand(2) * 0.5
            gtb[b, g] = [x, y, x + 0.3, y + 0.3]
    return det, gtb, gtl, cnt


def _build_and_compare(build):
    """`build(P)` in both packages from fresh default programs: equal
    main, startup, eval and reset Program dicts. Returns the port's
    evaluator and its tensors, and the JAX package's evaluator."""
    jpt.framework.reset_default_programs()
    jres = build(jpt)
    jdicts = [p.to_dict() for p in (jpt.default_main_program(),
                                    jpt.default_startup_program(),
                                    jres[0].eval_program,
                                    jres[0].reset_program)]
    pt.framework.reset_default_programs()
    pres = build(pt)
    assert [p.to_dict() for p in (pt.default_main_program(),
                                  pt.default_startup_program(),
                                  pres[0].eval_program,
                                  pres[0].reset_program)] == jdicts
    return pres, jres


def _run_both_packages(feeds, fetch_names, pres, jres):
    """Both packages' main programs over the same feeds, the port from
    the JAX package's startup state; returns (port exe, scope, JAX exe,
    scope, per-batch port fetches)."""
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jpt.default_startup_program(), scope=jscope)
    pscope = scope_from_numpy({k: np.array(v) for k, v in jscope.vars.items()
                               if not k.startswith("__")}, "cpu")
    pexe = pt.Executor(pt.CPUPlace())
    got = []
    for feed in feeds:
        got.append(pexe.run(pt.default_main_program(), feed=feed,
                            fetch_list=fetch_names, scope=pscope))
        jexe.run(jpt.default_main_program(), feed=feed,
                 fetch_list=fetch_names, scope=jscope)
    for st in pres[0].states:
        np.testing.assert_array_equal(pscope.get(st.name).numpy(),
                                      np.asarray(jscope.get(st.name)))
    return pexe, pscope, jexe, jscope, got


def test_ingraph_precision_recall_matches_host():
    """4 batches of an argmax classifier: the tp / fp / fn states equal
    the JAX package's exactly, eval() the host PrecisionRecall's within
    1e-6 and the JAX evaluator's exactly; reset() zeroes them."""
    nc = 4

    def build(P):
        x = P.layers.data("x", [8])
        label = P.layers.data("label", [1], dtype="int64")
        probs = P.layers.fc(input=x, size=nc, act="softmax")
        pred = P.layers.argmax(probs, axis=1)
        P.layers.mean(P.layers.cross_entropy(probs, label))
        return (P.evaluator.InGraphPrecisionRecall(
            pred_ids=pred, label_ids=label, num_classes=nc), pred)

    pres, jres = _build_and_compare(build)
    rng = np.random.RandomState(2)
    feeds = [{"x": rng.randn(16, 8).astype(np.float32),
              "label": rng.randint(0, nc, (16, 1)).astype(np.int64)}
             for _ in range(4)]
    pexe, pscope, jexe, jscope, got = _run_both_packages(
        feeds, [pres[1].name], pres, jres)
    host = ev.PrecisionRecall(nc)
    for feed, (p,) in zip(feeds, got):
        host.update(np.asarray(p), feed["label"])
    tp, fp, fn = (pscope.get(s.name).numpy() for s in pres[0].states)
    np.testing.assert_array_equal(tp, host.tp)
    np.testing.assert_array_equal(fp, host.fp)
    np.testing.assert_array_equal(fn, host.fn)
    got_pr = pres[0].eval(pexe, pscope)
    np.testing.assert_allclose(got_pr, host.eval(), atol=1e-6)
    assert got_pr == jres[0].eval(jexe, jscope)
    pres[0].reset(pexe, pscope)
    assert pres[0].eval(pexe, pscope) == (0.0, 0.0, 0.0)


def test_ingraph_pnpair_matches_host_golden():
    """Query-grouped ranking batches with tied scores and labels: the
    pos / neg / spe states equal the JAX package's and the host
    PnpairEvaluator's counts exactly, eval() the host's within 1e-6
    relative; reset() gives 0."""

    def build(P):
        sv = P.layers.data("s", [1])
        yv = P.layers.data("y", [1])
        qv = P.layers.data("q", [1], dtype="int64")
        dummy = P.layers.mean(sv)
        return P.evaluator.InGraphPnpair(score=sv, label=yv,
                                         query_id=qv), dummy

    pres, jres = _build_and_compare(build)
    rng = np.random.RandomState(5)
    feeds = []
    for i in range(4):
        s = rng.randn(40, 1).astype(np.float32)
        if i % 2:
            s = np.round(s).astype(np.float32)        # tied scores
        feeds.append({"s": s,
                      "y": rng.randint(0, 3, (40, 1)).astype(np.float32),
                      "q": rng.randint(0, 5, (40, 1)).astype(np.int64)})
    pexe, pscope, jexe, jscope, _ = _run_both_packages(
        feeds, [pres[1].name], pres, jres)
    host = ev.PnpairEvaluator()
    for f in feeds:
        host.update(f["s"], f["y"], f["q"])
    counts = [float(pscope.get(s.name).numpy()[0]) for s in pres[0].states]
    assert counts == [host.pos, host.neg, host.spe] and host.spe > 0
    np.testing.assert_allclose(pres[0].eval(pexe, pscope), host.eval(),
                               rtol=1e-6)
    pres[0].reset(pexe, pscope)
    assert pres[0].eval(pexe, pscope) == 0.0


def test_ingraph_detection_map_matches_host_golden():
    """3 batches of padded detections with scores on bucket centres: the
    tp / fp histograms and positive counts equal the JAX package's
    exactly, the mAP the host DetectionMAP's within 1e-6 relative."""
    B, K, G, C, Nb = 3, 8, 5, 4, 512

    def build(P):
        dv = P.layers.data("det", [8, 6])
        bv = P.layers.data("gtb", [5, 4])
        lv = P.layers.data("gtl", [5, 1], dtype="int64")
        cv = P.layers.data("cnt", [1], dtype="int64")
        dummy = P.layers.mean(dv)
        return P.evaluator.InGraphDetectionMAP(
            dv, bv, lv, gt_count=cv, num_classes=C, num_buckets=Nb), dummy

    pres, jres = _build_and_compare(build)
    rng = np.random.RandomState(6)
    batches = [_det_batch(rng, B, K, G, C, Nb) for _ in range(3)]
    feeds = [{"det": d, "gtb": b, "gtl": l, "cnt": c}
             for d, b, l, c in batches]
    pexe, pscope, jexe, jscope, _ = _run_both_packages(
        feeds, [pres[1].name], pres, jres)
    host = ev.DetectionMAP()
    for d, b, l, c in batches:
        host.update(d, b, l[..., 0], c)
    got = pres[0].eval(pexe, pscope)
    np.testing.assert_allclose(got, host.eval(), rtol=1e-6, atol=1e-9)
    assert got == jres[0].eval(jexe, jscope)
    assert 0.0 < got <= 1.0


def test_host_precision_recall_pnpair_and_map_equal_jax_package():
    """The three host evaluators fed the same batches in both packages:
    every accumulator and eval() equal exactly (Pnpair with tied scores
    and a batch of one query, DetectionMAP in both AP versions with tied
    scores, with and without gt counts)."""
    rng = np.random.RandomState(8)
    a, b = ev.PrecisionRecall(5), jev.PrecisionRecall(5)
    for _ in range(6):
        p, lab = rng.randint(0, 5, 30), rng.randint(0, 5, (30, 1))
        a.update(p, lab)
        b.update(p, lab)
    for n in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(getattr(a, n), getattr(b, n))
    assert a.eval() == b.eval()
    np.testing.assert_array_equal(a.stats(), b.stats())

    a, b = ev.PnpairEvaluator(), jev.PnpairEvaluator()
    for _ in range(3):
        s = np.round(rng.randn(50) * 2) / 2
        y, q = rng.randint(0, 3, 50), rng.randint(0, 4, 50)
        a.update(s, y, q)
        b.update(s, y, q)
    s, y = rng.rand(9), rng.randint(0, 2, 9)
    a.update(s, y)
    b.update(s, y)
    assert (a.pos, a.neg, a.spe) == (b.pos, b.neg, b.spe)
    assert a.eval() == b.eval() and a.spe > 0

    for version in ("integral", "11point"):
        a = ev.DetectionMAP(overlap_threshold=0.3, ap_version=version)
        b = jev.DetectionMAP(overlap_threshold=0.3, ap_version=version)
        for i in range(3):
            d, gb, gl, c = _det_batch(rng, 3, 8, 5, 4, 512, tied=True)
            counts = c if i % 2 else None
            a.update(d, gb, gl[..., 0], counts)
            b.update(d, gb, gl[..., 0], counts)
        assert a._gt_count == b._gt_count and a._dets == b._dets
        assert a.eval() == b.eval() > 0


def test_pnpair_eval_matches_jax_package_with_ties():
    """pnpair_eval's three counts equal the JAX lowering's exactly, with
    tied scores and labels, weights that drop rows and a chunk size that
    does not divide N."""
    rng = np.random.RandomState(9)
    N = 700
    ins = {"Score": np.round(rng.randn(N, 1) * 2).astype(np.float32),
           "Label": rng.randint(0, 3, (N, 1)).astype(np.float32),
           "QueryId": rng.randint(0, 6, (N, 1)).astype(np.int64),
           "Weight": (rng.rand(N, 1) > 0.1).astype(np.float32)}
    for attrs in ({}, {"chunk_rows": 96}):
        for drop in ((), ("Weight",), ("Weight", "QueryId")):
            case = {k: v for k, v in ins.items() if k not in drop}
            jout, pout = _both("pnpair_eval", case, attrs)
            for slot in ("Pos", "Neg", "Spe"):
                p, j = pout[slot][0].numpy(), np.asarray(jout[slot][0])
                assert p.shape == j.shape == (1,) and p.dtype == j.dtype
                np.testing.assert_array_equal(p, j)
            assert float(pout["Spe"][0][0]) > 0


@pytest.mark.parametrize("tied", [False, True])
def test_detection_map_buckets_matches_jax_package(tied):
    """detection_map_buckets' TpHist / FpHist / PosCount equal the JAX
    lowering's exactly; with `tied`, equal scores compete for one ground
    truth and the stable descending order decides the winner. Also
    without GtCount, and a gt label of -1 and one of C (left out)."""
    rng = np.random.RandomState(10 + tied)
    B, K, G, C, Nb = 4, 12, 5, 4, 64
    d, gb, gl, c = _det_batch(rng, B, K, G, C, Nb, tied=tied)
    gl[0, 0, 0], gl[1, 0, 0] = -1, C
    d[2, 0, 0] = C                            # a detection label past C
    attrs = {"num_classes": C, "num_buckets": Nb, "overlap_threshold": 0.3,
             "background_label": 0}
    for ins in ({"Detections": d, "GtBoxes": gb, "GtLabels": gl,
                 "GtCount": c}, {"Detections": d, "GtBoxes": gb,
                                 "GtLabels": gl[..., 0]}):
        jout, pout = _both("detection_map_buckets", ins, attrs)
        for slot in ("TpHist", "FpHist", "PosCount"):
            p, j = pout[slot][0].numpy(), np.asarray(jout[slot][0])
            assert p.shape == j.shape and p.dtype == j.dtype == np.float32
            np.testing.assert_array_equal(p, j)
        assert pout["TpHist"][0].sum() > 0 and pout["FpHist"][0].sum() > 0
