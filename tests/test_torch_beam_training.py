"""The beam-training cost (`cross_entropy_over_beam`, learning to search)
in the port against the JAX package and a brute force, on the CPU.

The three oracle cases of tests/test_beam_training.py (the gold on the
beam, the gold falling off at the first expansion, and the finite
difference check) through the legacy layer stack, in both packages on
the same feeds: the loss equals tests/test_beam_training.py's
independent brute-force path enumeration and the JAX package's within
1e-6, and the gradients of both score inputs equal the JAX package's
within 1e-6. A batch of several sequences with three expansions runs
through kmax_seq_score -> sub_nested_seq -> seq_slice as in the
reference's own beam config, loss and gradients against the JAX
package's. On the CPU the cost reads nothing from a device:
`beam.host_syncs` stays 0.
"""

import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu import trainer_config_helpers as jtch
import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor
from paddle_tpu_torch import trainer_config_helpers as ptch

TOL = 1e-6


@pytest.fixture(autouse=True)
def fresh():
    for P in (jpt, pt):
        P.framework.reset_default_programs()
    yield


def _brute_force_beam_loss(steps, K):
    """tests/test_beam_training.py's independent oracle: enumerate the
    candidate paths of the final valid expansion with explicit per-step
    gold tracking. steps: list of (rows: list of 1-D score arrays, ids
    [R, K], gold int)."""
    gold_rows, gold_cols = [0], []
    valid, fell = 0, False
    for i, (rows, ids, gold) in enumerate(steps):
        gr = gold_rows[i]
        valid += 1
        row_ids = [int(v) for v in ids[gr]] if gr < len(ids) else []
        if int(gold) not in [v for v in row_ids if v != -1]:
            fell = True
            break
        gc = row_ids.index(int(gold))
        gold_cols.append(gc)
        flat = [int(v) for v in np.asarray(ids).ravel()]
        gold_rows.append(sum(1 for v in flat[:gr * K + gc] if v != -1))
    last = valid - 1
    rows_l, ids_l, gold_l = steps[last]
    leaves = [(r, int(ids_l[r][c])) for r in range(len(ids_l))
              for c in range(K) if int(ids_l[r][c]) != -1]
    if fell:
        leaves.append((gold_rows[last], int(gold_l)))
        gold_path = len(leaves) - 1
    else:
        flat = [int(v) for v in np.asarray(ids_l).ravel()]
        upto = gold_rows[last] * K + gold_cols[last]
        gold_path = sum(1 for v in flat[:upto] if v != -1)
    totals = []
    for pidx, (r, cid) in enumerate(leaves):
        total = float(rows_l[r][cid])
        if fell and pidx == len(leaves) - 1:
            for b in range(last - 1, -1, -1):
                total += float(steps[b][0][gold_rows[b]][int(steps[b][2])])
        else:
            row = r
            for b in range(last - 1, -1, -1):
                ids_b = [int(v) for v in np.asarray(steps[b][1]).ravel()]
                total += float(steps[b][0][row // K][ids_b[row]])
                row //= K
        totals.append(total)
    z = np.asarray(totals, np.float64)
    p = np.exp(z - z.max())
    p /= p.sum()
    return -np.log(p[gold_path])


def _case_program(P, K, S1):
    L = P.layers
    tch = jtch if P is jpt else ptch
    s0 = L.data("s0", shape=[1], dtype="float32", lod_level=1,
                stop_gradient=False)
    i0 = L.data("i0", shape=[K], dtype="float32")
    g0 = L.data("g0", shape=[1], dtype="int64")
    s1 = L.data("s1", shape=[1], dtype="float32", lod_level=2,
                stop_gradient=False)
    i1 = L.data("i1", shape=[S1, K], dtype="float32")
    g1 = L.data("g1", shape=[1], dtype="int64")
    cost = tch.cross_entropy_over_beam(input=[
        tch.BeamInput(candidate_scores=s0, selected_candidates=i0,
                      gold=g0),
        tch.BeamInput(candidate_scores=s1, selected_candidates=i1,
                      gold=g1)])
    gs0, gs1 = P.backward.calc_gradient(cost, [s0, s1])
    return cost, gs0, gs1


def _run(P, fetch, feed):
    main = P.framework.default_main_program()
    return [np.asarray(v) for v in P.Executor(P.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch)]


CASES = {
    "gold_on_beam": dict(
        ids0=[1, 3, 0], gold0=3,
        scores1_rows=[[0.5, 0.1, 0.4], [0.9, 0.2], [0.3, 0.6, 0.7]],
        ids1=[[0, 2, -1], [1, -1, -1], [2, 0, -1]], gold1=1),
    "gold_falls_off": dict(
        ids0=[1, 3, 0], gold0=2,
        scores1_rows=[[0.5, 0.1], [0.9, 0.2], [0.3, 0.6]],
        ids1=[[0, -1, -1], [1, -1, -1], [0, 1, -1]], gold1=0),
}


def _feed(ids0, gold0, scores1_rows, ids1, gold1):
    T0, S1 = 5, len(scores1_rows)
    T1 = max(len(r) for r in scores1_rows)
    rng = np.random.RandomState(7)
    s0 = rng.randn(1, T0, 1).astype(np.float32)
    s1 = np.zeros((1, S1, T1, 1), np.float32)
    inner = np.zeros((1, S1), np.int64)
    for r, row in enumerate(scores1_rows):
        s1[0, r, :len(row), 0] = row
        inner[0, r] = len(row)
    return {"s0": s0, "s0@SEQLEN": np.asarray([T0], np.int64),
            "i0": np.asarray([ids0], np.float32),
            "g0": np.asarray([[gold0]], np.int64),
            "s1": s1, "s1@SEQLEN": np.asarray([S1], np.int64),
            "s1@SEQLEN@SUB": inner,
            "i1": np.asarray([ids1], np.float32),
            "g1": np.asarray([[gold1]], np.int64)}


def _both(case):
    c = CASES[case]
    feed = _feed(**c)
    outs = {}
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        fetch = _case_program(P, len(c["ids0"]), len(c["scores1_rows"]))
        outs[P] = _run(P, list(fetch), feed)
    return c, feed, outs[jpt], outs[pt]


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_cost_and_gradients_match_the_reference(case):
    monitor.reset()
    monitor.set_enabled(True)
    try:
        c, feed, (jl, jg0, jg1), (pl, pg0, pg1) = _both(case)
        syncs = monitor.snapshot().get("counters", {}).get(
            "beam.host_syncs", 0)
    finally:
        monitor.set_enabled(False)
        monitor.reset()
    assert syncs == 0
    steps = [([feed["s0"][0, :, 0]], np.asarray([c["ids0"]]), c["gold0"]),
             ([np.asarray(r, np.float64) for r in c["scores1_rows"]],
              np.asarray(c["ids1"]), c["gold1"])]
    want = _brute_force_beam_loss(steps, len(c["ids0"]))
    np.testing.assert_allclose(float(pl.ravel()[0]), want, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(pl, jl, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pg0, jg0, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pg1, jg1, rtol=TOL, atol=TOL)
    assert np.abs(pg0).sum() > 0


def test_beam_cost_finite_difference():
    """Analytic gradients (softmax minus one-hot scattered over the
    paths) match central differences of the port's own forward."""
    c = CASES["gold_on_beam"]
    feed = _feed(**c)
    cost, gs0, gs1 = _case_program(pt, 3, len(c["scores1_rows"]))
    _, g0, g1 = _run(pt, [cost, gs0, gs1], feed)

    def f(fd):
        return float(_run(pt, [cost], fd)[0].ravel()[0])

    eps = 1e-3
    rng = np.random.RandomState(3)
    for key, grad in (("s0", g0), ("s1", g1)):
        base = feed[key]
        for _ in range(4):
            idx = tuple(rng.randint(0, s) for s in base.shape)
            hi, lo = base.copy(), base.copy()
            hi[idx] += eps
            lo[idx] -= eps
            fd = (f({**feed, key: hi}) - f({**feed, key: lo})) / (2 * eps)
            np.testing.assert_allclose(grad[idx], fd, rtol=2e-3, atol=2e-4)


def _kmax_program(P, B, T, K):
    """Three chained expansions: the sentence scores and kmax over them;
    sub_nested_seq picks the selected sentences' word scores, kmax over
    those; seq_slice cuts a span from each selected word on, kmax over
    the spans' scores."""
    L = P.layers
    tch = jtch if P is jpt else ptch
    sent = L.data("sent", shape=[1], dtype="float32", lod_level=1,
                  stop_gradient=False)
    word = L.data("word", shape=[1], dtype="float32", lod_level=2,
                  stop_gradient=False)
    span = L.data("span", shape=[1], dtype="float32", lod_level=1,
                  stop_gradient=False)
    golds = [L.data(f"g{i}", shape=[1], dtype="int64") for i in range(3)]
    top_s = tch.kmax_seq_score_layer(input=sent, beam_size=K)
    picked = tch.sub_nested_seq_layer(input=word, selected_indices=top_s)
    top_w = tch.kmax_seq_score_layer(input=picked, beam_size=K)
    # one span row a selected word (-1: a dead row), in the order of
    # the selections, as the cost's row bookkeeping walks them
    starts = L.reshape(top_w, [-1, K * K])
    sliced = tch.seq_slice_layer(input=span, starts=starts, ends=None)
    top_e = tch.kmax_seq_score_layer(input=sliced, beam_size=K)
    cost = tch.cross_entropy_over_beam(input=[
        tch.BeamInput(candidate_scores=sent, selected_candidates=top_s,
                      gold=golds[0]),
        tch.BeamInput(candidate_scores=picked, selected_candidates=top_w,
                      gold=golds[1]),
        tch.BeamInput(candidate_scores=sliced, selected_candidates=top_e,
                      gold=golds[2])])
    grads = P.backward.calc_gradient(cost, [sent, word, span])
    return [cost] + list(grads)


def kmax_feed(rng, B, S, T, K):
    """B sequences of K to S sentences of K to T words and a span
    sequence of T to 3T scores. The cost's bookkeeping (the reference's)
    maps a row of one expansion to a slot of the previous one, so every
    expansion but the last selects K candidates in every row: at least
    K sentences and K words; a span from a word on is never empty, and
    may be shorter than K (-1 tails in the last expansion)."""
    outer = rng.randint(K, S + 1, size=B).astype(np.int64)
    inner = np.zeros((B, S), np.int64)
    for b in range(B):
        inner[b, :outer[b]] = rng.randint(K, T + 1, size=outer[b])
    spans = rng.randint(T, 3 * T + 1, size=B).astype(np.int64)
    return {"sent": rng.randn(B, S, 1).astype(np.float32),
            "sent@SEQLEN": outer,
            "word": rng.randn(B, S, T, 1).astype(np.float32),
            "word@SEQLEN": outer, "word@SEQLEN@SUB": inner,
            "span": rng.randn(B, 3 * T, 1).astype(np.float32),
            "span@SEQLEN": spans,
            "g0": rng.randint(0, 2, size=(B, 1)).astype(np.int64),
            "g1": rng.randint(0, 2, size=(B, 1)).astype(np.int64),
            "g2": rng.randint(0, 2, size=(B, 1)).astype(np.int64)}


def test_three_expansions_through_kmax_match_the_reference():
    B, S, T, K = 6, 5, 4, 3
    feed = kmax_feed(np.random.RandomState(11), B, S, T, K)
    outs = {}
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        outs[P] = _run(P, _kmax_program(P, B, T, K), feed)
    for j, p in zip(outs[jpt], outs[pt]):
        assert j.shape == p.shape
        np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)
    assert np.isfinite(outs[pt][0]).all()
