"""The CTR models (wide&deep, DeepFM) in the port against the JAX
package, on the CPU.

Both packages build the same programs (with and without the EP sharding
hint `ep_axis`); the port trains from the reference's initialised scope
(`weights.scope_from_numpy`) for 5 Adam steps under
`sparse_grad=selected_rows` and under `auto` (which dense-dispatches
these small unsharded tables). Losses and every parameter are held to
TOL = 1e-5 of each array's largest element: the same float32 math, the
two packages' matmul / reduction rounding and the port's summing of a
row's gradients before the update (the reference scatters them) differ
in the last places. The twins of tests/test_sparse.py's CTR training
test use the same data, steps and threshold; the health fetch of a
sparse step, the input pipeline and the in-graph AUC ride the same
models.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.models  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.weights import scope_from_numpy

TOL = 1e-5
B, F, VOCAB = 64, 8, 200
MODELS = ("wide_deep", "deepfm")


@pytest.fixture(autouse=True)
def clean_flags():
    for P in (jpt, pt):
        P.flags.reset()
        P.framework.reset_default_programs()
    yield
    for P in (jpt, pt):
        P.flags.reset()


def _ctr_batch(rng, B=B, F=F, vocab=VOCAB):
    ids = rng.randint(0, vocab, (B, F)).astype(np.int64)
    # clickable iff field-0 id is even (learnable from the embeddings)
    label = (ids[:, 0] % 2 == 0).astype(np.float32)[:, None]
    dense = rng.rand(B, 4).astype(np.float32)
    return {"ids": ids, "dense": dense, "label": label}


def _build(P, model, ep_axis=None, lr=0.01):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        ids = P.layers.data("ids", [F], dtype="int64")
        dense = P.layers.data("dense", [4])
        label = P.layers.data("label", [1])
        logits = getattr(P.models.ctr, model)(
            ids, VOCAB, F, emb_dim=8, hidden=(16,), dense_input=dense,
            ep_axis=ep_axis)
        cost = P.models.ctr.ctr_cost(logits, label)
        P.AdamOptimizer(lr).minimize(cost, startup_program=startup)
    return main, startup, cost, logits


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("ep_axis", [None, "ep"])
@pytest.mark.parametrize("model", MODELS)
def test_program_text_equals_jax_front_end(model, ep_axis):
    jmain, jstart, _, _ = _build(jpt, model, ep_axis)
    pmain, pstart, _, _ = _build(pt, model, ep_axis)
    assert pmain.to_dict() == jmain.to_dict()
    assert pstart.to_dict() == jstart.to_dict()
    tables = [v for v in pmain.global_block().vars.values()
              if v.name.endswith("_emb") and v.persistable]
    assert tables
    for v in tables:
        jv = jmain.global_block().var(v.name)
        assert v.sharding == jv.sharding == (
            None if ep_axis is None else ("ep", None))


def _carried(jstart):
    """The JAX package's initialised scope, and the port's copy of it."""
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    pscope = scope_from_numpy({k: np.array(v) for k, v in jscope.vars.items()
                               if not k.startswith("__")}, "cpu")
    return jexe, jscope, pscope


@pytest.mark.parametrize("mode", ["selected_rows", "auto"])
@pytest.mark.parametrize("model", MODELS)
def test_training_matches_jax_package(model, mode):
    """5 Adam steps from the reference's weights: losses and every
    parameter and accumulator within TOL of the JAX package's, and the
    dispatch counters show the path taken."""
    for P in (jpt, pt):
        P.flags.set_flag("sparse_grad", mode)
    feed = _ctr_batch(np.random.RandomState(2))
    jmain, jstart, jcost, _ = _build(jpt, model)
    pmain, _, pcost, _ = _build(pt, model)
    jexe, jscope, pscope = _carried(jstart)
    pexe = pt.Executor(pt.CPUPlace())
    pt.monitor.reset()
    pt.monitor.set_enabled(True)
    try:
        jl, pl = [], []
        for _ in range(5):
            jl.append(jexe.run(jmain, feed=feed, fetch_list=[jcost],
                               scope=jscope)[0])
            pl.append(pexe.run(pmain, feed=feed, fetch_list=[pcost],
                               scope=pscope)[0])
        counters = pt.monitor.snapshot().get("counters", {})
    finally:
        pt.monitor.set_enabled(False)
        pt.monitor.reset()
    assert _rel(pl, jl) <= TOL, (pl, jl)
    assert pl[-1] < pl[0]
    sparse = counters.get("sparse.selected_rows", 0)
    dense = counters.get("sparse.dense_dispatch", 0)
    assert (sparse, dense) == ((10, 0) if mode == "selected_rows"
                               else (0, 10))
    for name in pmain.global_block().vars:
        if jscope.has(name) and not name.startswith("__"):
            assert _rel(pscope.get(name).numpy(),
                        np.array(jscope.get(name))) <= TOL, name


@pytest.mark.parametrize("model", MODELS)
def test_ctr_models_train(model):
    """The twin of tests/test_sparse.py's CTR training test, in the
    port with its own initialisation (the default `auto` dispatch)."""
    feed = _ctr_batch(np.random.RandomState(2))
    main, startup, cost, _ = _build(pt, model)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    first = last = None
    for _ in range(60):
        loss, = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        last = float(loss.ravel()[0])
        first = last if first is None else first
    assert last < first * 0.6, (first, last)


def test_health_of_a_sparse_step_matches_jax_package():
    """`__health.grad_norm__` with SelectedRows table gradients (the
    duplicates summed before squaring, as the reference's densified
    norm) and the update ratios, against the JAX package's."""
    from paddle_tpu_torch.monitor import health
    for P in (jpt, pt):
        P.flags.set_flag("sparse_grad", "selected_rows")
    feed = _ctr_batch(np.random.RandomState(6))
    jmain, jstart, jcost, _ = _build(jpt, "deepfm")
    pmain, _, pcost, _ = _build(pt, "deepfm")
    jexe, jscope, pscope = _carried(jstart)
    fetch = [health.GRAD_NORM, health.PARAM_NORM, health.UPDATE_RATIOS]
    jout = jexe.run(jmain, feed=feed, fetch_list=[jcost] + fetch,
                    scope=jscope)
    pout = pt.Executor(pt.CPUPlace()).run(
        pmain, feed=feed, fetch_list=[pcost] + fetch, scope=pscope)
    for name, j, p in zip(["loss"] + fetch, jout, pout):
        assert _rel(p, j) <= TOL, name


def test_hostfed_training_through_the_device_feeder():
    """bench.py's host-fed CTR row on the CPU: three batches cycled
    through the DeviceFeeder train bit for bit like the same batches fed
    directly."""
    pt.flags.set_flag("sparse_grad", "selected_rows")
    rng = np.random.RandomState(7)
    pool = [_ctr_batch(rng) for _ in range(3)]
    results = []
    for hostfed in (False, True):
        main, startup, cost, _ = _build(pt, "wide_deep")
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        if hostfed:
            feeder = pt.reader.DeviceFeeder(lambda: iter(pool * 2), main,
                                            exe)
            feeds = list(feeder)
        else:
            feeds = pool * 2
        losses = [float(exe.run(main, feed=f, fetch_list=[cost],
                                scope=scope)[0].ravel()[0]) for f in feeds]
        results.append((losses, scope.get("deep_emb").clone()))
    assert results[0][0] == results[1][0]
    assert torch.equal(results[0][1], results[1][1])


def test_ingraph_auc_scores_a_ctr_pass():
    """InGraphAuc over the sigmoid of wide&deep's logits, accumulated in
    the training step over 4 batches: its histograms equal a numpy
    histogram of the fetched scores exactly, its AUC the host Auc's
    within 1e-6."""
    from paddle_tpu_torch import evaluator
    pt.flags.set_flag("sparse_grad", "selected_rows")
    pt.framework.reset_default_programs()
    main, startup = pt.framework.default_main_program(), \
        pt.framework.default_startup_program()
    ids = pt.layers.data("ids", [F], dtype="int64")
    dense = pt.layers.data("dense", [4])
    label = pt.layers.data("label", [1])
    logits = pt.models.ctr.wide_deep(ids, VOCAB, F, emb_dim=8,
                                     hidden=(16,), dense_input=dense)
    cost = pt.models.ctr.ctr_cost(logits, label)
    score = pt.layers.sigmoid(logits)
    auc = evaluator.InGraphAuc(scores=score, labels=label,
                               num_thresholds=200)
    pt.AdamOptimizer(0.01).minimize(cost)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    host = evaluator.Auc(num_thresholds=200)
    want = np.zeros((2, 201), np.float32)
    rng = np.random.RandomState(8)
    for _ in range(4):
        feed = _ctr_batch(rng)
        s, = exe.run(main, feed=feed, fetch_list=[score], scope=scope)
        host.update(s, feed["label"])
        # the graph's bucket: floor(clip(score, 0, 1) * 200) in float32
        idx = np.floor(np.clip(s, 0, 1) * np.float32(200)).astype(np.int64)
        np.add.at(want, (1 - feed["label"].astype(np.int64).ravel(),
                         idx.ravel()), 1)
    pos, neg = (scope.get(v.name).numpy() for v in auc.states)
    np.testing.assert_array_equal(pos, want[0])
    np.testing.assert_array_equal(neg, want[1])
    assert abs(auc.eval(exe, scope) - host.eval()) <= 1e-6
