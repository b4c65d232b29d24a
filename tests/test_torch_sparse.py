"""SelectedRows sparse gradients in the port, on the CPU.

The port twin of tests/test_sparse.py (without its 8-device EP test:
one card has no mesh). The oracle is the reference's: is_sparse=True
training equals dense training (rtol 1e-5, atol 1e-6: the same math,
the duplicate rows summed before the update instead of scattered one
by one), lazy Adam leaves untouched rows bitwise alone, and the
`sparse_grad` dispatch picks the path the reference picks (auto trains
bit for bit like is_sparse=False). Batches hold duplicate ids, so the
merge has padding slots, and the CPU's index ops raise on an
out-of-range index: a padding sentinel reaching one would fail these
tests (one spies on the index ops too).

Each sparse op is also held against the JAX package's lowering on the
same numpy inputs: merge_rows's layout exactly and its sums within
1e-6 of the largest; the four sparse updates, `sum` over SelectedRows
(all sparse and mixed) and the lookup_table gradient within RTOL =
1e-6 of each array's largest element (both compute in float32; the
port sums a row's gradients before the update, the reference's sgd
scatters them one by one).
"""

import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu_torch import flags
from paddle_tpu_torch.ops import registry as op_registry
from paddle_tpu_torch.selected_rows import (SelectedRows, merge_rows,
                                            row_sums)

RTOL = 1e-6


@pytest.fixture(autouse=True)
def clean_flags():
    """Both packages' flags and monitors start from their defaults."""
    flags.reset()
    jpt.flags.reset()
    yield
    flags.reset()
    jpt.flags.reset()
    pt.monitor.set_enabled(False)
    pt.monitor.reset()


def assert_close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale, what


def test_selected_rows_to_dense_and_merge():
    rows = torch.tensor([2, 0, 2, 5], dtype=torch.int32)
    vals = torch.tensor([[1.0], [2.0], [3.0], [4.0]])
    sr = SelectedRows(rows, vals, 6)
    want = np.zeros((6, 1), np.float32)
    want[2] = 4.0  # 1 + 3
    want[0] = 2.0
    want[5] = 4.0
    np.testing.assert_array_equal(sr.to_dense().numpy(), want)

    uniq, summed = merge_rows(sr)
    assert uniq.tolist() == [0, 2, 5, 6]          # padding: the height
    np.testing.assert_array_equal(summed.numpy(),
                                  [[2.0], [4.0], [4.0], [0.0]])
    r, s = row_sums(sr)
    assert r.tolist() == [0, 2, 2, 5]
    np.testing.assert_array_equal(s.numpy(), [[2.0], [4.0], [4.0], [4.0]])


def test_merge_and_to_dense_match_the_jax_package():
    """Many duplicates (ids in [0, 7) of a height-40 table, 3 x 20
    lookups): merge_rows's unique rows and padding equal the
    reference's, its sums and the dense form within RTOL."""
    import jax.numpy as jnp
    from paddle_tpu.selected_rows import SelectedRows as JRows
    from paddle_tpu.selected_rows import merge_rows as jmerge
    rng = np.random.RandomState(5)
    rows = rng.randint(0, 7, 60).astype(np.int32)
    vals = rng.randn(60, 3).astype(np.float32)
    j = JRows(jnp.asarray(rows), jnp.asarray(vals), 40)
    p = SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals), 40)
    juniq, jsum = jmerge(j)
    uniq, summed = merge_rows(p)
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(juniq))
    assert int((uniq == 40).sum()) == 60 - len(set(rows.tolist()))
    assert_close(summed.numpy(), np.asarray(jsum), "merged sums")
    assert_close(p.to_dense().numpy(), np.asarray(j.to_dense()), "dense")


def _train_embedding_model(optimizer_factory, is_sparse, ids, labels,
                           vocab, dim, steps=5):
    """Tiny bag-of-ids regressor; returns (losses, final table)."""
    pt.framework.reset_default_programs()
    x = pt.layers.data("ids", [ids.shape[1]], dtype="int64")
    y = pt.layers.data("y", [1])
    emb = pt.layers.embedding(input=x, size=[vocab, dim],
                              is_sparse=is_sparse,
                              param_attr=pt.ParamAttr(name="table"))
    pooled = pt.layers.reduce_sum(emb, dim=1)           # [B, dim]
    pred = pt.layers.fc(input=pooled, size=1,
                        param_attr=pt.ParamAttr(name="head.w"),
                        bias_attr=pt.ParamAttr(name="head.b"))
    cost = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    optimizer_factory().minimize(cost)
    pt.default_startup_program().seed = 3
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    losses = []
    for _ in range(steps):
        loss, = exe.run(feed={"ids": ids, "y": labels}, fetch_list=[cost],
                        scope=scope)
        losses.append(float(loss.ravel()[0]))
    return losses, scope.get("table").numpy()


OPTIMIZERS = {
    "sgd": lambda: pt.SGDOptimizer(0.1),
    "adam": lambda: pt.AdamOptimizer(0.01),
    "adagrad": lambda: pt.AdagradOptimizer(0.05),
    "momentum": lambda: pt.MomentumOptimizer(0.05, 0.9),
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_sparse_matches_dense_training(opt):
    rng = np.random.RandomState(0)
    vocab, dim, B, F = 50, 4, 8, 6
    # duplicates within rows AND across the batch
    ids = rng.randint(0, 12, (B, F)).astype(np.int64)
    labels = rng.randn(B, 1).astype(np.float32)
    dense_losses, dense_w = _train_embedding_model(
        OPTIMIZERS[opt], False, ids, labels, vocab, dim)
    # force the SelectedRows path (auto would dense-dispatch this small
    # unsharded table and test nothing)
    flags.set_flag("sparse_grad", "selected_rows")
    sparse_losses, sparse_w = _train_embedding_model(
        OPTIMIZERS[opt], True, ids, labels, vocab, dim)
    np.testing.assert_allclose(sparse_losses, dense_losses, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(sparse_w, dense_w, rtol=1e-5, atol=1e-6)


def test_sparse_untouched_rows_stay_put_under_adam():
    """Lazy sparse Adam: rows never looked up keep their bits."""
    rng = np.random.RandomState(1)
    vocab, dim, B, F = 30, 4, 4, 3
    ids = rng.randint(0, 5, (B, F)).astype(np.int64)   # touch rows 0..4
    labels = rng.randn(B, 1).astype(np.float32)
    flags.set_flag("sparse_grad", "selected_rows")
    adam = OPTIMIZERS["adam"]
    _, w = _train_embedding_model(adam, True, ids, labels, vocab, dim,
                                  steps=3)
    _, w0 = _train_embedding_model(adam, True, ids, labels, vocab, dim,
                                   steps=0)
    np.testing.assert_array_equal(w[5:], w0[5:])        # untouched rows
    assert np.abs(w[:5] - w0[:5]).max() > 0             # touched rows moved


def test_no_padding_sentinel_reaches_an_index_op(monkeypatch):
    """A batch of 12 lookups over 4 distinct ids (8 padding slots in the
    merge) through each sparse update: every index handed to
    index_select / index_copy_ is a real row of the table."""
    seen = []
    for name in ("index_select", "index_copy_"):
        real = getattr(torch.Tensor, name)

        def spy(self, dim, index, *a, _real=real, **k):
            seen.append((int(index.min()), int(index.max()),
                         self.shape[dim]))
            return _real(self, dim, index, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    ids = np.asarray([[3, 1, 3], [7, 1, 3], [3, 7, 9], [9, 9, 1]], np.int64)
    labels = np.ones((4, 1), np.float32)
    flags.set_flag("sparse_grad", "selected_rows")
    for opt in sorted(OPTIMIZERS):
        _train_embedding_model(OPTIMIZERS[opt], True, ids, labels, 10, 2,
                               steps=2)
    assert seen
    assert all(0 <= lo and hi < n for lo, hi, n in seen), seen


# ---- sparse auto-dispatch ------------------------------------------------

def _dispatch_counters(sparse_grad_mode, vocab=40, sharding=None):
    """One sparse-embedding train step under the given sparse_grad mode;
    the monitor's (dense_dispatch, selected_rows) tallies."""
    pt.monitor.reset()
    flags.set_flag("metrics", True)
    if sparse_grad_mode is not None:
        flags.set_flag("sparse_grad", sparse_grad_mode)
    rng = np.random.RandomState(0)
    ids_np = rng.randint(0, vocab, (4, 3)).astype(np.int64)
    y_np = rng.randn(4, 1).astype(np.float32)
    pt.framework.reset_default_programs()
    x = pt.layers.data("ids", [3], dtype="int64")
    y = pt.layers.data("y", [1])
    attr = pt.ParamAttr(name="table")
    if sharding is not None:
        attr.sharding = sharding
    emb = pt.layers.embedding(input=x, size=[vocab, 4], is_sparse=True,
                              param_attr=attr)
    pred = pt.layers.fc(input=pt.layers.reduce_sum(emb, dim=1), size=1)
    cost = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    pt.SGDOptimizer(0.1).minimize(cost)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    exe.run(feed={"ids": ids_np, "y": y_np}, fetch_list=[cost], scope=scope)
    counters = pt.monitor.snapshot().get("counters", {})
    return (counters.get("sparse.dense_dispatch", 0),
            counters.get("sparse.selected_rows", 0))


def test_auto_dispatch_lowers_small_unsharded_table_to_dense():
    dense, sr = _dispatch_counters(None)
    assert dense >= 1 and sr == 0


def test_auto_dispatch_keeps_selected_rows_for_sharded_table():
    """The sharding hint keeps SelectedRows semantics under auto."""
    dense, sr = _dispatch_counters(None, sharding=("ep", None))
    assert sr >= 1 and dense == 0


def test_sparse_grad_flag_forces_either_path():
    dense, sr = _dispatch_counters("selected_rows")
    assert sr >= 1 and dense == 0
    dense, sr = _dispatch_counters("dense", sharding=("ep", None))
    assert dense >= 1 and sr == 0


def _train_varying_ids(is_sparse, opt_factory, steps=4):
    """Embedding regressor fed a different id batch every step: where
    lazy (SelectedRows) and dense stateful optimizers diverge."""
    rng = np.random.RandomState(9)
    batches = [(rng.randint(0, 20, (4, 3)).astype(np.int64),
                rng.randn(4, 1).astype(np.float32))
               for _ in range(steps)]
    pt.framework.reset_default_programs()
    x = pt.layers.data("ids", [3], dtype="int64")
    y = pt.layers.data("y", [1])
    emb = pt.layers.embedding(input=x, size=[20, 4], is_sparse=is_sparse,
                              param_attr=pt.ParamAttr(name="table"))
    pred = pt.layers.fc(input=pt.layers.reduce_sum(emb, dim=1), size=1,
                        param_attr=pt.ParamAttr(name="head.w"),
                        bias_attr=pt.ParamAttr(name="head.b"))
    cost = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    opt_factory().minimize(cost)
    pt.default_startup_program().seed = 3
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    losses = []
    for ids, labels in batches:
        loss, = exe.run(feed={"ids": ids, "y": labels}, fetch_list=[cost],
                        scope=scope)
        losses.append(float(loss.ravel()[0]))
    return losses, scope.get("table").numpy()


def test_auto_dispatch_equals_dense_training_with_varying_ids():
    """auto(is_sparse=True) trains exactly like is_sparse=False, bit for
    bit, with per-step ids; the forced SelectedRows (lazy Adam)
    trajectory separates."""
    adam = lambda: pt.AdamOptimizer(0.05)   # noqa: E731
    auto_losses, auto_w = _train_varying_ids(True, adam)
    dense_losses, dense_w = _train_varying_ids(False, adam)
    np.testing.assert_array_equal(auto_w, dense_w)
    np.testing.assert_array_equal(auto_losses, dense_losses)
    flags.set_flag("sparse_grad", "selected_rows")
    _, sr_w = _train_varying_ids(True, adam)
    assert np.abs(sr_w - dense_w).max() > 1e-4


# ---- each sparse op against the JAX package -------------------------------

def _sparse_case(seed, height=9, C=14, width=3):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, 5, C).astype(np.int32)         # many duplicates
    vals = rng.uniform(-1, 1, (C, width)).astype(np.float32)
    u = lambda lo, hi: rng.uniform(lo, hi, (height, width)).astype(  # noqa
        np.float32)
    return rows, vals, height, u


UPDATES = {
    "sgd": lambda u: ({"Param": u(-1, 1)}, {}),
    "momentum": lambda u: ({"Param": u(-1, 1), "Velocity": u(-1, 1)},
                           {"mu": 0.9}),
    "momentum_nesterov": lambda u: ({"Param": u(-1, 1),
                                     "Velocity": u(-1, 1)},
                                    {"mu": 0.9, "use_nesterov": True}),
    "adam": lambda u: ({"Param": u(-1, 1), "Moment1": u(-0.1, 0.1),
                        "Moment2": u(0, 0.1),
                        "Beta1Pow": np.asarray([0.9 ** 3], np.float32),
                        "Beta2Pow": np.asarray([0.999 ** 3], np.float32)},
                       {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adagrad": lambda u: ({"Param": u(-1, 1), "Moment": u(0, 0.5)},
                          {"epsilon": 1e-6}),
}


@pytest.mark.parametrize("case", sorted(UPDATES))
def test_sparse_update_matches_jax_package(case):
    """The sparse branch of each update op, in place and under the
    guard's new-tensor mode (the same bits; the guard leaves its inputs
    alone), against the reference's on the same SelectedRows."""
    import jax.numpy as jnp
    from paddle_tpu.selected_rows import SelectedRows as JRows
    op_type = case.split("_")[0]
    rows, vals, height, u = _sparse_case(11)
    state, attrs = UPDATES[case](u)
    state["LearningRate"] = np.asarray([0.1], np.float32)
    jout = jpt.ops.registry.get_op(op_type).lowering(
        None, {**{k: [jnp.asarray(v)] for k, v in state.items()},
               "Grad": [JRows(jnp.asarray(rows), jnp.asarray(vals),
                              height)]}, dict(attrs))
    outs = []
    for in_place in (True, False):
        ctx = types.SimpleNamespace(in_place=in_place, op=None)
        tins = {k: [torch.from_numpy(v.copy())] for k, v in state.items()}
        before = {k: v[0].clone() for k, v in tins.items()}
        tins["Grad"] = [SelectedRows(torch.from_numpy(rows),
                                     torch.from_numpy(vals), height)]
        out = op_registry.get_op(op_type).lowering(ctx, tins, dict(attrs))
        if not in_place:
            for k, v in before.items():
                assert torch.equal(tins[k][0], v), (case, k)
        outs.append({k: v[0].numpy().copy() for k, v in out.items()})
    assert sorted(outs[0]) == sorted(jout)
    untouched = sorted(set(range(height)) - set(rows.tolist()))
    for slot, v in jout.items():
        assert np.array_equal(outs[0][slot], outs[1][slot]), (case, slot)
        assert_close(outs[0][slot], np.asarray(v[0]), (case, slot))
        if outs[0][slot].shape[0] == height:
            src = slot[:-3] if slot.endswith("Out") else slot
            np.testing.assert_array_equal(outs[0][slot][untouched],
                                          state[src][untouched])


@pytest.mark.parametrize("mixed", [False, True])
def test_sum_over_selected_rows_matches_jax_package(mixed):
    """`sum` of two SelectedRows (a table looked up twice) stays sparse,
    rows and values concatenated; a SelectedRows plus a dense tensor
    densifies."""
    import jax.numpy as jnp
    from paddle_tpu.selected_rows import SelectedRows as JRows
    rows, vals, height, u = _sparse_case(12)
    a = (rows[:8], vals[:8])
    b = (rows[8:], vals[8:])
    dense = u(-1, 1)
    jx = [JRows(jnp.asarray(a[0]), jnp.asarray(a[1]), height),
          jnp.asarray(dense) if mixed
          else JRows(jnp.asarray(b[0]), jnp.asarray(b[1]), height)]
    px = [SelectedRows(torch.from_numpy(a[0]), torch.from_numpy(a[1]),
                       height),
          torch.from_numpy(dense) if mixed
          else SelectedRows(torch.from_numpy(b[0]), torch.from_numpy(b[1]),
                            height)]
    jout = jpt.ops.registry.get_op("sum").lowering(None, {"X": jx}, {})
    pout = op_registry.get_op("sum").lowering(None, {"X": px}, {})
    j, p = jout["Out"][0], pout["Out"][0]
    if mixed:
        assert isinstance(p, torch.Tensor)
        assert_close(p.numpy(), np.asarray(j), "mixed sum")
    else:
        assert isinstance(p, SelectedRows) and p.height == j.height
        np.testing.assert_array_equal(p.rows.numpy(), np.asarray(j.rows))
        np.testing.assert_array_equal(p.values.numpy(),
                                      np.asarray(j.values))


def _lookup_program(P, padding_idx):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        x = P.layers.data("ids", [5, 1], dtype="int64")
        emb = P.layers.embedding(input=x, size=[11, 3], is_sparse=True,
                                 padding_idx=padding_idx,
                                 param_attr=P.ParamAttr(name="table"))
        cost = P.layers.mean(P.layers.square(emb))
        P.SGDOptimizer(0.1).minimize(cost, startup_program=startup)
    return main, startup, cost


@pytest.mark.parametrize("padding_idx", [None, 2])
def test_lookup_table_sparse_grad_matches_jax_package(padding_idx):
    """The SelectedRows gradient of an is_sparse lookup ([B, F, 1] int64
    ids, the trailing 1 squeezed): int32 rows equal to the reference's,
    values within RTOL (zero at `padding_idx`); then one SGD step's
    table."""
    from paddle_tpu_torch.weights import scope_from_numpy
    flags.set_flag("sparse_grad", "selected_rows")
    jpt.flags.set_flag("sparse_grad", "selected_rows")
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 6, (4, 5, 1)).astype(np.int64)
    jmain, jstart, jcost = _lookup_program(jpt, padding_idx)
    pmain, pstart, pcost = _lookup_program(pt, padding_idx)
    assert pmain.to_dict() == jmain.to_dict()
    gname = next(n for n in pmain.global_block().vars
                 if n.startswith("table@GRAD"))
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    pscope = scope_from_numpy({k: np.array(v) for k, v in jscope.vars.items()
                               if not k.startswith("__")}, "cpu")
    jg, = jexe.run(jmain, feed={"ids": ids}, fetch_list=[gname],
                   scope=jscope, return_numpy=False)
    pg, = pt.Executor(pt.CPUPlace()).run(pmain, feed={"ids": ids},
                                         fetch_list=[gname], scope=pscope)
    assert isinstance(pg, SelectedRows) and pg.height == 11
    assert pg.rows.dtype == np.int32
    np.testing.assert_array_equal(pg.rows, np.asarray(jg.rows))
    assert_close(pg.values, np.asarray(jg.values), "values")
    if padding_idx is not None:
        assert not pg.values[pg.rows == padding_idx].any()
    assert_close(pscope.get("table").numpy(), np.asarray(jscope.get("table")),
                 "table after one step")


def test_other_ops_get_the_dense_gradient():
    """An update op without a sparse branch (rmsprop) and a clip between
    the gradient and the update get the SelectedRows' dense form
    (`densify_ins`): the same training as is_sparse=False."""
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 6, (4, 3)).astype(np.int64)
    labels = rng.randn(4, 1).astype(np.float32)
    results = []
    for is_sparse in (False, True):
        flags.set_flag("sparse_grad", "selected_rows")
        pt.clip.set_gradient_clip(pt.clip.GradientClipByNorm(0.5))
        try:
            results.append(_train_embedding_model(
                lambda: pt.RMSPropOptimizer(0.01), is_sparse, ids, labels,
                10, 2, steps=3))
        finally:
            pt.clip.set_gradient_clip(None)
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-6)
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-6,
                               atol=1e-7)


def test_guarded_sparse_step_leaves_the_scope_on_a_trip():
    """Under the NaN guard a sparse Adam step whose loss is NaN raises
    and leaves every state tensor as it was (the sparse updates write
    into copies)."""
    flags.set_flag("sparse_grad", "selected_rows")
    pt.framework.reset_default_programs()
    x = pt.layers.data("ids", [3], dtype="int64")
    y = pt.layers.data("y", [1])
    emb = pt.layers.embedding(input=x, size=[10, 2], is_sparse=True,
                              param_attr=pt.ParamAttr(name="table"))
    pred = pt.layers.fc(input=pt.layers.reduce_sum(emb, dim=1), size=1)
    cost = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    pt.AdamOptimizer(0.01).minimize(cost)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    ids = np.asarray([[1, 2, 1], [3, 3, 4]], np.int64)
    exe.run(feed={"ids": ids, "y": np.ones((2, 1), np.float32)},
            fetch_list=[cost], scope=scope)
    before = {n: t.clone() for n, t in scope.vars.items()
              if isinstance(t, torch.Tensor)}
    flags.set_flag("check_nan_inf", True)
    with pytest.raises(FloatingPointError):
        exe.run(feed={"ids": ids,
                      "y": np.full((2, 1), np.nan, np.float32)},
                fetch_list=[cost], scope=scope)
    for n, t in before.items():
        assert torch.equal(scope.get(n), t), n
