"""The port's optimizer suite against the JAX package on the CPU.

Every update op runs on golden-style inputs (the shapes, ranges and
attributes of tests/test_optimizer_op_suite.py, drawn from numpy seed
71) through both packages' lowerings, in place and under the NaN guard's
new-tensor mode (the two give the same bits, and the second leaves its
inputs untouched); momentum also with a SelectedRows gradient against
the reference's sparse branch (the other sparse branches are in
tests/test_torch_sparse.py). The five LR schedules run 10 steps each, staircase
on and off. Clip by norm, clip by global norm and L1 decay run on the
same fed gradients and parameters in both packages. Every optimizer
class (and the clip and L1 variants of a model) builds Program text
equal to the JAX front end's; ModelAverage's apply and restore programs
too.

Tolerance: RTOL = 1e-6 relative, each array held to 1e-6 of its
largest element, for everything computed from the same inputs (the ops,
the schedules, the clips): both packages compute in float32 in the same
order of operations, and XLA's and PyTorch's exp / sqrt / reductions
may differ in the last place. The model-level trajectories (3 steps of
a 2-layer model from one initialisation) also carry the two packages'
different matmul and reduction rounding in the gradients (~1e-7
relative), which the per-element normalising optimizers (Adam, Adadelta,
...) turn into larger relative differences on elements whose gradient
is near zero: step 1's loss (one forward pass from the same weights) is
held to RTOL, the later losses, the parameters and the accumulators to
TRAJ_RTOL = 1e-4 of each array's largest element.
"""

import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import registry as op_registry
from paddle_tpu_torch.weights import scope_from_numpy

RTOL = 1e-6
TRAJ_RTOL = 1e-4


def assert_close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    err = float(np.abs(got.astype(np.float64) - want).max()) if got.size \
        else 0.0
    assert err <= rtol * scale, (what, err, scale)


@pytest.fixture(autouse=True)
def clean_state():
    yield
    jpt.clip.set_gradient_clip(None)
    pt.clip.set_gradient_clip(None)
    pt.flags.reset()


# ---------------------------------------------------------------------------
# the update ops
# ---------------------------------------------------------------------------

def _cases():
    rng = np.random.RandomState(71)

    def u(lo, hi, shape=(4, 5)):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    P, G = u(-1, 1), u(-1, 1)
    LR = np.asarray([0.1], np.float32)
    base = {"Param": P, "Grad": G, "LearningRate": LR}
    i64 = lambda v: np.asarray([v], np.int64)  # noqa: E731
    return {
        "sgd": (base, {}),
        "momentum": ({**base, "Velocity": u(-1, 1)}, {"mu": 0.9}),
        "momentum_nesterov": ({**base, "Velocity": u(-1, 1)},
                              {"mu": 0.9, "use_nesterov": True}),
        "adam": ({**base, "Moment1": u(-0.1, 0.1), "Moment2": u(0, 0.1),
                  "Beta1Pow": np.asarray([0.9 ** 3], np.float32),
                  "Beta2Pow": np.asarray([0.999 ** 3], np.float32)},
                 {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "adagrad": ({**base, "Moment": u(0, 0.5)}, {"epsilon": 1e-6}),
        "decayed_adagrad": ({**base, "Moment": u(0, 0.5)},
                            {"decay": 0.95, "epsilon": 1e-6}),
        "adadelta": ({"Param": P, "Grad": G, "AvgSquaredGrad": u(0, 0.5),
                      "AvgSquaredUpdate": u(0, 0.5)},
                     {"rho": 0.95, "epsilon": 1e-6}),
        "adamax": ({**base, "Moment": u(-0.1, 0.1), "InfNorm": u(0, 0.5),
                    "Beta1Pow": np.asarray([0.9 ** 2], np.float32)},
                   {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "rmsprop": ({**base, "MeanSquare": u(0, 0.5),
                     "Moment": u(-0.1, 0.1)},
                    {"decay": 0.9, "epsilon": 1e-10, "momentum": 0.5}),
        "proximal_gd": (base, {"l1": 0.05, "l2": 0.05}),
        "proximal_adagrad": ({**base, "Moment": u(0, 0.5)},
                             {"l1": 0.05, "l2": 0.05}),
        "ftrl": ({**base, "SquaredAccumulator": u(0.1, 0.5),
                  "LinearAccumulator": u(-0.1, 0.1)},
                 {"l1": 0.1, "l2": 0.1, "lr_power": -0.5}),
        "ftrl_power": ({**base, "SquaredAccumulator": u(0.1, 0.5),
                        "LinearAccumulator": u(-0.1, 0.1)},
                       {"l1": 0.1, "l2": 0.1, "lr_power": -0.3}),
        "average_accumulates": (
            {"Param": P, "Sum1": u(-1, 1), "Sum2": u(-1, 1),
             "Sum3": u(-1, 1), "NumAccumulates": i64(3),
             "OldNumAccumulates": i64(2), "NumUpdates": i64(9)},
            {"average_window": 0.5, "min_average_window": 2,
             "max_average_window": 4}),
        "average_accumulates_roll": (
            {"Param": P, "Sum1": u(-1, 1), "Sum2": u(-1, 1),
             "Sum3": u(-1, 1), "NumAccumulates": i64(0),
             "OldNumAccumulates": i64(0), "NumUpdates": i64(3)},
            {"average_window": 0.15, "min_average_window": 100,
             "max_average_window": 1000, "kMaxNumAccumulates": 4}),
        "average_apply": (
            {"Param": P, "Sum1": u(-1, 1), "Sum2": u(-1, 1),
             "Sum3": u(-1, 1), "NumAccumulates": i64(3),
             "OldNumAccumulates": i64(4)}, {}),
        "gen_pruning_mask": ({"Param": np.round(P * 4) / 4},
                             {"sparsity_ratio": 0.6}),
    }


CASES = _cases()


def _op_type(case):
    return {"momentum_nesterov": "momentum", "ftrl_power": "ftrl",
            "average_accumulates_roll": "average_accumulates"}.get(case,
                                                                   case)


def _port(op_type, ins, attrs, in_place):
    ctx = types.SimpleNamespace(in_place=in_place, op=None,
                                device=torch.device("cpu"))
    tins = {k: [torch.from_numpy(v.copy())] for k, v in ins.items()}
    before = {k: v[0].clone() for k, v in tins.items()}
    out = op_registry.get_op(op_type).lowering(ctx, tins, dict(attrs))
    if not in_place:
        for k, v in tins.items():
            assert torch.equal(v[0], before[k]), f"{op_type} wrote {k}"
    return {k: v[0].numpy().copy() for k, v in out.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_op_matches_jax_package(case):
    import jax.numpy as jnp
    op_type = _op_type(case)
    ins, attrs = CASES[case]
    jout = jpt.ops.registry.get_op(op_type).lowering(
        None, {k: [jnp.asarray(v)] for k, v in ins.items()}, dict(attrs))
    in_place = _port(op_type, ins, attrs, True)
    fresh = _port(op_type, ins, attrs, False)
    assert sorted(in_place) == sorted(jout)
    for slot, vals in jout.items():
        want = np.asarray(vals[0])
        assert np.array_equal(in_place[slot], fresh[slot]), (case, slot)
        assert_close(in_place[slot], want, (case, slot))
    reg = pt.ops.registry.get_op(op_type)
    assert reg.is_optimizer == jpt.ops.registry.get_op(op_type).is_optimizer


def test_all_update_ops_tagged_like_the_reference():
    from paddle_tpu.ops.registry import optimizer_op_types as jtypes
    from paddle_tpu_torch.ops.registry import optimizer_op_types
    want = {"sgd", "momentum", "adam", "adagrad", "adamax", "rmsprop",
            "adadelta", "decayed_adagrad", "ftrl", "proximal_gd",
            "proximal_adagrad", "average_accumulates"}
    assert want <= optimizer_op_types()
    assert optimizer_op_types() <= jtypes()


def test_sparse_gradient_updates_like_the_reference():
    """`momentum` with a SelectedRows gradient (rows 2, 0, 2, 3, 0, 2 of
    CASES["momentum"]'s [4, 5] parameter: duplicates, row 1 untouched)
    against the reference's sparse momentum on the same numpy inputs,
    in place and under the guard's new-tensor mode (the same bits, the
    inputs untouched); the untouched row keeps its bits."""
    import jax.numpy as jnp
    from paddle_tpu.selected_rows import SelectedRows as JRows
    from paddle_tpu_torch.selected_rows import SelectedRows
    ins, attrs = CASES["momentum"]
    rows = np.asarray([2, 0, 2, 3, 0, 2], np.int32)
    vals = (ins["Grad"][[0, 1, 2, 3, 1, 0]] * 0.5).astype(np.float32)
    dense_ins = {k: jnp.asarray(v) for k, v in ins.items() if k != "Grad"}
    jout = jpt.ops.registry.get_op("momentum").lowering(
        None, {**{k: [v] for k, v in dense_ins.items()},
               "Grad": [JRows(jnp.asarray(rows), jnp.asarray(vals), 4)]},
        dict(attrs))
    outs = []
    for in_place in (True, False):
        ctx = types.SimpleNamespace(in_place=in_place, op=None)
        tins = {k: [torch.from_numpy(v.copy())] for k, v in ins.items()
                if k != "Grad"}
        before = {k: v[0].clone() for k, v in tins.items()}
        tins["Grad"] = [SelectedRows(torch.from_numpy(rows),
                                     torch.from_numpy(vals), 4)]
        out = op_registry.get_op("momentum").lowering(ctx, tins,
                                                      dict(attrs))
        if not in_place:
            for k, v in before.items():
                assert torch.equal(tins[k][0], v), k
        outs.append({k: v[0].numpy().copy() for k, v in out.items()})
    assert sorted(outs[0]) == sorted(jout)
    for slot, vals_ in jout.items():
        assert np.array_equal(outs[0][slot], outs[1][slot]), slot
        assert_close(outs[0][slot], np.asarray(vals_[0]), slot)
    assert np.array_equal(outs[0]["ParamOut"][1], ins["Param"][1])
    assert np.array_equal(outs[0]["VelocityOut"][1], ins["Velocity"][1])


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "exponential": lambda P, s: P.learning_rate_decay.exponential_decay(
        0.1, 3, 0.5, staircase=s),
    "natural_exp": lambda P, s: P.learning_rate_decay.natural_exp_decay(
        0.1, 3, 0.5, staircase=s),
    "inverse_time": lambda P, s: P.learning_rate_decay.inverse_time_decay(
        0.1, 3, 0.5, staircase=s),
    "polynomial": lambda P, s: P.learning_rate_decay.polynomial_decay(
        0.1, 7, end_learning_rate=0.01, power=1.0 if s else 2.0),
    "piecewise": lambda P, s: P.learning_rate_decay.piecewise_decay(
        [2, 5] if s else [3, 8], [0.1, 0.05, 0.01]),
}


def _schedule_lrs(P, name, staircase, steps=10):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        lr = SCHEDULES[name](P, staircase)
    exe = P.Executor(P.CPUPlace())
    scope = P.Scope()
    exe.run(startup, scope=scope)
    out = [np.asarray(exe.run(main, fetch_list=[lr], scope=scope)[0])
           for _ in range(steps)]
    return main, startup, out, np.asarray(scope.get("@LR_DECAY_COUNTER@"))


@pytest.mark.parametrize("staircase", [False, True])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_jax_package(name, staircase):
    jmain, jstart, jlrs, jcount = _schedule_lrs(jpt, name, staircase)
    pmain, pstart, plrs, pcount = _schedule_lrs(pt, name, staircase)
    assert pmain.to_dict() == jmain.to_dict()
    assert pstart.to_dict() == jstart.to_dict()
    for step, (p, j) in enumerate(zip(plrs, jlrs)):
        assert_close(p, j, (name, staircase, step))
    # the counter is the schedule's position: 10 in-place increments
    np.testing.assert_array_equal(pcount, jcount)
    assert float(pcount[0]) == 10.0


# ---------------------------------------------------------------------------
# clipping, L1, training with each optimizer class
# ---------------------------------------------------------------------------

D_IN, D_HID = 6, 5


def _fit_model(P, optimizer, clip=None, l1=None, hooks=None):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        x = P.layers.data("x", [D_IN])
        y = P.layers.data("y", [1])
        h = P.layers.fc(x, D_HID, act="gelu", param_attr=P.ParamAttr(
            name="w1",
            gradient_clip=(P.clip.GradientClipByNorm(0.05)
                           if clip == "by_norm" else None),
            update_hooks=hooks))
        pred = P.layers.fc(h, 1, param_attr=P.ParamAttr(name="w2"))
        cost = P.layers.mean(P.layers.square_error_cost(pred, y))
        if clip == "global_norm":
            P.clip.set_gradient_clip(P.clip.GradientClipByGlobalNorm(0.1))
        reg = (P.regularizer.L1DecayRegularizer(0.01) if l1 else None)
        opt = optimizer(P, reg)
        opt.minimize(cost)
    P.clip.set_gradient_clip(None)
    return main, startup, cost


def _fit_feed(step):
    rng = np.random.RandomState(10 + step)
    x = rng.randn(8, D_IN).astype(np.float32)
    return {"x": x, "y": np.tanh(x.sum(1, keepdims=True)).astype(np.float32)}


def _train_both(optimizer, steps=3, **kw):
    jmain, jstart, jcost = _fit_model(jpt, optimizer, **kw)
    pmain, pstart, pcost = _fit_model(pt, optimizer, **kw)
    assert pmain.to_dict() == jmain.to_dict()
    assert pstart.to_dict() == jstart.to_dict()
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    init = {k: np.array(jscope.get(k)) for k in jscope.keys()
            if not k.startswith("__")}
    pscope = scope_from_numpy(init, "cpu")
    pexe = pt.Executor(pt.CPUPlace())
    for step in range(steps):
        feed = _fit_feed(step)
        jl, = jexe.run(jmain, feed=feed, fetch_list=[jcost], scope=jscope)
        pl, = pexe.run(pmain, feed=feed, fetch_list=[pcost], scope=pscope)
        assert_close(pl, jl, ("loss", step), RTOL if step == 0 else
                     TRAJ_RTOL)
    for name in init:
        assert_close(pscope.get(name).numpy(), np.asarray(jscope.get(name)),
                     name, TRAJ_RTOL)
    return pmain, pscope


OPTIMIZERS = {
    "sgd": lambda P, r: P.SGDOptimizer(0.1, regularization=r),
    "momentum": lambda P, r: P.MomentumOptimizer(0.1, 0.9,
                                                 regularization=r),
    "nesterov": lambda P, r: P.MomentumOptimizer(
        0.1, 0.9, use_nesterov=True, regularization=r),
    "adagrad": lambda P, r: P.AdagradOptimizer(0.1, regularization=r),
    "decayed_adagrad": lambda P, r: P.DecayedAdagradOptimizer(
        0.1, regularization=r),
    "adam": lambda P, r: P.AdamOptimizer(0.01, regularization=r),
    "adamax": lambda P, r: P.AdamaxOptimizer(0.01, regularization=r),
    "adadelta": lambda P, r: P.AdadeltaOptimizer(1.0, regularization=r),
    "rmsprop": lambda P, r: P.RMSPropOptimizer(0.01, momentum=0.5,
                                               regularization=r),
    "ftrl": lambda P, r: P.FtrlOptimizer(0.1, l1=0.01, l2=0.01,
                                         regularization=r),
    "adam_lr_decay": lambda P, r: P.AdamOptimizer(
        P.learning_rate_decay.exponential_decay(0.01, 2, 0.5),
        regularization=r),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_class_program_text_and_steps(name):
    """Program text equal to the JAX front end's, and three steps of
    each class from one initialisation equal within RTOL."""
    _train_both(OPTIMIZERS[name])


@pytest.mark.parametrize("case", ["by_norm", "global_norm", "l1"])
def test_clip_and_l1_programs_train_like_jax_package(case):
    pmain, _ = _train_both(
        OPTIMIZERS["sgd"], clip=case if case != "l1" else None,
        l1=case == "l1")
    types_ = {op.type for op in pmain.global_block().ops}
    want = {"by_norm": {"clip_by_norm"},
            "global_norm": {"square", "reduce_sum", "sqrt",
                            "elementwise_max", "elementwise_div",
                            "elementwise_mul"},
            "l1": {"sign"}}[case]
    assert want <= types_


def _clip_program(P, case):
    """Two parameters and two fed "gradients" of other shapes, through
    one clip or regularizer; fetch the gradients it produces."""
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        block = main.global_block()
        params = [P.layers.create_parameter([5, 3], name="pa"),
                  P.layers.create_parameter([7], name="pb")]
        grads = [P.layers.data("ga", [5, 3], append_batch_size=False),
                 P.layers.data("gb", [7], append_batch_size=False)]
        pairs = list(zip(params, grads))
        if case == "global_norm":
            out = P.clip.GradientClipByGlobalNorm(0.5).create_group_ops(
                pairs, block)
        elif case == "by_norm":
            clip = P.clip.GradientClipByNorm(0.5)
            out = [(p, clip.create_ops(p, g, block)) for p, g in pairs]
        elif case == "by_value":
            clip = P.clip.GradientClipByValue(0.3)
            out = [(p, clip.create_ops(p, g, block)) for p, g in pairs]
        else:
            reg = (P.regularizer.L1DecayRegularizer(0.01) if case == "l1"
                   else P.regularizer.L2DecayRegularizer(0.01))
            out = [(p, reg.append_ops(p, g, block)) for p, g in pairs]
    return main, startup, [g.name for _, g in out]


@pytest.mark.parametrize("scale", [0.1, 10.0])
@pytest.mark.parametrize("case", ["global_norm", "by_norm", "by_value",
                                  "l1", "l2"])
def test_clip_and_decay_ops_match_jax_package(case, scale):
    """The clips and decays on the same gradients and parameters: with
    the gradients' norm below (scale 0.1) and above (10) the clip."""
    jmain, jstart, jout = _clip_program(jpt, case)
    pmain, pstart, pout = _clip_program(pt, case)
    assert pmain.to_dict() == jmain.to_dict()
    rng = np.random.RandomState(5)
    feed = {"ga": (scale * rng.randn(5, 3)).astype(np.float32),
            "gb": (scale * rng.randn(7)).astype(np.float32)}
    params = {"pa": rng.randn(5, 3).astype(np.float32),
              "pb": rng.randn(7).astype(np.float32)}
    jscope = jpt.Scope()
    for k, v in params.items():
        jscope.set(k, v)
    got = pt.Executor(pt.CPUPlace()).run(
        pmain, feed=feed, fetch_list=pout,
        scope=scope_from_numpy(params, "cpu"))
    want = jpt.Executor(jpt.CPUPlace()).run(jmain, feed=feed,
                                            fetch_list=jout, scope=jscope)
    for name, g, w in zip(pout, got, want):
        assert_close(g, np.asarray(w), (case, name))
    if case in ("global_norm", "by_norm") and scale == 10.0:
        norms = [float(np.sqrt((g.astype(np.float64) ** 2).sum()))
                 for g in got]
        total = np.sqrt(sum(n * n for n in norms))
        assert abs((total if case == "global_norm" else max(norms))
                   - 0.5) < 1e-5


def test_global_step_increment_and_pruning_hooks():
    """The base class's `global_step` increment and the pruning update
    hook: equal program text, and the masked weights stay zero."""
    def opt(P, r):
        helper = P.layer_helper.LayerHelper("gs")
        gs = helper.create_persistable_var("global_step", [1], "int64")
        return P.SGDOptimizer(0.1, global_step=gs)

    hooks_j = jpt.param_attr.HookAttribute("pruning", 0.6)
    jmain, jstart, _ = _fit_model(jpt, opt, hooks=hooks_j)
    pmain, pstart, pcost = _fit_model(
        pt, opt, hooks=pt.param_attr.HookAttribute("pruning", 0.6))
    assert pmain.to_dict() == jmain.to_dict()
    assert pstart.to_dict() == jstart.to_dict()
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pstart, scope=scope)
    mask = scope.get("w1@PRUNING_MASK").numpy().copy()
    assert int(mask.sum()) == int(D_IN * D_HID * 0.4)
    for step in range(3):
        exe.run(pmain, feed=_fit_feed(step), fetch_list=[pcost],
                scope=scope)
    w1 = scope.get("w1").numpy()
    assert (w1[mask == 0] == 0).all() and (w1[mask == 1] != 0).all()
    assert int(scope.get("global_step").numpy()[0]) == 3


def _model_average(P, steps):
    main, startup, cost = _fit_model(P, OPTIMIZERS["momentum"])
    with P.program_guard(main, startup):
        ma = P.optimizer.ModelAverage(0.5, min_average_window=2,
                                      max_average_window=3, program=main,
                                      startup_program=startup)
    return main, startup, cost, ma


def test_model_average_apply_and_restore_match_jax_package():
    jmain, jstart, jcost, jma = _model_average(jpt, 5)
    pmain, pstart, pcost, pma = _model_average(pt, 5)
    for a, b in ((pmain, jmain), (pstart, jstart),
                 (pma.apply_program, jma.apply_program),
                 (pma.restore_program, jma.restore_program)):
        assert a.to_dict() == b.to_dict()
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    init = {k: np.array(jscope.get(k)) for k in jscope.keys()
            if not k.startswith("__")}
    pscope = scope_from_numpy(init, "cpu")
    pexe = pt.Executor(pt.CPUPlace())
    for step in range(5):
        jexe.run(jmain, feed=_fit_feed(step), fetch_list=[jcost],
                 scope=jscope)
        pexe.run(pmain, feed=_fit_feed(step), fetch_list=[pcost],
                 scope=pscope)
    raw = pscope.get("w1").numpy().copy()
    with jma.apply(jexe, scope=jscope), pma.apply(pexe, scope=pscope):
        for name in ("w1", "w2"):
            assert_close(pscope.get(name).numpy(),
                         np.asarray(jscope.get(name)), name, TRAJ_RTOL)
        assert not np.array_equal(pscope.get("w1").numpy(), raw)
    np.testing.assert_array_equal(pscope.get("w1").numpy(), raw)
    for name in init:
        assert_close(pscope.get(name).numpy(), np.asarray(jscope.get(name)),
                     name, TRAJ_RTOL)
