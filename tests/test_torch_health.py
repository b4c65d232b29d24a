"""Model health and the FLOP tally in the port against the JAX package
on the CPU (monitor/health.py, monitor/introspect.py, the executor's
health fetches, Trainer(health_metrics=True)).

The port twin of tests/test_health.py: the tiny LM (transformer_lm_cost,
hid 32, 2 layers, 2 heads, T 16, B 2) takes three Adam steps in both
packages with the same feeds, each step from the JAX package's state
carried into the port (`weights.scope_from_numpy`: two f32 runs drift
apart by ~1e-5 of an update over three steps, which is not the health
reductions' error), fetching the three health values each step:
grad_norm and param_norm within 1e-5 relative, and every update ratio
within 1e-5 relative plus the measured difference of the two packages'
updates (the bound the triangle inequality gives; it also covers the
key biases of ROADMAP C3). The fetched values also equal the
reference's own reductions run on the port's tensors within 1e-6. The
jump explanation's text,
the MFU formula, the Trainer's gauges and events, and program_flops /
the per-scope FLOPs against the reference's auditor on the tiny LM and
the conv mnist training programs.
"""

import time

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.models  # noqa: F401
from paddle_tpu.monitor import deviceprof as jdeviceprof
from paddle_tpu.monitor import health as jhealth
from paddle_tpu.monitor import introspect as jintrospect
import paddle_tpu_torch as pt
from paddle_tpu_torch import flags, monitor
from paddle_tpu_torch.monitor import deviceprof, health, introspect
from paddle_tpu_torch.weights import scope_from_numpy

B, T, V, H, L, N_HEADS = 2, 16, 96, 32, 2, 2
LR = 1e-3
STEPS = 3
RTOL = 1e-5


@pytest.fixture(autouse=True)
def clean():
    for P in (jpt, pt):
        P.framework.reset_default_programs()
    monitor.reset()
    monitor.set_enabled(False)
    introspect.reset()
    health.activate(None)
    yield
    monitor.reset()
    monitor.set_enabled(False)
    introspect.reset()
    health.activate(None)
    flags.set_flag("check_nan_inf", False)


@pytest.fixture
def reference_kernels_forced():
    prev = {k: jpt.flags.get(k) for k in ("flash_attention",
                                          "ce_pallas_lse")}
    for k in prev:
        jpt.flags.set_flag(k, True)
    yield
    for k, v in prev.items():
        jpt.flags.set_flag(k, v)


def _build_lm(P):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        tok = P.layers.data("tok", [T, 1], dtype="int64")
        nxt = P.layers.data("nxt", [T, 1], dtype="int64")
        cost = P.models.transformer.transformer_lm_cost(
            tok, nxt, V, hid=H, num_layers=L, num_heads=N_HEADS, max_len=T)
        P.AdamOptimizer(LR).minimize(cost)
    return main, startup, cost


def _lm_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"tok": rng.randint(0, V, (B, T, 1)).astype(np.int64),
            "nxt": rng.randint(0, V, (B, T, 1)).astype(np.int64)}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)


@pytest.mark.parametrize("guard", [False, True],
                         ids=["in_place", "nan_guard"])
def test_health_values_match_the_jax_package(reference_kernels_forced,
                                             guard):
    """Three Adam steps, each from the JAX package's state carried into
    the port; with the NaN guard on, the optimizer ops write new tensors
    instead of updating in place (the ratios then read the old tensor
    instead of a copy). grad_norm and param_norm within 1e-5 relative.
    An update ratio ||dw|| / ||w|| from one carried w differs by at most
    the difference of the two packages' updates over ||w|| (triangle
    inequality), and Adam turns f32 gradient differences of ~1e-7 into
    update differences of ~1e-5 on small components; so each ratio is
    held within 1e-5 relative plus that measured difference, which also
    covers the key biases (ROADMAP C3: their true gradient is zero and
    each package's Adam steps its own rounding noise, up to lr)."""
    jmain, jstart, jcost = _build_lm(jpt)
    pmain, _, pcost = _build_lm(pt)
    pairs = health.param_grad_pairs(pmain)
    assert pairs == jhealth.param_grad_pairs(jmain) and len(pairs) == 29
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    pexe = pt.Executor(pt.CPUPlace())
    flags.set_flag("check_nan_inf", guard)
    fetch = [jcost.name] + list(health.FETCHES)
    for step in range(STEPS):
        # each step starts both packages from the same state: the JAX
        # package's, carried into the port (parameters, Adam moments,
        # beta powers)
        state = {k: np.array(jscope.get(k)) for k in jscope.keys()
                 if not k.startswith("__")}
        pscope = scope_from_numpy(state, "cpu")
        jout = jexe.run(jmain, feed=_lm_feed(step), fetch_list=fetch,
                        scope=jscope)
        pout = pexe.run(pmain, feed=_lm_feed(step), fetch_list=fetch,
                        scope=pscope)
        assert float(_rel(pout[1], jout[1])) <= RTOL, ("grad_norm", step)
        assert float(_rel(pout[2], jout[2])) <= RTOL, ("param_norm", step)
        pr, jr = np.asarray(pout[3], np.float64), np.asarray(jout[3],
                                                             np.float64)
        assert pr.shape == jr.shape == (len(pairs),)
        for i, (p, _) in enumerate(pairs):
            base = np.linalg.norm(state[p].astype(np.float64)) + 1e-12
            drift = np.linalg.norm(pscope.get(p).double().numpy()
                                   - np.asarray(jscope.get(p), np.float64))
            assert abs(pr[i] - jr[i]) <= RTOL * abs(jr[i]) + drift / base, \
                (p, step, pr[i], jr[i], drift / base)


def test_reductions_equal_the_references_on_the_same_tensors():
    """The port's fetched health values against the reference's own
    reductions (`lower_into_env`) run on the port's tensors of the same
    step: its gradients, its pre-update and post-update parameters."""
    import jax.numpy as jnp
    pmain, pstart, pcost = _build_lm(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pstart, scope=scope)
    exe.run(pmain, feed=_lm_feed(7), fetch_list=[pcost], scope=scope)
    pairs = health.param_grad_pairs(pmain)
    pre = {p: scope.get(p).clone() for p, _ in pairs}
    out = exe.run(pmain, feed=_lm_feed(8), fetch_list=[pcost] + [
        g for _, g in pairs] + list(health.FETCHES), scope=scope)
    env = {g: jnp.asarray(v) for (_, g), v in zip(pairs, out[1:])}
    env.update({p: jnp.asarray(scope.get(p).numpy()) for p, _ in pairs})
    jhealth.lower_into_env(env, {p: jnp.asarray(v.numpy())
                                 for p, v in pre.items()}, pairs)
    for got, name in zip(out[-3:], health.FETCHES):
        ref = np.asarray(env[name])
        assert got.shape == ref.shape, name
        assert float(np.max(_rel(got, ref))) <= 1e-6, name


def test_unknown_health_fetch_raises_like_the_reference():
    pmain, pstart, pcost = _build_lm(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pstart, scope=scope)
    with pytest.raises(KeyError, match="unknown health fetch"):
        exe.run(pmain, feed=_lm_feed(), fetch_list=[
            pcost, "__health.nope__"], scope=scope)


def test_health_without_optimizer_ops_fetches_zeros():
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4])
        cost = pt.layers.mean(pt.layers.fc(x, size=1))
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    out = exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                  fetch_list=[cost] + list(health.FETCHES), scope=scope)
    assert float(out[1]) == 0.0 and float(out[2]) == 0.0
    assert out[3].shape == (0,)
    assert not health.HealthMonitor(main).enabled


def _jump_sequence(mon):
    n = len(mon.pairs)
    for step in range(5):
        mon.observe(step, 1.0 + 0.1 * step,
                    [np.float32(1.0 + 0.01 * step), np.float32(3.5),
                     np.linspace(0, 0.01, n, dtype=np.float32)])
    mon.observe(5, 2.5, [np.float32(40.0), np.float32(3.6),
                         np.full(n, 0.25, np.float32)])
    return mon


def test_explanations_and_sections_equal_the_references():
    jmain, _, _ = _build_lm(jpt)
    pmain, _, _ = _build_lm(pt)
    pm = health.HealthMonitor(pmain)
    jm = jhealth.HealthMonitor(jmain)
    assert pm.explain() == jm.explain()
    _jump_sequence(pm)
    _jump_sequence(jm)
    assert "grad_norm jumped" in pm.explain()
    assert pm.explain() == jm.explain()
    assert pm.section() == jm.section()


def _trainer_batches(n):
    rng = np.random.RandomState(5)
    return [[(rng.randint(0, V, (T, 1)).astype(np.int64),
              rng.randint(0, V, (T, 1)).astype(np.int64))
             for _ in range(B)] for _ in range(n)]


def test_trainer_health_gauges_events_and_mfu():
    flags.set_flag("metrics", True)
    try:
        pmain, pstart, pcost = _build_lm(pt)
        trainer = pt.Trainer(pcost, main_program=pmain,
                             startup_program=pstart, place=pt.CPUPlace(),
                             health_metrics=True, feed_workers=0)
        snaps = []
        trainer.train(lambda: iter(_trainer_batches(4)), 1, ["tok", "nxt"],
                      lambda ev: snaps.append(ev.health)
                      if isinstance(ev, pt.event.EndIteration) else None)
        assert len(snaps) == 4 and all(s is not None for s in snaps)
        a = trainer.health.ema_alpha
        expect = snaps[0]["loss"]
        for s in snaps[1:]:
            expect = a * expect + (1 - a) * s["loss"]
        assert snaps[-1]["loss_ema"] == pytest.approx(expect, rel=1e-6)
        g = monitor.snapshot()["gauges"]
        for name in ("health.grad_norm", "health.param_norm",
                     "health.loss_ema", "health.update_ratio_max",
                     "perf.step_flops", "perf.mfu|device=cpu-smoke"):
            assert name in g, name
        assert g["perf.step_flops"] == introspect.program_flops(
            pmain, {"tok": np.zeros((B, T, 1), np.int64)})
        assert monitor.snapshot()["counters"]["health.steps"] == 4
        # the bundle provider reads the active monitor
        assert health.current_section()["last"]["step"] == 3
    finally:
        flags.set_flag("metrics", False)


def test_disabled_trainer_records_no_health_or_perf():
    flags.set_flag("metrics", True)
    try:
        pmain, pstart, pcost = _build_lm(pt)
        trainer = pt.Trainer(pcost, main_program=pmain,
                             startup_program=pstart, place=pt.CPUPlace(),
                             feed_workers=0)
        assert trainer.health is None
        seen = []
        trainer.train(lambda: iter(_trainer_batches(2)), 1, ["tok", "nxt"],
                      lambda ev: seen.append(ev.health)
                      if isinstance(ev, pt.event.EndIteration) else None)
        assert seen == [None, None]
        snap = monitor.snapshot()
        assert not any(k.startswith(("health.", "perf."))
                       for k in list(snap["gauges"]) + list(
                           snap["counters"]))
    finally:
        flags.set_flag("metrics", False)


def test_mfu_gauge_matches_the_formula():
    """tests/test_health.py's _assert_mfu_formula on the port: the
    gauge equals flops / (dt x peak) within 1 %."""
    pmain, pstart, pcost = _build_lm(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pstart, scope=scope)
    feed = _lm_feed()
    flops = introspect.program_flops(pmain, feed=feed,
                                     fetch_list=[pcost.name], scope=scope,
                                     executor=exe)
    assert flops > 0
    exe.run(pmain, feed=feed, fetch_list=[pcost], scope=scope)
    t0 = time.perf_counter()
    exe.run(pmain, feed=feed, fetch_list=[pcost], scope=scope)
    dt = time.perf_counter() - t0
    monitor.set_enabled(True)
    mfu = introspect.note_step_flops(flops, dt)
    g = monitor.snapshot()["gauges"]
    peak, label = introspect.peak_flops()
    assert (peak, label) == jintrospect.peak_flops() == (197e12,
                                                         "cpu-smoke")
    expect = flops / (dt * peak)
    assert g[f"perf.mfu|device={label}"] == pytest.approx(expect, rel=0.01)
    assert mfu == pytest.approx(expect, rel=0.01)
    assert g["perf.flops_per_sec"] == pytest.approx(flops / dt, rel=0.01)
    assert introspect.debug_vars()["perf"]["mfu"] == pytest.approx(
        expect, rel=0.01)


def _build_mnist(P):
    P.framework.reset_default_programs()
    img = P.layers.data("img", [1, 28, 28])
    label = P.layers.data("label", [1], dtype="int64")
    probs = P.models.mnist.conv_net(img)
    cost = P.layers.mean(P.layers.cross_entropy(probs, label))
    P.AdamOptimizer(learning_rate=2e-3).minimize(cost)
    return (P.default_main_program(), P.default_startup_program(), cost,
            {"img": np.zeros((4, 1, 28, 28), np.float32),
             "label": np.zeros((4, 1), np.int64)})


def _build_lm_fed(P):
    main, startup, cost = _build_lm(P)
    return main, startup, cost, _lm_feed()


def _reference_scope_costs(jmain, jstart, jcost, feed):
    import jax
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    total = jintrospect.program_flops(jmain, feed=feed,
                                      fetch_list=[jcost.name],
                                      scope=jscope, executor=jexe)
    fn, args = jexe.trace(jmain, feed, [jcost.name], jscope)
    costs = jdeviceprof.static_scope_costs(jax.make_jaxpr(fn)(*args))
    return total, {s: c["flops"] for s, c in costs.items() if c["flops"]}


@pytest.mark.parametrize("build", [_build_lm_fed, _build_mnist],
                         ids=["tiny_lm", "conv_mnist"])
def test_program_flops_equal_the_reference_auditors(build):
    """program_flops and the per-scope FLOPs of every product op equal
    the reference's auditor tally and static_scope_costs exactly."""
    jmain, jstart, jcost, feed = build(jpt)
    ref_total, ref_scopes = _reference_scope_costs(jmain, jstart, jcost,
                                                   feed)
    pmain, _, _, _ = build(pt)
    assert introspect.program_flops(pmain, feed) == ref_total > 0
    got = {s: c["flops"] for s, c in deviceprof.static_scope_costs(
        pmain, feed).items() if c["flops"]}
    assert got == ref_scopes
    assert pt.profiler.cost_analysis(pmain, feed) == {
        "flops": float(ref_total)}
