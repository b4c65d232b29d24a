"""The port's supervised Trainer, checkpoints and NaN guard on the CPU.

Slice test: a 2-layer GPT-2 (vocab 96, H 64, 2 heads, T 16, B 2; the
fixture of test_torch_training.py) trained by AdamOptimizer over an
exponentially decayed LR under a global-norm gradient clip, fed by a
deterministic reader through `reader.batch` and the DeviceFeeder, 2
passes of 3 batches, under both packages' `Trainer` from one
initialisation. Also: a preempted and resumed run equals an
uninterrupted one bitwise inside the port; a checkpoint either package
writes resumes in the other, bit-exact on every persistable, the step
and the position; and the port's twins of the Trainer and checkpoint
cases of tests/test_resilience.py and tests/test_flags_checkpoint.py on
a small linear model.

Tolerance across packages: every step's loss within LOSS_ATOL = 2e-5
absolute (both f32; the two packages' matmuls, reductions and softmax
round differently, ~1e-7 relative a step, and Adam's per-element
normalisation carries that into the next steps' weights; the 3-step
training test of test_torch_training.py holds 1e-5, this one runs 6
steps). Inside the port, and for what a checkpoint carries, bitwise.
"""

import os
import shutil
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.models.transformer  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch import flags, io, monitor, resilience
from paddle_tpu_torch.ops import registry as op_registry
from paddle_tpu_torch.resilience import (AnomalyPolicy, PreemptionShutdown,
                                         RetryPolicy, SimulatedCrash, faults)
from paddle_tpu_torch.weights import scope_from_numpy, scope_to_numpy

B, T, V, H, L, N_HEADS = 2, 16, 96, 64, 2, 2
N_BATCHES, PASSES = 3, 2
LOSS_ATOL = 2e-5


@pytest.fixture(autouse=True)
def clean_runtime():
    flags.reset()
    faults.reset()
    monitor.set_enabled(True)
    monitor.reset()
    jpt.flags.reset()
    jpt.resilience.faults.reset()
    yield
    flags.reset()
    faults.reset()
    monitor.reset()
    monitor.set_enabled(False)
    jpt.flags.reset()
    jpt.resilience.faults.reset()
    pt.clip.set_gradient_clip(None)
    jpt.clip.set_gradient_clip(None)


def _counters():
    return monitor.snapshot()["counters"]


# ---------------------------------------------------------------------------
# the slice: GPT-2 under both packages' Trainer
# ---------------------------------------------------------------------------

def _gpt2(P):
    """The GPT-2 training program of `P` with the standard recipe: Adam
    over an exponentially decayed LR, global-norm clipping."""
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        tok = P.layers.data("tok", [T, 1], dtype="int64")
        nxt = P.layers.data("nxt", [T, 1], dtype="int64")
        cost = P.models.transformer.transformer_lm_cost(
            tok, nxt, V, hid=H, num_layers=L, num_heads=N_HEADS, max_len=T)
        P.clip.set_gradient_clip(P.clip.GradientClipByGlobalNorm(1.0))
        lr = P.learning_rate_decay.exponential_decay(1e-3, 2, 0.7)
        P.AdamOptimizer(lr).minimize(cost)
        P.clip.set_gradient_clip(None)
    return main, startup, cost


def _examples(seed=11):
    rng = np.random.RandomState(seed)
    n = B * N_BATCHES
    tok = rng.randint(0, V, (n, T, 1)).astype(np.int64)
    nxt = rng.randint(0, V, (n, T, 1)).astype(np.int64)
    return [(tok[i], nxt[i]) for i in range(n)]


def _reader(P):
    examples = _examples()
    return P.reader.batch(lambda: iter(examples), B)


def _losses_handler(log, preempt_after=None, trainer=None):
    """Log (pass, batch, loss) of every step; with `preempt_after`,
    request preemption at that step's end, so the run stops at the next
    step boundary."""
    def handler(ev):
        if type(ev).__name__ == "EndIteration":
            log.append((ev.pass_id, ev.batch_id, float(ev.cost)))
            if (ev.pass_id, ev.batch_id) == preempt_after:
                trainer[0].request_preemption()
    return handler


def _jax_trainer(ckpt=None, init=None):
    main, startup, cost = _gpt2(jpt)
    scope = None
    if init is not None:
        scope = jpt.Scope()
        for k, v in init.items():
            scope.set(k, v)
    return jpt.Trainer(cost, place=jpt.CPUPlace(), main_program=main,
                       startup_program=startup, checkpoint_dir=ckpt,
                       scope=scope)


def _port_trainer(ckpt=None, init=None, **kw):
    main, startup, cost = _gpt2(pt)
    scope = scope_from_numpy(init, "cpu") if init is not None else None
    return pt.Trainer(cost, place=pt.CPUPlace(), main_program=main,
                      startup_program=startup, checkpoint_dir=ckpt,
                      scope=scope, **kw)


def _jax_init():
    t = _jax_trainer()
    return {k: np.array(t.scope.get(k)) for k in t.scope.keys()
            if not k.startswith("__")}


def _persistables(trainer):
    block = trainer.main_program.global_block()
    return {n: trainer.scope.get(n).detach().numpy().copy()
            for n, v in block.vars.items() if v.persistable}


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n].dtype == want[n].dtype, n
        assert np.array_equal(got[n], want[n]), n


@pytest.fixture(scope="module")
def jax_init():
    return _jax_init()


@pytest.fixture(scope="module")
def port_run(jax_init):
    """The port's uninterrupted run from the JAX initialisation: its
    per-step losses and final persistables."""
    t = _port_trainer(init=jax_init)
    log = []
    t.train(_reader(pt), PASSES, ["tok", "nxt"], _losses_handler(log))
    assert t.global_step == PASSES * N_BATCHES
    return log, _persistables(t)


def test_trainer_losses_match_jax_package(jax_init, port_run):
    t = _jax_trainer(init=jax_init)
    jlog = []
    t.train(_reader(jpt), PASSES, ["tok", "nxt"], _losses_handler(jlog))
    plog, _ = port_run
    assert [k[:2] for k in plog] == [k[:2] for k in jlog]
    assert len(plog) == PASSES * N_BATCHES
    for (p, b, lp), (_, _, lj) in zip(plog, jlog):
        assert abs(lp - lj) <= LOSS_ATOL, (p, b, lp, lj)
    assert plog[-1][2] < plog[0][2]


def test_preempted_resume_is_bitwise_in_port(jax_init, port_run, tmp_path):
    ck = str(tmp_path / "ck")
    holder = []
    t = _port_trainer(ck, init=jax_init)
    holder.append(t)
    log = []
    with pytest.raises(PreemptionShutdown, match="checkpoint saved"):
        t.train(_reader(pt), PASSES, ["tok", "nxt"],
                _losses_handler(log, preempt_after=(1, 0), trainer=holder))
    assert _counters()["resilience.preemption_saves"] == 1
    assert io.read_checkpoint_meta(ck)["extra"] == {"pass_id": 1,
                                                    "batch_id": 1}
    t2 = _port_trainer(ck)             # fresh scope, resumes from disk
    assert (t2.global_step, t2._start_pass, t2._start_batch) == (4, 1, 1)
    t2.train(_reader(pt), PASSES, ["tok", "nxt"], _losses_handler(log))
    ref_log, ref_state = port_run
    assert log == ref_log               # every step's loss, bitwise
    _assert_bitwise(_persistables(t2), ref_state)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(writer, jax_init, tmp_path):
    """The writer trains to (pass 1, batch 1) and is preempted; the
    reader package resumes from its checkpoint bit-exact on every
    persistable, the step and the position; both then finish the pass
    (2 steps) from copies of that checkpoint, losses within LOSS_ATOL."""
    ck = str(tmp_path / "ck")
    holder = []
    make = _jax_trainer if writer == "jax" else _port_trainer
    t = make(ck, init=jax_init)
    holder.append(t)
    with pytest.raises((PreemptionShutdown,
                        jpt.resilience.PreemptionShutdown)):
        t.train(_reader(jpt if writer == "jax" else pt), PASSES,
                ["tok", "nxt"],
                _losses_handler([], preempt_after=(1, 0), trainer=holder))
    with np.load(os.path.join(ck, "params.npz")) as data:
        saved = {n: data[n] for n in data.files}
    meta = io.read_checkpoint_meta(ck)
    assert meta["global_step"] == 4
    ck_port, ck_jax = str(tmp_path / "ck_port"), str(tmp_path / "ck_jax")
    shutil.copytree(ck, ck_port)
    shutil.copytree(ck, ck_jax)

    p = _port_trainer(ck_port)
    j = _jax_trainer(ck_jax)
    for tr, get in ((p, lambda n: p.scope.get(n).numpy()),
                    (j, lambda n: np.asarray(j.scope.get(n)))):
        assert (tr.global_step, tr._start_pass, tr._start_batch) == (4, 1, 1)
        block = tr.main_program.global_block()
        names = [n for n, v in block.vars.items() if v.persistable]
        assert sorted(names) == sorted(saved)
        for n in names:
            assert np.array_equal(get(n), saved[n]), n
    plog, jlog = [], []
    p.train(_reader(pt), PASSES, ["tok", "nxt"], _losses_handler(plog))
    j.train(_reader(jpt), PASSES, ["tok", "nxt"], _losses_handler(jlog))
    assert [k[:2] for k in plog] == [k[:2] for k in jlog] == [(1, 1),
                                                              (1, 2)]
    for (_, _, lp), (_, _, lj) in zip(plog, jlog):
        assert abs(lp - lj) <= LOSS_ATOL
    # each package's own random stream: the port keeps the generator
    # state under its own key and ignores the JAX key, and the other way
    with np.load(os.path.join(ck, "trainer_state.npz")) as data:
        keys = set(data.files)
    assert keys <= {"__rng_key__", "__torch_rng_state_cpu__"}


def test_gpt2_update_turned_non_finite_is_skipped_with_state_kept(jax_init):
    """Under AnomalyPolicy(skip_batch) the NaN guard is on: a step whose
    update turns non-finite (one parameter's Beta2Pow poked to 2.0, so
    sqrt(1 - beta2^t) is NaN) fires IterationSkipped, every persistable
    (parameters, moments, Beta*Pow, @LR_DECAY_COUNTER@) is bitwise its
    pre-step value and no scope tensor was written in place; training
    then goes on."""
    t = _port_trainer(init=jax_init,
                      anomaly_policy=AnomalyPolicy("skip_batch"))
    poked = "tok_emb_beta2_pow_0"
    assert poked in t.scope.keys()
    seen = {}

    def handler(ev):
        name = type(ev).__name__
        if name == "BeginIteration" and (ev.pass_id, ev.batch_id) == (0, 1):
            t.scope.get(poked).fill_(2.0)
            seen["before"] = _persistables(t)
            seen["versions"] = {n: v._version
                                for n, v in t.scope.vars.items()
                                if isinstance(v, torch.Tensor)}
            seen["tensors"] = dict(t.scope.vars)
        elif name == "IterationSkipped":
            seen["skipped"] = (ev.pass_id, ev.batch_id)
            _assert_bitwise(_persistables(t), seen["before"])
            for n, v in seen["tensors"].items():
                if isinstance(v, torch.Tensor):
                    assert t.scope.get(n) is v, n
                    assert v._version == seen["versions"][n], n
            t.scope.get(poked).fill_(float(jax_init[poked][0]))
        elif name == "EndIteration":
            seen.setdefault("after", []).append(float(ev.cost))

    t.train(_reader(pt), 1, ["tok", "nxt"], handler)
    assert seen["skipped"] == (0, 1)
    assert _counters()["executor.nan_guard_trips"] == 1
    assert _counters()["resilience.skipped_batches"] == 1
    assert len(seen["after"]) == N_BATCHES - 1
    assert np.isfinite(seen["after"]).all()
    assert flags.get("check_nan_inf") is False    # scoped to train()


# ---------------------------------------------------------------------------
# the resilience twins: a small linear model
# ---------------------------------------------------------------------------

N, D, BS = 48, 4, 8
BATCHES = N // BS     # 6 per pass


def _fit_data():
    rng = np.random.RandomState(3)
    x = rng.randn(N, D).astype(np.float32)
    w = rng.randn(D, 1).astype(np.float32)
    return x, (x @ w).astype(np.float32)


def _fit_reader(x, y):
    def rd():
        for i in range(0, N, BS):
            yield [(x[j], y[j]) for j in range(i, i + BS)]
    return rd


def _fit_trainer(checkpoint_dir=None, **kw):
    pt.framework.reset_default_programs()
    x = pt.layers.data(name="x", shape=[D], dtype="float32")
    y = pt.layers.data(name="y", shape=[1], dtype="float32")
    pred = pt.layers.fc(x, 1, param_attr=pt.ParamAttr(name="w_sup"))
    cost = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    kw.setdefault("retry_policy", RetryPolicy(max_attempts=3,
                                              backoff_base_s=0.001))
    return pt.Trainer(cost=cost, optimizer=pt.SGDOptimizer(0.05),
                      place=pt.CPUPlace(), checkpoint_dir=checkpoint_dir,
                      **kw)


def _reference_run(passes=2):
    x, y = _fit_data()
    t = _fit_trainer()
    t.train(reader=_fit_reader(x, y), num_passes=passes,
            feed_order=["x", "y"])
    return t.scope.get("w_sup").numpy().copy()


def _w(t):
    return t.scope.get("w_sup").numpy()


def _tiny_program_scope():
    pt.framework.reset_default_programs()
    x = pt.layers.data(name="x", shape=[4], dtype="float32")
    y = pt.layers.data(name="y", shape=[1], dtype="float32")
    pred = pt.layers.fc(x, 1, param_attr=pt.ParamAttr(name="w_ck"))
    cost = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    pt.SGDOptimizer(0.05).minimize(cost)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    return exe, scope, cost


def test_card_failures_classified():
    """torch.OutOfMemoryError is the card's RESOURCE_EXHAUSTED:
    transient. A sticky CUDA error leaves the context dead: never
    transient, even when its message holds a transient marker."""
    oom = resilience.retry._OOM("CUDA out of memory. Tried to allocate "
                                "2.00 GiB")
    assert resilience.is_transient(oom)
    for msg in ("CUDA error: an illegal memory access was encountered",
                "CUDA error: device-side assert triggered",
                "CUDA error: unspecified launch failure (ABORTED)"):
        assert not resilience.is_transient(RuntimeError(msg)), msg
    assert resilience.is_transient(RuntimeError("UNAVAILABLE: try again"))
    assert not resilience.is_transient(FloatingPointError("nan"))


def test_load_checkpoint_verifies_digests_and_falls_back(tmp_path):
    exe, scope, _ = _tiny_program_scope()
    ck = str(tmp_path / "ckpt")
    io.save_checkpoint(exe, ck, scope=scope, global_step=5)
    w_saved = scope.get("w_ck").numpy().copy()
    shutil.copytree(ck, ck + ".old")
    with open(os.path.join(ck, "params.npz"), "r+b") as f:
        f.seek(0, os.SEEK_END)
        f.write(b"garbage")
    scope.set("w_ck", torch.zeros(w_saved.shape))
    with pytest.warns(RuntimeWarning, match="missing or corrupt"):
        step = io.load_checkpoint(exe, ck, scope=scope)
    assert step == 5
    np.testing.assert_array_equal(scope.get("w_ck").numpy(), w_saved)
    assert _counters()["resilience.ckpt_fallback_loads"] == 1
    shutil.rmtree(ck + ".old")
    with pytest.raises(IOError, match="digest mismatch"):
        io.load_checkpoint(exe, ck, scope=scope)
    io.load_checkpoint(exe, ck, scope=scope, check_integrity=False)


def test_load_checkpoint_missing_meta_falls_back_to_old(tmp_path):
    exe, scope, _ = _tiny_program_scope()
    ck = str(tmp_path / "ckpt")
    io.save_checkpoint(exe, ck, scope=scope, global_step=3)
    os.rename(ck, ck + ".old")
    assert io.checkpoint_exists(ck)
    assert io.read_checkpoint_meta(ck)["global_step"] == 3
    with pytest.warns(RuntimeWarning):
        assert io.load_checkpoint(exe, ck, scope=scope) == 3
    os.rename(ck + ".old", str(tmp_path / "elsewhere"))
    assert not io.checkpoint_exists(ck)
    with pytest.raises(FileNotFoundError):
        io.load_checkpoint(exe, ck, scope=scope)


def test_crash_during_save_keeps_previous_checkpoint(tmp_path):
    exe, scope, _ = _tiny_program_scope()
    ck = str(tmp_path / "ckpt")
    io.save_checkpoint(exe, ck, scope=scope, global_step=1)
    w1 = scope.get("w_ck").numpy().copy()
    scope.set("w_ck", torch.from_numpy(w1 + 1.0))
    for site, step in (("ckpt_save", 2), ("ckpt_swap", 3)):
        flags.set_flag("faults", f"{site}:1:crash")
        faults.reset()
        with pytest.raises(SimulatedCrash):
            io.save_checkpoint(exe, ck, scope=scope, global_step=step)
        flags.set_flag("faults", "")
        faults.reset()
        probe = pt.Scope()
        assert io.checkpoint_exists(ck)
        assert io.load_checkpoint(exe, ck, scope=probe) == 1
        np.testing.assert_array_equal(probe.get("w_ck").numpy(), w1)
    io.save_checkpoint(exe, ck, scope=scope, global_step=4)
    assert io.load_checkpoint(exe, ck, scope=scope) == 4
    assert not os.path.exists(ck + ".old")


def test_save_checkpoint_retries_transient_io_errors(tmp_path):
    exe, scope, _ = _tiny_program_scope()
    ck = str(tmp_path / "ckpt")
    flags.set_flag("faults", "ckpt_save:1:OSError")
    faults.reset()
    io.save_checkpoint(exe, ck, scope=scope, global_step=9,
                       retry_policy=RetryPolicy(max_attempts=3,
                                                backoff_base_s=0.001))
    assert io.load_checkpoint(exe, ck, scope=scope) == 9
    c = _counters()
    assert c["resilience.ckpt_retries"] == 1
    assert c["resilience.retries"] == 1


def test_nan_guard_names_all_offending_variables():
    pt.framework.reset_default_programs()
    x = pt.layers.data(name="x", shape=[2], dtype="float32")
    a = pt.layers.sqrt(x)                  # NaN for negative input
    b = pt.layers.pow(x, factor=0.5)       # NaN for negative input
    exe = pt.Executor(pt.CPUPlace())
    flags.set_flag("check_nan_inf", True)
    bad = np.array([[-1.0, 1.0]], np.float32)
    with pytest.raises(FloatingPointError) as ei:
        exe.run(pt.default_main_program(), feed={"x": bad},
                fetch_list=[a, b], scope=pt.Scope())
    msg = str(ei.value)
    assert a.name in msg and b.name in msg
    assert _counters()["executor.nan_guard_trips"] == 1
    flags.set_flag("check_nan_inf", False)
    out = exe.run(pt.default_main_program(), feed={"x": bad},
                  fetch_list=[a], scope=pt.Scope())
    assert np.isnan(out[0]).any()          # guard off: flows out


def test_nan_guard_message_carries_trainer_step_context():
    pt.framework.reset_default_programs()
    x = pt.layers.data(name="x", shape=[2], dtype="float32")
    y = pt.layers.data(name="y", shape=[1], dtype="float32")
    pred = pt.layers.fc(x, 1)
    cost = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    flags.set_flag("check_nan_inf", True)
    trainer = pt.Trainer(cost=cost, optimizer=pt.SGDOptimizer(0.1),
                         place=pt.CPUPlace())

    def rd():
        yield [(np.array([np.nan, 1.0], np.float32),
                np.array([1.0], np.float32))]

    with pytest.raises(FloatingPointError, match="global step 0"):
        trainer.train(reader=rd, num_passes=1, feed_order=["x", "y"])


def test_nan_guard_preserves_pre_step_state():
    flags.set_flag("check_nan_inf", True)
    exe, scope, cost = _tiny_program_scope()
    main = pt.default_main_program()
    good = {"x": np.ones((2, 4), np.float32),
            "y": np.ones((2, 1), np.float32)}
    exe.run(main, feed=good, fetch_list=[cost], scope=scope)
    before = {n: v.clone() for n, v in scope.vars.items()
              if isinstance(v, torch.Tensor)}
    bad = {"x": np.full((2, 4), np.nan, np.float32),
           "y": np.ones((2, 1), np.float32)}
    with pytest.raises(FloatingPointError):
        exe.run(main, feed=bad, fetch_list=[cost], scope=scope)
    for n, v in before.items():
        assert torch.equal(scope.get(n), v), n
    assert not scope.state_invalidated
    out, = exe.run(main, feed=good, fetch_list=[cost], scope=scope)
    assert np.isfinite(out).all()


def test_transient_step_fault_is_retried_trajectory_identical():
    ref = _reference_run()
    x, y = _fit_data()
    flags.set_flag("faults", "step:4:RuntimeError")
    faults.reset()
    t = _fit_trainer()
    t.train(reader=_fit_reader(x, y), num_passes=2, feed_order=["x", "y"])
    assert t.global_step == 2 * BATCHES
    np.testing.assert_array_equal(_w(t), ref)
    c = _counters()
    assert c["resilience.retries"] == 1
    assert c["resilience.step_retries"] == 1


def test_step_retries_exhausted_raises_without_checkpoint():
    x, y = _fit_data()
    flags.set_flag("faults", "step:2+:RuntimeError")
    faults.reset()
    t = _fit_trainer(retry_policy=RetryPolicy(max_attempts=2,
                                              backoff_base_s=0.001))
    with pytest.raises(RuntimeError, match="injected transient"):
        t.train(reader=_fit_reader(x, y), num_passes=1,
                feed_order=["x", "y"])


def test_nan_skip_budget_exhaustion_raises_without_checkpoint():
    x, y = _fit_data()
    flags.set_flag("faults", "step:1+:nan")
    faults.reset()
    t = _fit_trainer(anomaly_policy=AnomalyPolicy(
        "skip_batch", max_consecutive_skips=2))
    with pytest.raises(RuntimeError, match="no checkpoint"):
        t.train(reader=_fit_reader(x, y), num_passes=1,
                feed_order=["x", "y"])
    assert _counters()["resilience.skipped_batches"] == 2


def test_nan_rollback_restores_and_completes(tmp_path):
    ref = _reference_run(passes=3)
    x, y = _fit_data()
    flags.set_flag("faults", "step:8:nan")
    faults.reset()
    t = _fit_trainer(checkpoint_dir=str(tmp_path / "ck"),
                     anomaly_policy=AnomalyPolicy("rollback"))
    t.train(reader=_fit_reader(x, y), num_passes=3, feed_order=["x", "y"])
    assert t.global_step == 3 * BATCHES
    np.testing.assert_array_equal(_w(t), ref)
    assert _counters()["resilience.rollbacks"] == 1


def test_deterministic_bad_batch_rollback_downgrades_to_skip(tmp_path):
    x, y = _fit_data()
    flags.set_flag("faults", "step:8=:nan")
    faults.reset()
    t = _fit_trainer(checkpoint_dir=str(tmp_path / "ck"),
                     anomaly_policy=AnomalyPolicy("rollback"))
    t.train(reader=_fit_reader(x, y), num_passes=2, feed_order=["x", "y"])
    assert t.global_step == 2 * BATCHES
    c = _counters()
    assert c["resilience.rollbacks"] == 1
    assert c["resilience.skipped_batches"] == 1
    assert c["resilience.anomalies"] == 2
    assert np.isfinite(_w(t)).all()


def test_skip_budget_resets_on_rollback(tmp_path):
    x, y = _fit_data()
    flags.set_flag("faults", "step:2=:nan,step:3=:nan,step:4=:nan")
    faults.reset()
    t = _fit_trainer(checkpoint_dir=str(tmp_path / "ck"),
                     anomaly_policy=AnomalyPolicy(
                         "skip_batch", max_consecutive_skips=2))
    t.train(reader=_fit_reader(x, y), num_passes=1, feed_order=["x", "y"])
    assert t.global_step == BATCHES
    c = _counters()
    assert c["resilience.rollbacks"] == 1
    assert c["resilience.skipped_batches"] == 5


def test_nan_guard_flag_is_scoped_to_train():
    x, y = _fit_data()
    t = _fit_trainer(anomaly_policy=AnomalyPolicy("skip_batch"))
    assert flags.get("check_nan_inf") is False
    seen = []
    t.train(reader=_fit_reader(x, y), num_passes=1, feed_order=["x", "y"],
            event_handler=lambda ev: seen.append(
                flags.get("check_nan_inf")))
    assert all(seen)
    assert flags.get("check_nan_inf") is False


def test_skipped_batch_fires_iteration_skipped_event():
    x, y = _fit_data()
    flags.set_flag("faults", "step:2:nan")
    faults.reset()
    t = _fit_trainer(anomaly_policy=AnomalyPolicy("skip_batch"))
    log = []
    t.train(reader=_fit_reader(x, y), num_passes=1, feed_order=["x", "y"],
            event_handler=lambda ev: log.append(type(ev).__name__))
    assert log.count("BeginIteration") == BATCHES
    assert log.count("EndIteration") == BATCHES - 1
    assert log.count("IterationSkipped") == 1


def test_loss_spike_skip_records_but_does_not_count_skipped():
    x, y = _fit_data()
    y_spiked = y.copy()
    y_spiked[3 * BS:4 * BS] *= 400.0
    t = _fit_trainer(anomaly_policy=AnomalyPolicy(
        "skip_batch", loss_spike_factor=50.0, min_history=2))
    t.train(reader=_fit_reader(x, y_spiked), num_passes=1,
            feed_order=["x", "y"])
    assert t.global_step == BATCHES
    c = _counters()
    assert c["resilience.loss_spikes"] >= 1
    assert c.get("resilience.skipped_batches", 0) == 0


def test_retry_exhaustion_with_checkpoint_rolls_back(tmp_path):
    ref = _reference_run(passes=2)
    x, y = _fit_data()
    flags.set_flag("faults", "step:8:RuntimeError")
    faults.reset()
    t = _fit_trainer(checkpoint_dir=str(tmp_path / "ck"),
                     retry_policy=RetryPolicy(max_attempts=1,
                                              backoff_base_s=0.001))
    t.train(reader=_fit_reader(x, y), num_passes=2, feed_order=["x", "y"])
    np.testing.assert_array_equal(_w(t), ref)
    assert _counters()["resilience.rollbacks"] == 1


def _fail_after_update(monkeypatch, at_call):
    """Make the `sgd` lowering raise a transient error right after its
    in-place update, on its `at_call`-th call (1-based)."""
    real = op_registry.get_op("sgd")
    calls = types.SimpleNamespace(n=0)

    def lowering(ctx, ins, attrs):
        out = real.lowering(ctx, ins, attrs)
        calls.n += 1
        if calls.n == at_call:
            raise RuntimeError("UNAVAILABLE: lost the card after the "
                               "update")
        return out

    monkeypatch.setitem(op_registry._REGISTRY, "sgd",
                        real._replace(lowering=lowering))
    return calls


@pytest.mark.parametrize("guard", [False, True])
def test_failed_in_place_step_is_restored_not_retried(monkeypatch, tmp_path,
                                                      guard):
    """Guard off: a step that failed after an update op wrote the scope
    in place is never retried (it would apply half an update twice): it
    is restored from the checkpoint and replayed, and the run equals the
    fault-free one. Guard on: the update wrote new tensors, nothing was
    committed, and the step is retried."""
    ref = _reference_run(passes=2)
    x, y = _fit_data()
    flags.set_flag("check_nan_inf", guard)
    # the fit model has two update ops a step: call 17 is the weight's
    # update in step 8 (pass 1, batch 2)
    _fail_after_update(monkeypatch, at_call=17)
    t = _fit_trainer(checkpoint_dir=str(tmp_path / "ck"))
    t.train(reader=_fit_reader(x, y), num_passes=2, feed_order=["x", "y"])
    np.testing.assert_array_equal(_w(t), ref)
    c = _counters()
    if guard:
        assert c["resilience.step_retries"] == 1
        assert c.get("resilience.rollbacks", 0) == 0
    else:
        assert c.get("resilience.step_retries", 0) == 0
        assert c["resilience.rollbacks"] == 1
    assert not t.scope.state_invalidated


def test_failed_in_place_step_without_checkpoint_raises(monkeypatch):
    x, y = _fit_data()
    _fail_after_update(monkeypatch, at_call=3)
    t = _fit_trainer()
    with pytest.raises(RuntimeError, match="lost the card"):
        t.train(reader=_fit_reader(x, y), num_passes=1,
                feed_order=["x", "y"])
    assert t.scope.state_invalidated
    assert _counters().get("resilience.step_retries", 0) == 0


def test_preemption_request_checkpoints_and_resumes(tmp_path):
    ref = _reference_run(passes=2)
    x, y = _fit_data()
    ck = str(tmp_path / "ck")
    t = _fit_trainer(checkpoint_dir=ck)

    def preempt(ev):
        if (isinstance(ev, pt.event.EndIteration)
                and ev.pass_id == 0 and ev.batch_id == 2):
            t.request_preemption()

    with pytest.raises(PreemptionShutdown, match="checkpoint saved"):
        t.train(reader=_fit_reader(x, y), num_passes=2,
                feed_order=["x", "y"], event_handler=preempt)
    assert _counters()["resilience.preemption_saves"] == 1
    t2 = _fit_trainer(checkpoint_dir=ck)
    assert t2.global_step == 3
    t2.train(reader=_fit_reader(x, y), num_passes=2, feed_order=["x", "y"])
    assert t2.global_step == 2 * BATCHES
    np.testing.assert_array_equal(_w(t2), ref)


def test_preemption_without_checkpoint_dir_still_exits_cleanly():
    x, y = _fit_data()
    t = _fit_trainer()
    t.request_preemption()
    with pytest.raises(PreemptionShutdown, match="nothing saved"):
        t.train(reader=_fit_reader(x, y), num_passes=1,
                feed_order=["x", "y"])


# ---------------------------------------------------------------------------
# the checkpoint twins (tests/test_flags_checkpoint.py)
# ---------------------------------------------------------------------------

def _noisy_program():
    """A model whose step draws from the scope's generator (noise added
    to the input), so a bitwise resume needs the saved generator
    state, and Adam, so it needs the moments."""
    pt.framework.reset_default_programs()
    x = pt.layers.data(name="x", shape=[16, 8], append_batch_size=False)
    y = pt.layers.data(name="y", shape=[16, 1], append_batch_size=False)
    noise = pt.layers.uniform_random([16, 8], min=-0.1, max=0.1)
    h = pt.layers.fc(x + noise, 16, act="gelu")
    pred = pt.layers.fc(h, 1)
    cost = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    pt.AdamOptimizer(learning_rate=0.01).minimize(cost)
    return cost


def _all_persistables(prog, scope):
    return {n: scope.get(n).numpy().copy()
            for n, v in prog.global_block().vars.items() if v.persistable}


def test_checkpoint_resume_bitwise_equal(tmp_path):
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(16, 8).astype(np.float32),
            "y": rng.randn(16, 1).astype(np.float32)}
    ckpt = str(tmp_path / "ckpt")
    cost = _noisy_program()
    prog = pt.default_main_program()
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    for _ in range(5):
        exe.run(prog, feed=feed, fetch_list=[cost], scope=scope)
    io.save_checkpoint(exe, ckpt, prog, scope=scope, global_step=5)
    for _ in range(5):
        exe.run(prog, feed=feed, fetch_list=[cost], scope=scope)
    ref = _all_persistables(prog, scope)
    scope2 = pt.Scope()
    assert io.load_checkpoint(exe, ckpt, prog, scope=scope2) == 5
    for _ in range(5):
        exe.run(prog, feed=feed, fetch_list=[cost], scope=scope2)
    _assert_bitwise(_all_persistables(prog, scope2), ref)


@pytest.mark.parametrize("fname", ["params.npz", "trainer_state.npz"])
def test_checkpoint_integrity_check(tmp_path, fname):
    cost = _noisy_program()
    prog = pt.default_main_program()
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    exe.run(prog, feed={"x": np.zeros((16, 8), np.float32),
                        "y": np.zeros((16, 1), np.float32)},
            fetch_list=[cost], scope=scope)
    ckpt = str(tmp_path / "ckpt")
    io.save_checkpoint(exe, ckpt, prog, scope=scope, global_step=1)
    path = os.path.join(ckpt, fname)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError, match=f"{fname} digest"):
        io.load_checkpoint(exe, ckpt, prog, scope=pt.Scope())


def test_checkpoint_overwrite_is_atomic(tmp_path):
    cost = _noisy_program()
    prog = pt.default_main_program()
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    feed = {"x": np.zeros((16, 8), np.float32),
            "y": np.zeros((16, 1), np.float32)}
    exe.run(prog, feed=feed, fetch_list=[cost], scope=scope)
    ckpt = str(tmp_path / "ckpt")
    io.save_checkpoint(exe, ckpt, prog, scope=scope, global_step=1)
    exe.run(prog, feed=feed, fetch_list=[cost], scope=scope)
    io.save_checkpoint(exe, ckpt, prog, scope=scope, global_step=2)
    assert not os.path.exists(ckpt + ".tmp")
    assert not os.path.exists(ckpt + ".old")
    assert io.load_checkpoint(exe, ckpt, prog, scope=pt.Scope()) == 2


def test_unported_options_raise_named_errors(tmp_path):
    exe, scope, cost = _tiny_program_scope()
    with pytest.raises(NotImplementedError, match="A11"):
        io.save_checkpoint(exe, str(tmp_path / "ck"), scope=scope,
                           sharded=True)
    scope.set("w_ck", scope.get("w_ck").to(torch.bfloat16))
    with pytest.raises(io.BF16PersistableError, match="w_ck"):
        io.save_checkpoint(exe, str(tmp_path / "ck"), scope=scope)
    # health_metrics is ported (monitor/health.py): it builds a monitor
    assert pt.Trainer(cost, place=pt.CPUPlace(),
                      health_metrics=True).health is not None
    with pytest.raises(NotImplementedError, match="A11"):
        pt.Trainer(cost, place=pt.CPUPlace(), parallelism={"dp": 2})
    if not torch.cuda.is_available():
        # the port's Trainer runs on the card unless told otherwise
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.Trainer(cost)


def test_test_sweep_never_updates_state():
    x, y = _fit_data()
    t = _fit_trainer()
    t.train(reader=_fit_reader(x, y), num_passes=1, feed_order=["x", "y"])
    before = scope_to_numpy(t.scope)
    result = t.test(_fit_reader(x, y), ["x", "y"])
    assert np.isfinite(result.cost)
    _assert_bitwise(scope_to_numpy(t.scope), before)
