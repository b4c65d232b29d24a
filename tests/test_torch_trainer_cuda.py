"""The trainer slice's card-only paths: the DeviceFeeder's side-stream
copy and the NaN guard's all-or-nothing commit on CUDA tensors.

Marked `cuda`: they skip on a machine without a CUDA card (the side
stream, pinned memory and the caching allocator's stream bookkeeping
exist only there). This file imports neither JAX nor the JAX package,
so on a card machine without JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_trainer_cuda.py
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import flags
from paddle_tpu_torch.reader import DeviceFeeder
from paddle_tpu_torch.reader import pipeline

ROWS, COLS = 4096, 4096          # a 64 MiB float32 batch
SLEEP_CYCLES = 400_000_000       # ~0.2 s of the compute stream at ~2 GHz


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the side stream, pinned memory and "
                    "the caching allocator's stream bookkeeping")
    flags.reset()
    yield torch.device("cuda", torch.cuda.current_device())
    flags.reset()


def _program():
    pt.framework.reset_default_programs()
    x = pt.layers.data("x", [COLS])
    cost = pt.layers.mean(x)
    return pt.default_main_program(), cost


def _batches(n):
    def reader():
        for i in range(n):
            yield {"x": np.full((ROWS, COLS), float(i + 1), np.float32)}
    return reader


def _late_sums(feeder):
    """Each batch read by the compute stream only after ~0.2 s of sleep,
    its last reference dropped before that read runs, and the next
    batch copied (on the side stream) meanwhile."""
    sums = []
    for feed in feeder:
        torch.cuda._sleep(SLEEP_CYCLES)
        sums.append(feed["x"].sum(dtype=torch.float64))
        del feed
    torch.cuda.synchronize()
    return [float(s) for s in sums]


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [0, 1])
def test_side_stream_batch_survives_reallocation_under_a_running_step(
        card, workers):
    """The batch tensors are allocated on the side stream and read on
    the compute stream: `record_stream` keeps the caching allocator from
    handing a freed batch's memory to the next batch's copy while the
    compute stream still has to read it."""
    main, _ = _program()
    exe = pt.Executor(pt.CUDAPlace(0))
    n = 4
    feeder = DeviceFeeder(_batches(n), main, exe, workers=workers,
                          prefetch_depth=1)
    want = [float(ROWS * COLS * (i + 1)) for i in range(n)]
    assert _late_sums(feeder) == want


@pytest.mark.cuda
def test_without_record_stream_the_reuse_race_shows(card, monkeypatch):
    """Control for the test above: with the hand-over's record_stream
    taken out, the next batch's copy lands in the memory the compute
    stream has yet to read, and the late sums come out wrong — so the
    test above can see the fault it guards against."""
    def hand_over_without_record(self, item):
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(item.event)
        return item.feed

    monkeypatch.setattr(pipeline.DeviceFeeder, "_hand_over",
                        hand_over_without_record)
    main, _ = _program()
    exe = pt.Executor(pt.CUDAPlace(0))
    n = 4
    feeder = DeviceFeeder(_batches(n), main, exe, workers=0,
                          prefetch_depth=1)
    want = [float(ROWS * COLS * (i + 1)) for i in range(n)]
    assert _late_sums(feeder) != want


@pytest.mark.cuda
def test_executor_takes_the_fed_card_tensor_without_a_copy(card):
    main, cost = _program()
    exe = pt.Executor(pt.CUDAPlace(0))
    feed = next(iter(DeviceFeeder(_batches(1), main, exe, workers=0)))
    ptr = feed["x"].data_ptr()
    seen = {}
    real = exe._coerce_feed

    def spy(program, name, val):
        out = real(program, name, val)
        seen[name] = out.data_ptr()
        return out

    exe._coerce_feed = spy
    exe.run(main, feed=feed, fetch_list=[cost], scope=pt.Scope())
    assert seen["x"] == ptr


def _adam_model():
    pt.framework.reset_default_programs()
    x = pt.layers.data("x", [64])
    y = pt.layers.data("y", [1])
    h = pt.layers.fc(x, 64, act="gelu")
    pred = pt.layers.fc(h, 1, param_attr=pt.ParamAttr(name="w_out"))
    cost = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(1.0))
    try:
        pt.AdamOptimizer(pt.learning_rate_decay.exponential_decay(
            1e-2, 2, 0.5)).minimize(cost)
    finally:
        pt.clip.set_gradient_clip(None)
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    return pt.default_main_program(), exe, scope, cost


def _feed(seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(32, 64).astype(np.float32),
            "y": rng.randn(32, 1).astype(np.float32)}


@pytest.mark.cuda
def test_nan_guard_commits_all_or_nothing_on_the_card(card):
    """With check_nan_inf on, a step whose update turns non-finite
    (Beta2Pow 2.0: sqrt(1 - beta2^t) is NaN) names the parameter and
    leaves every scope tensor — the same objects, unwritten — at its
    pre-step value; the next clean step equals the step of a run that
    never saw the bad one."""
    flags.set_flag("check_nan_inf", True)
    main, exe, scope, cost = _adam_model()
    exe.run(main, feed=_feed(0), fetch_list=[cost], scope=scope)
    ref_scope = pt.Scope()
    for n, v in scope.vars.items():
        ref_scope.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    poked = "w_out_beta2_pow_0"
    kept = scope.get(poked).clone()
    scope.get(poked).fill_(2.0)
    before = {n: (v, v.clone(), v._version) for n, v in scope.vars.items()
              if isinstance(v, torch.Tensor)}
    with pytest.raises(FloatingPointError, match="w_out"):
        exe.run(main, feed=_feed(1), fetch_list=[cost], scope=scope)
    for n, (obj, val, version) in before.items():
        assert scope.get(n) is obj and obj._version == version, n
        assert torch.equal(obj, val), n
    assert not scope.state_invalidated
    scope.get(poked).copy_(kept)
    got, = exe.run(main, feed=_feed(2), fetch_list=[cost], scope=scope)
    want, = exe.run(main, feed=_feed(2), fetch_list=[cost],
                    scope=ref_scope)
    assert np.array_equal(got, want)


@pytest.mark.cuda
def test_failed_in_place_step_marks_the_scope_on_the_card(card,
                                                          monkeypatch):
    main, exe, scope, cost = _adam_model()
    from paddle_tpu_torch.ops import registry
    real = registry.get_op("adam")

    def lowering(ctx, ins, attrs):
        real.lowering(ctx, ins, attrs)
        raise RuntimeError("UNAVAILABLE: failed after the update")

    monkeypatch.setitem(registry._REGISTRY, "adam",
                        real._replace(lowering=lowering))
    with pytest.raises(RuntimeError, match="after the update"):
        exe.run(main, feed=_feed(0), fetch_list=[cost], scope=scope)
    assert scope.state_invalidated
