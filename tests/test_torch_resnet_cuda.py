"""ResNet-50 on the card against the port on the CPU, and determinism.

Marked `cuda`: they skip on a machine without a CUDA card. This file
imports neither JAX nor the JAX package, so on a card machine it runs
alone:

    python -m pytest --noconftest tests/test_torch_resnet_cuda.py

Full-depth ResNet-50 at 64 x 64, 10 classes, B 4, f32 (TF32 off), from
one scope made by the port's startup on the CPU: one forward and one
Momentum step on the card and on the CPU.

  * Run free: the loss within 1e-4 relative; the fc weight and the
    running stats of the first and the last batch norm within 1e-4 of
    each array's largest element; the stem filter and the first
    batch-norm scale within 5e-2. Their gradients pass every residual
    block, and a relu input within f32 rounding of 0 (cuDNN and the
    CPU sum in other orders) takes the other side of the kink on one
    device: that element's gradient moves the stem's by a few percent.
  * Op by op: every op of the step lowered on the card on the CPU's
    values of its inputs, within 1e-4 of each output's largest element.

Then two identical two-step runs from one scope, f32 and bf16 amp, give
bitwise-equal losses, parameters and running stats (cuDNN pinned to
deterministic algorithms).
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch.executor import lower_ops_on
from torch_port_helpers import rel_err

HW, CLASSES, B = 64, 10, 4
REL = 1e-4
DEEP_REL = 5e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN convolutions on the device")
    return torch.device("cuda", torch.cuda.current_device())


def _program(use_amp=False):
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = pt.layers.data("img", [3, HW, HW])
        label = pt.layers.data("label", [1], dtype="int64")
        probs = pt.models.resnet.resnet50(img, class_dim=CLASSES)
        cost = pt.layers.mean(pt.layers.cross_entropy(probs, label))
        pt.MomentumOptimizer(learning_rate=0.01, momentum=0.9).minimize(cost)
    if use_amp:
        amp.enable(main)
    return main, startup, cost


def _init(startup):
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    return {k: v.clone() for k, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}


def _scope(init, device):
    scope = pt.Scope()
    for k, v in init.items():
        scope.set(k, v.to(device).clone())
    return scope


def _feed(seed):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(B, 3, HW, HW).astype(np.float32),
            "label": rng.randint(0, CLASSES, (B, 1)).astype(np.int64)}


@pytest.mark.cuda
def test_resnet50_step_on_the_card_matches_the_cpu(card):
    main, startup, cost = _program()
    init = _init(startup)
    feed = _feed(0)
    block = main.global_block()
    names = [n for n, v in block.vars.items()
             if not v.persistable and n not in feed]
    losses, scopes = [], []
    for place, dev in ((pt.CPUPlace(), "cpu"), (pt.CUDAPlace(0), card)):
        scope = _scope(init, dev)
        out = pt.Executor(place).run(
            main, feed=feed, fetch_list=[cost] + (names if dev == "cpu"
                                                  else []),
            scope=scope, return_numpy=False)
        losses.append(float(out[0][0]))
        if dev == "cpu":
            values = dict(zip(names, out[1:]))
        scopes.append(scope)
    stats = [n for n in block.vars if ".mean" in n or ".var" in n]
    tols = dict.fromkeys(["fc_0.w_0"] + stats[:2] + stats[-2:], REL)
    tols.update({"conv2d_0.w_0": DEEP_REL, "batch_norm_0.w_0": DEEP_REL})
    errs = {}
    for n in tols:
        want = scopes[0].get(n).numpy()
        got = scopes[1].get(n).cpu().numpy()
        assert not np.array_equal(want, init[n].numpy()), n
        errs[n] = float(np.abs(got - want).max() / np.abs(want).max())
    loss_err = abs(losses[1] - losses[0]) / abs(losses[0])
    print(f"card vs CPU run free: loss {losses} (relative {loss_err:.3e}), "
          f"state {errs}")
    assert loss_err <= REL, losses
    for n, e in errs.items():
        assert e <= tols[n], (n, e)
    for n, t in scopes[0].vars.items():
        if isinstance(t, torch.Tensor) and n in block.vars:
            values[n] = t
    values.update({k: torch.from_numpy(v) for k, v in feed.items()})
    op_errs = {n: rel_err(got, ref) for n, (got, ref) in
               lower_ops_on(main, card, init, values).items()}
    worst = max(op_errs, key=op_errs.get)
    print(f"op by op on the card: {len(op_errs)} outputs, worst "
          f"{op_errs[worst]:.3e} ({worst})")
    assert len(op_errs) > 1000
    assert op_errs[worst] <= REL, sorted((e, n) for n, e in op_errs.items()
                                         if e > REL)[-5:]


@pytest.mark.cuda
@pytest.mark.parametrize("use_amp", [False, True], ids=["f32", "amp"])
def test_resnet50_two_runs_on_the_card_are_bitwise_equal(card, use_amp):
    main, startup, cost = _program(use_amp)
    init = _init(startup)
    exe = pt.Executor(pt.CUDAPlace(0))
    runs = []
    for _ in range(2):
        scope = _scope(init, card)
        losses = [exe.run(main, feed=_feed(s), fetch_list=[cost],
                          scope=scope)[0] for s in (1, 2)]
        runs.append((losses, {k: v.cpu() for k, v in scope.vars.items()
                              if isinstance(v, torch.Tensor)}))
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    assert runs[0][1].keys() == runs[1][1].keys()
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
