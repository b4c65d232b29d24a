"""The f32 conv2d the port runs on the card where cuDNN's weight gradient
was measured wrong (`ops/nn_ops.py::cudnn_wgrad_faulty`, `_Conv2dF32`;
ROADMAP C39): the rule against the shapes `tools/grouped_conv_probe.py`
read on the card, `_Conv2dF32`'s output and both gradients against
F.conv2d's in float64 on the CPU, cuDNN switched off for the weight
gradient alone and back on after (also with two threads interleaved,
ROADMAP C40), and a CPU tensor never routed. On a
card (marker `cuda`): the lowering's weight gradient at AlexNet's
conv2 within 1e-5 of the float64 sum. This file imports neither JAX
nor the JAX package.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_weight

from paddle_tpu_torch.ops import nn_ops

# (N, C, O, side, kernel, stride, pad, dilation, groups)
CASES = [(4, 6, 8, 11, 3, 1, 1, 1, 1), (5, 6, 8, 13, 5, 2, 2, 1, 2),
         (3, 4, 6, 12, 3, 1, 2, 2, 2), (2, 3, 9, 17, 4, 3, 0, 1, 3),
         (6, 8, 4, 9, 5, 1, 2, 1, 4)]

# (kernel, stride, input channels a group, in the routed family): the
# probe's readings on the card (ROADMAP C39); every True row but
# (5, 1, 256) was 2.1e-3-3.3e-2 off in some reading there, every False
# row within 8.3e-5 in all
READINGS = [(5, 1, 24, True), (5, 1, 32, True), (5, 1, 40, True),
            (5, 1, 48, True), (5, 1, 64, True), (5, 1, 96, True),
            (5, 1, 192, True), (5, 1, 256, True), (5, 1, 1, False),
            (5, 1, 3, False), (5, 1, 16, False), (5, 1, 20, False),
            (5, 2, 64, False), (4, 1, 12, False), (4, 1, 128, False),
            (7, 1, 64, False), (7, 2, 3, False), (11, 4, 3, False),
            (11, 1, 64, False), (3, 1, 48, False), (3, 1, 256, False),
            (1, 1, 256, False)]


def _case(N, C, O, H, k, s, p, d, g):
    gen = torch.Generator().manual_seed(N * 100 + C)
    x = torch.randn(N, C, H, H, dtype=torch.float64, generator=gen)
    w = torch.randn(O, C // g, k, k, dtype=torch.float64, generator=gen)
    y = F.conv2d(x, w, stride=s, padding=p, dilation=d, groups=g)
    return x, w, torch.randn(y.shape, dtype=torch.float64, generator=gen)


@pytest.mark.parametrize("k,s,cg,routed", READINGS)
def test_rule_matches_the_probe(k, s, cg, routed):
    w = torch.empty(16, cg, k, k)
    assert nn_ops.cudnn_wgrad_faulty(w, (s, s)) is routed


@pytest.mark.parametrize("case", CASES)
def test_conv_function_equals_conv2d(case):
    N, C, O, H, k, s, p, d, g = case
    x, w, gy = _case(*case)
    x.requires_grad_(True)
    w.requires_grad_(True)
    ref = F.conv2d(x, w, stride=s, padding=p, dilation=d, groups=g)
    got = nn_ops._Conv2dF32.apply(x, w, (s, s), (p, p), (d, d), g)
    assert torch.equal(got, ref)
    for a, b in zip(torch.autograd.grad(got, [x, w], gy),
                    torch.autograd.grad(ref, [x, w], gy)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-10)


def test_weight_gradient_runs_with_cudnn_off(monkeypatch):
    seen = []
    weight = torch.nn.grad.conv2d_weight

    def spy(*args):
        seen.append(torch.backends.cudnn.enabled)
        return weight(*args)

    monkeypatch.setattr(torch.nn.grad, "conv2d_weight", spy)
    x, w, gy = _case(*CASES[1])
    w.requires_grad_(True)
    before = torch.backends.cudnn.enabled
    out = nn_ops._Conv2dF32.apply(x, w, (2, 2), (2, 2), (1, 1), 2)
    got, = torch.autograd.grad(out, [w], gy)
    assert seen == [False]
    assert torch.backends.cudnn.enabled == before
    np.testing.assert_allclose(
        got.numpy(), conv2d_weight(x, w.shape, gy, stride=2, padding=2,
                                   groups=2).numpy(), rtol=0, atol=1e-10)


def test_two_threads_leave_cudnn_as_it_was(monkeypatch):
    """ROADMAP C40: two weight gradients on two threads, interleaved by
    events (A enters, B enters, A leaves, B leaves) against a stand-in
    for torch.backends.cudnn. cuDNN stays off while either is inside
    and is back at its value from before once both are out; a bare
    save / set / restore of the flag would leave it off."""
    import threading
    import types

    fake = types.SimpleNamespace(enabled=True)
    monkeypatch.setattr(torch.backends, "cudnn", fake)
    weight = torch.nn.grad.conv2d_weight
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen, errors = {}, []

    def spy(*args):
        me = threading.current_thread().name
        seen[me + " in"] = fake.enabled
        if me == "A":
            a_in.set()
            assert b_in.wait(10)
        else:
            b_in.set()
            assert a_out.wait(10)
            seen["B after A left"] = fake.enabled
        return weight(*args)

    monkeypatch.setattr(torch.nn.grad, "conv2d_weight", spy)
    x, w, gy = _case(*CASES[1])
    w.requires_grad_(True)

    def grad():
        try:
            out = nn_ops._Conv2dF32.apply(x, w, (2, 2), (2, 2), (1, 1), 2)
            torch.autograd.grad(out, [w], gy)
        except Exception as e:           # re-raised below
            errors.append(e)

    ta = threading.Thread(target=grad, name="A", daemon=True)
    tb = threading.Thread(target=grad, name="B", daemon=True)
    ta.start()
    assert a_in.wait(10)
    tb.start()
    ta.join(10)
    assert not ta.is_alive(), "thread A hung"
    a_out.set()
    tb.join(10)
    assert not tb.is_alive(), "thread B hung"
    assert not errors, errors
    assert seen == {"A in": False, "B in": False, "B after A left": False}
    assert fake.enabled is True and nn_ops._cudnn_off_depth == 0


def test_a_cpu_tensor_takes_the_plain_conv(monkeypatch):
    def fail(*args):
        raise AssertionError("routed a CPU tensor")

    monkeypatch.setattr(nn_ops._Conv2dF32, "apply", fail)
    x = torch.randn(2, 48, 9, 9)
    w = torch.randn(8, 48, 5, 5)
    assert nn_ops.cudnn_wgrad_faulty(w, (1, 1))
    torch.testing.assert_close(nn_ops._conv2d_f(x, w, padding=(2, 2)),
                               F.conv2d(x, w, padding=2), rtol=0, atol=0)


@pytest.mark.cuda
def test_alexnet_conv2_weight_gradient_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch._device import use_full_f32
    use_full_f32()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(128, 96, 27, 27).astype(np.float32))
    w = torch.from_numpy((rng.randn(256, 48, 5, 5) * 0.05).astype(
        np.float32))
    gy = torch.from_numpy(rng.randn(128, 256, 27, 27).astype(np.float32))
    ref = conv2d_weight(x.double(), w.shape, gy.double(), padding=2,
                        groups=2)
    xc, wc = x.cuda().requires_grad_(True), w.cuda().requires_grad_(True)
    out = nn_ops._conv2d_f(xc, wc, padding=(2, 2), groups=2)
    gw, = torch.autograd.grad(out, [wc], gy.cuda())
    err = float((gw.double().cpu() - ref).abs().max() / ref.abs().max())
    assert err <= 1e-5, err
