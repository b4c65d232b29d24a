"""The telemetry's card-only half: model health and per-op attribution
of an amp GPT-2 step on the card (chip_smoke.py phase 26 (a)-(b) at a
small size: H 128 in 2 heads of 64, 2 layers, T 128, B 4, vocab 1024).

Marked `cuda`: they skip on a machine without a CUDA card (the bf16
kernels, CUDA events and the profiler's device activity exist only
there). This file imports neither JAX nor the JAX package, so on a card
machine it runs alone:

    python -m pytest --noconftest tests/test_torch_telemetry_cuda.py
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp, flags, monitor
from paddle_tpu_torch.ops import chunked_ce as ce
from paddle_tpu_torch.ops import flash_attention as fa

V, H, L, N_HEADS, T, B = 1024, 128, 2, 2, 128, 4
# the bf16 kernels' wrappers and their device kernels' name fragments
KERNELS = {"fwd": (fa.flash_attn_fwd_bf16, ("flash_fwd_bf16_kernel",)),
           "fused": (fa.flash_attn_bwd_fused_bf16,
                     ("bwd_fused_bf16_kernel",)),
           "dq": (fa.flash_attn_bwd_dq_bf16, ("bwd_dq_bf16_kernel",)),
           "dkv": (fa.flash_attn_bwd_dkv_bf16, ("bwd_dkv_bf16_kernel",)),
           "lse": (ce.lm_head_lse_bf16, ("lse_bf16_kernel",
                                         "lse_bf16_merge_kernel"))}


@pytest.fixture
def amp_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bf16 kernels and the "
                    "profiler's device activity")
    flags.reset()
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        tok = pt.layers.data("tok", [T, 1], dtype="int64")
        nxt = pt.layers.data("nxt", [T, 1], dtype="int64")
        cost = pt.models.transformer.transformer_lm_cost(
            tok, nxt, V, hid=H, num_layers=L, num_heads=N_HEADS, max_len=T)
        pt.AdamOptimizer(1e-4).minimize(cost)
    amp.enable(main)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {k: rng.randint(0, V, (B, T, 1)).astype(np.int64)
            for k in ("tok", "nxt")}
    yield main, cost, exe, scope, feed
    flags.reset()


def _rel(got, ref):
    got, ref = got.double().ravel(), ref.double().ravel()
    return float(((got - ref).abs() / ref.abs().clamp_min(1e-300)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("guard", [False, True])
def test_health_values_equal_float64_recomputes(amp_step, guard):
    main, cost, exe, scope, feed = amp_step
    H_ = monitor.health
    flags.set_flag("check_nan_inf", guard)
    pairs = H_.param_grad_pairs(main)
    pre = {p: scope.get(p).detach().double() for p, _ in pairs}
    out = exe.run(main, feed=feed, fetch_list=[cost.name] + [
        g for _, g in pairs] + list(H_.FETCHES), scope=scope,
        return_numpy=False)
    grads = out[1:1 + len(pairs)]
    gn64 = torch.sqrt(sum(g.double().square().sum() for g in grads))
    post = {p: scope.get(p).detach().double() for p, _ in pairs}
    pn64 = torch.sqrt(sum(v.square().sum() for v in post.values()))
    r64 = torch.stack([torch.linalg.vector_norm(post[p] - pre[p])
                       / (torch.linalg.vector_norm(pre[p]) + 1e-12)
                       for p, _ in pairs])
    assert _rel(out[-3], gn64) <= 1e-5
    assert _rel(out[-2], pn64) <= 1e-5
    assert _rel(out[-1], r64) <= 1e-5


@pytest.mark.cuda
def test_attribution_covers_the_step_and_counts_every_kernel(amp_step):
    main, cost, exe, scope, feed = amp_step
    for w, _ in KERNELS.values():
        w.launches = 0
    rep = monitor.deviceprof.profile_program(main, feed, [cost.name], scope,
                                             exe, steps=3, warmup=1)
    assert rep["mode"] == "device"
    assert rep["coverage"] >= 0.9, rep["coverage"]
    launched = 0
    for w, frags in KERNELS.values():
        per_step = w.launches / 4
        launched += per_step
        for frag in frags:
            events = sum(k["events_per_step"]
                         for n, k in rep["kernels"].items() if frag in n)
            assert events == per_step, (frag, events, per_step)
    assert launched > 0
    scopes = {monitor.deviceprof.op_scope(0, i, op.type)
              for i, op in enumerate(main.global_block().ops)}
    assert all(r["scope"] in scopes for r in rep["rows"])
