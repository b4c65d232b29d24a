"""GPT-2-medium's amp gradients at its width, the port against the JAX
package on the CPU (ROADMAP C8).

On the card, GPT-2-medium's amp step-1 gradients reach 1.79e-2 of their
largest element against a plain amp recompute (`stack.Bproj`, 24
layers), under chip_smoke.py's tolerance of 2e-2. This file attributes
that margin at GPT-2-medium's width (H 1024, 16 heads of 64) with 2
layers and T 128 (vocab 512: the head's width does not enter the
stack's gradients): the stacked amp program of both packages from one
initialisation, the reference with its Pallas kernels (interpret mode)
and again with its XLA attention and lse. The port's gradients differ
from the reference's by no more than the reference's two routes differ
from each other, which is bf16 rounding noise, not a place where the
port rounds and the reference does not.
"""

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.models.transformer  # noqa: F401
from paddle_tpu import amp as jamp
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp, flags
from paddle_tpu_torch.weights import scope_from_numpy

H, N_HEADS, L, T, B, V = 1024, 16, 2, 128, 2, 512
# chip_smoke.py's AMP_GRAD_RTOL, unchanged
GRAD_RTOL = 2e-2


def _build(P, A):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        tok = P.layers.data("tok", [T, 1], dtype="int64")
        nxt = P.layers.data("nxt", [T, 1], dtype="int64")
        cost = P.models.transformer.transformer_lm_cost(
            tok, nxt, V, hid=H, num_layers=L, num_heads=N_HEADS,
            max_len=T, stacked=True)
        _, params_grads = P.AdamOptimizer(1e-4).minimize(cost)
    A.enable(main)
    return main, startup, cost, params_grads


def _feed():
    rng = np.random.RandomState(0)
    return {"tok": rng.randint(0, V, (B, T, 1)).astype(np.int64),
            "nxt": rng.randint(0, V, (B, T, 1)).astype(np.int64)}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.fixture
def restore_flags():
    prev = {k: jpt.flags.get(k) for k in ("flash_attention",
                                          "ce_pallas_lse")}
    remat = flags.get("remat")
    yield
    for k, v in prev.items():
        jpt.flags.set_flag(k, v)
    flags.set_flag("remat", remat)


def test_medium_width_amp_gradients_are_within_the_references_own_spread(
        restore_flags):
    feed = _feed()
    ref = {}
    for route in ("pallas", "xla"):
        for k in ("flash_attention", "ce_pallas_lse"):
            jpt.flags.set_flag(k, route == "pallas")
        jmain, jstart, jcost, jpg = _build(jpt, jamp)
        jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
        jexe.run(jstart, scope=jscope)
        if route == "pallas":
            init = {k: np.array(jscope.get(k)) for k in jscope.keys()
                    if not k.startswith("__")}
        gnames = [g.name for _, g in jpg]
        ref[route] = jexe.run(jmain, feed=feed,
                              fetch_list=[jcost.name] + gnames,
                              scope=jscope)
    flags.set_flag("remat", True)
    pmain, _, pcost, _ = _build(pt, amp)
    pout = pt.Executor(pt.CPUPlace()).run(
        pmain, feed=feed, fetch_list=[pcost.name] + gnames,
        scope=scope_from_numpy(init, "cpu"))
    port = {g: _rel(p, r) for g, p, r in zip(gnames, pout[1:],
                                              ref["pallas"][1:])}
    spread = {g: _rel(a, b) for g, a, b in zip(gnames, ref["pallas"][1:],
                                                ref["xla"][1:])}
    assert len(port) == 17
    worst = max(port, key=port.get)
    assert port[worst] <= GRAD_RTOL, (worst, port[worst])
    # the port is no further from the reference than the reference's two
    # routes are from each other (measured: 1.33e-2 against 1.58e-2)
    assert max(port.values()) <= 1.5 * max(spread.values()), (port, spread)
    loss_p = float(np.ravel(pout[0])[0])
    loss_r = float(np.ravel(ref["pallas"][0])[0])
    assert abs(loss_p - loss_r) <= 2e-3 * abs(loss_r)
