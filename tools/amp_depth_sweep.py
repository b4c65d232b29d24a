"""GPT-2-medium's amp gradients at its width, by depth: the port against
the JAX package, and the JAX package against itself (ROADMAP C8).

    JAX_PLATFORMS=cpu python tools/amp_depth_sweep.py [LAYERS ...]

For each layer count (default 1 2 4 8) builds the stacked GPT-2 at H
1024, 16 heads, T 128, B 2, vocab 512 with bf16 amp in both packages
from the JAX package's initialisation, and prints, for every gradient,
max |a - b| / max |b| of: the port against the JAX package with its
Pallas kernels (interpret mode), the JAX package's Pallas route
against its XLA route, and the JAX package's amp against its f32.
CPU only; ~15 s a layer count.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu.models.transformer  # noqa: E402,F401
from paddle_tpu import amp as jamp  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import amp, flags  # noqa: E402
from paddle_tpu_torch.weights import scope_from_numpy  # noqa: E402

H, N_HEADS, T, B, V = 1024, 16, 128, 2, 512


def build(P, A, L):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        tok = P.layers.data("tok", [T, 1], dtype="int64")
        nxt = P.layers.data("nxt", [T, 1], dtype="int64")
        cost = P.models.transformer.transformer_lm_cost(
            tok, nxt, V, hid=H, num_layers=L, num_heads=N_HEADS,
            max_len=T, stacked=True)
        _, params_grads = P.AdamOptimizer(1e-4).minimize(cost)
    if A is not None:
        A.enable(main)
    return main, startup, cost, params_grads


def rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def sweep(L):
    rng = np.random.RandomState(0)
    feed = {k: rng.randint(0, V, (B, T, 1)).astype(np.int64)
            for k in ("tok", "nxt")}
    ref = {}
    for route in ("pallas", "xla", "f32"):
        for k in ("flash_attention", "ce_pallas_lse"):
            jpt.flags.set_flag(k, route == "pallas")
        jmain, jstart, jcost, jpg = build(
            jpt, None if route == "f32" else jamp, L)
        jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
        jexe.run(jstart, scope=jscope)
        if route == "pallas":
            init = {k: np.array(jscope.get(k)) for k in jscope.keys()
                    if not k.startswith("__")}
        names = [g.name for _, g in jpg]
        ref[route] = jexe.run(jmain, feed=feed, fetch_list=names,
                              scope=jscope)
    flags.set_flag("remat", True)
    pmain, _, _, _ = build(pt, amp, L)
    port = pt.Executor(pt.CPUPlace()).run(
        pmain, feed=feed, fetch_list=names,
        scope=scope_from_numpy(init, "cpu"))
    print(f"layers {L}: gradient, port vs JAX (Pallas), JAX Pallas vs "
          f"XLA, JAX amp vs f32")
    for i, n in enumerate(names):
        print(f"  {n:24s} {rel(port[i], ref['pallas'][i]):.3e}  "
              f"{rel(ref['pallas'][i], ref['xla'][i]):.3e}  "
              f"{rel(ref['pallas'][i], ref['f32'][i]):.3e}", flush=True)


if __name__ == "__main__":
    for layers in [int(a) for a in sys.argv[1:]] or [1, 2, 4, 8]:
        sweep(layers)
