"""bf16 mixed precision (paddle_tpu_torch/amp.py) against the JAX
package's amp on the CPU.

The port twins of tests/test_amp.py: the role table's casts, disable,
f32 weight gradients, the Program dict round trip and loose agreement
with f32 training on the fc regression. (The conv-net twin waits for the
port's conv2d.) Then the slice test: a 2-layer GPT-2 (vocab 512, H 128,
2 heads so D 64, T 64, B 2) under amp in both packages from the same
numpy weights, with the reference's Pallas kernels forced on (interpret
mode off the TPU, bf16 operands): every var of one step has the same
dtype in both, and three Adam steps agree.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.models.transformer  # noqa: F401
from paddle_tpu import amp as jamp
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch.weights import scope_from_numpy

B, T, V, H, L, N_HEADS = 2, 64, 512, 128, 2, 2
LR = 1e-3
STEPS = 3


def test_cast_ins_roles():
    f32 = torch.zeros(2, 2)
    bf16 = torch.zeros(2, 2, dtype=torch.bfloat16)
    i32 = torch.zeros(2, 2, dtype=torch.int32)

    # compute: f32 -> bf16 (ints untouched)
    out = amp.cast_ins("mul", {"X": [f32], "Y": [i32]}, torch.bfloat16)
    assert out["X"][0].dtype == torch.bfloat16
    assert out["Y"][0].dtype == torch.int32

    # f32 role: bf16 -> f32
    out = amp.cast_ins("softmax", {"X": [bf16]}, torch.bfloat16)
    assert out["X"][0].dtype == torch.float32

    # follow: casts only when an amp operand is present
    ins = {"X": [f32], "Y": [f32]}
    assert amp.cast_ins("elementwise_add", ins, torch.bfloat16) is ins
    out = amp.cast_ins("elementwise_add", {"X": [bf16], "Y": [f32]},
                       torch.bfloat16)
    assert out["Y"][0].dtype == torch.bfloat16

    # unlisted ops pass through unchanged, and so does a dict with
    # nothing to cast
    ins = {"X": [f32]}
    assert amp.cast_ins("relu", ins, torch.bfloat16) is ins
    ins = {"X": [bf16], "Y": [i32]}
    assert amp.cast_ins("mul", ins, torch.bfloat16) is ins


def test_role_table_is_the_reference_table():
    assert amp.ROLES == jamp.ROLES


def test_amp_disable_and_policy():
    prog = pt.Program()
    amp.enable(prog)
    assert amp.is_enabled(prog)
    assert amp.amp_dtype_of(prog) == torch.bfloat16
    policy = amp.active_policy(prog)
    assert policy.dtype == "bfloat16"
    assert policy.torch_dtype == torch.bfloat16
    assert policy.roles["mul"] == "compute"
    amp.disable(prog)
    assert amp.amp_dtype_of(prog) is None
    assert amp.active_policy(prog) is None
    with pytest.raises(ValueError, match="only bfloat16"):
        amp.enable(prog, dtype="float16")


def _regression(P, seed=None):
    """fc + square_error_cost + mean on [16, 32] rows (either
    package)."""
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        x = P.layers.data("x", [32])
        y = P.layers.data("y", [1])
        pred = P.layers.fc(input=x, size=1)
        cost = P.layers.mean(P.layers.square_error_cost(pred, y))
    startup.seed = seed
    return main, startup, cost


def test_amp_weight_grads_are_f32():
    """The amp cast lives inside the taped graph, so master-weight
    gradients come back f32 (not bf16-quantized)."""
    main, startup, cost = _regression(pt)
    with pt.program_guard(main, startup):
        grads = pt.append_backward(cost)
    amp.enable(main)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    gname = [g.name for p, g in grads if p.name.endswith("w_0")][0]
    g, = exe.run(main, feed={"x": np.ones((4, 32), np.float32),
                             "y": np.ones((4, 1), np.float32)},
                 fetch_list=[gname], scope=scope, return_numpy=False)
    assert g.dtype == torch.float32


def test_amp_survives_serialization_as_the_reference_writes_it():
    progs = {}
    for P, A in ((jpt, jamp), (pt, amp)):
        main, _, _ = _regression(P)
        A.enable(main)
        progs[P.__name__] = main.to_dict()
    assert progs["paddle_tpu_torch"] == progs["paddle_tpu"]
    assert progs["paddle_tpu_torch"]["amp_dtype"] == "bfloat16"
    clone = pt.framework.Program.from_dict(progs["paddle_tpu_torch"])
    assert amp.amp_dtype_of(clone) == torch.bfloat16
    main, _, _ = _regression(pt)
    assert "amp_dtype" not in main.to_dict()
    assert amp.amp_dtype_of(pt.framework.Program.from_dict(
        main.to_dict())) is None


def test_amp_matches_f32_loosely():
    """bf16 compute tracks the f32 result within bf16 tolerance (the
    reference test's rtol 0.1 over ten SGD steps)."""
    rng = np.random.RandomState(1)
    xs = rng.randn(16, 32).astype(np.float32)
    w = rng.randn(32, 1).astype(np.float32)
    ys = (xs @ w).astype(np.float32)

    def run(use_amp):
        main, startup, cost = _regression(pt, seed=7)
        with pt.program_guard(main, startup):
            pt.SGDOptimizer(0.01).minimize(cost)
        if use_amp:
            amp.enable(main)
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        losses = [float(exe.run(main, feed={"x": xs, "y": ys},
                                fetch_list=[cost], scope=scope)[0][0])
                  for _ in range(10)]
        return np.asarray(losses), scope

    lf, _ = run(False)
    la, scope = run(True)
    np.testing.assert_allclose(la, lf, rtol=0.1)
    assert all(t.dtype == torch.float32 for t in scope.vars.values()
               if isinstance(t, torch.Tensor) and t.is_floating_point())


def test_a_bf16_fetch_comes_back_as_f32_numpy():
    """numpy has no bfloat16: a fetched amp activation is upcast to
    float32 (exactly); the tensor itself stays bf16 with
    return_numpy=False."""
    main, startup, cost = _regression(pt)
    amp.enable(main)
    mul_out = next(op for op in main.global_block().ops
                   if op.type == "mul").output("Out")[0]
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(0).randn(4, 32).astype(np.float32),
            "y": np.zeros((4, 1), np.float32)}
    arr, = exe.run(main, feed=feed, fetch_list=[mul_out], scope=scope)
    t, = exe.run(main, feed=feed, fetch_list=[mul_out], scope=scope,
                 return_numpy=False)
    assert t.dtype == torch.bfloat16 and arr.dtype == np.float32
    np.testing.assert_array_equal(arr, t.float().numpy())


# -- the slice: GPT-2 under amp in both packages ---------------------------

def _gpt2(P, A):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        tok = P.layers.data("tok", [T, 1], dtype="int64")
        nxt = P.layers.data("nxt", [T, 1], dtype="int64")
        cost = P.models.transformer.transformer_lm_cost(
            tok, nxt, V, hid=H, num_layers=L, num_heads=N_HEADS, max_len=T)
        _, params_grads = P.AdamOptimizer(LR).minimize(cost)
    A.enable(main)
    return main, startup, cost, params_grads


@pytest.fixture
def both():
    """Both packages' amp GPT-2 from the JAX startup's weights, with the
    reference's flash attention and Pallas lse forced on (restored
    after)."""
    prev = {k: jpt.flags.get(k) for k in ("flash_attention",
                                          "ce_pallas_lse")}
    for k in prev:
        jpt.flags.set_flag(k, True)
    jmain, jstart, jcost, jpg = _gpt2(jpt, jamp)
    pmain, _, pcost, ppg = _gpt2(pt, amp)
    assert pmain.to_dict() == jmain.to_dict()
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    pscope = scope_from_numpy({k: np.array(jscope.get(k))
                               for k in jscope.keys()
                               if not k.startswith("__")}, "cpu")
    rng = np.random.RandomState(0)
    feed = {"tok": rng.randint(0, V, (B, T, 1)).astype(np.int64),
            "nxt": rng.randint(0, V, (B, T, 1)).astype(np.int64)}
    yield dict(jmain=jmain, jexe=jexe, jscope=jscope, jcost=jcost, jpg=jpg,
               pmain=pmain, pexe=pt.Executor(pt.CPUPlace()), pscope=pscope,
               pcost=pcost, ppg=ppg, feed=feed)
    for k, v in prev.items():
        jpt.flags.set_flag(k, v)


def test_every_var_of_an_amp_step_has_the_reference_dtype(both):
    """One amp step with every computed var fetched: each var's dtype in
    the port equals the JAX package's — the residual stream turning
    bf16 at block 0's residual add, bf16 activations and their
    gradients, f32 layer-norm statistics, loss and weight gradients."""
    b = both
    block = b["pmain"].global_block()
    names = [n for n, v in block.vars.items()
             if not v.persistable and n not in b["feed"]]
    jout = b["jexe"].run(b["jmain"], feed=b["feed"], fetch_list=names,
                         scope=b["jscope"])
    pout = b["pexe"].run(b["pmain"], feed=b["feed"], fetch_list=names,
                         scope=b["pscope"], return_numpy=False)
    got = {n: str(t.dtype).replace("torch.", "") for n, t in
           zip(names, pout)}
    want = {n: str(np.asarray(a).dtype) for n, a in zip(names, jout)}
    assert got == want
    dtypes = set(want.values())
    assert {"bfloat16", "float32"} <= dtypes, dtypes
    for _, g in b["ppg"]:
        assert want[g.name] == "float32", g.name
    # the first residual add (f32 embeddings + bf16 attention out) is bf16
    first_add = next(op for op in block.ops
                     if op.type == "elementwise_add"
                     and op.input("X")[0].startswith("elementwise_add"))
    assert want[first_add.output("Out")[0]] == "bfloat16"


def test_gpt2_trains_under_amp_like_the_jax_package(both):
    """Three Adam steps under bf16 amp in both packages.

    Tolerances (bf16 keeps 8 significand bits, one ulp 2^-8 = 3.9e-3
    relative): every step's loss within 2e-3 relative — the loss sums
    f32 products of bf16 operands, and the operands differ between the
    packages by an ulp here and there (gelu, layer norm and the bias
    gradients round in other places in XLA and torch); the step-1
    gradient of every parameter within 3e-2 of its largest element
    (read 1.6e-2 at worst, the bias gradients: sums over B*T of bf16
    cotangents). Master weights, both moments and every gradient stay
    f32."""
    b = both
    gnames = [g.name for _, g in b["jpg"]]
    assert gnames == [g.name for _, g in b["ppg"]]
    for step in range(STEPS):
        fetch = [b["jcost"].name] + (gnames if step == 0 else [])
        jout = b["jexe"].run(b["jmain"], feed=b["feed"], fetch_list=fetch,
                             scope=b["jscope"])
        pout = b["pexe"].run(b["pmain"], feed=b["feed"], fetch_list=fetch,
                             scope=b["pscope"], return_numpy=False)
        jl, pl = float(np.asarray(jout[0])[0]), float(pout[0][0])
        assert abs(pl - jl) <= 2e-3 * abs(jl), (step + 1, pl, jl)
        for name, g, r in zip(gnames, pout[1:], jout[1:]):
            assert g.dtype == torch.float32, name
            r = np.asarray(r, np.float32)
            err = float(np.abs(g.numpy() - r).max())
            assert err <= 3e-2 * float(np.abs(r).max()), (name, err)
    floats = [(n, t) for n, t in b["pscope"].vars.items()
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for _, t in floats)
    assert any("moment" in n for n, _ in floats)
