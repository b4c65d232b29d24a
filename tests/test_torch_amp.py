"""bf16 mixed precision (paddle_tpu_torch/amp.py) against the JAX
package's amp on the CPU.

The port twins of tests/test_amp.py: the role table's casts, disable,
f32 weight gradients, the Program dict round trip, loose agreement
with f32 training on the fc regression, and the mnist conv net training
under amp with its weights f32; every var of one amp step of a ResNet
(conv, batch norm, residual add, pool) has the reference's dtype and,
op by op on the reference's inputs, its values (the loss and the
running stats also run free). Then
the slice test: a 2-layer GPT-2 (vocab 512, H 128,
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
from paddle_tpu_torch.executor import lower_ops_on
from paddle_tpu_torch.weights import scope_from_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401

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


# -- the image path under amp ----------------------------------------------

@pytest.mark.usefixtures("one_torch_thread")
def test_amp_conv_net_trains_weights_stay_f32():
    """The twin of tests/test_amp.py::test_amp_conv_net_trains_weights_
    stay_f32: the mnist conv net under bf16 amp, Adam 1e-3, 40 steps on
    the reference's data; the loss falls below 0.7 of the first, every
    float in the scope and the fetched loss stay f32."""
    rng = np.random.RandomState(0)
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = pt.layers.data("img", [1, 28, 28])
        label = pt.layers.data("label", [1], dtype="int64")
        probs = pt.models.mnist.conv_net(img)
        cost = pt.layers.mean(pt.layers.cross_entropy(probs, label))
        pt.AdamOptimizer(1e-3).minimize(cost)
    amp.enable(main)
    assert amp.is_enabled(main)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    xs = rng.rand(32, 1, 28, 28).astype(np.float32)
    ys = (xs.mean(axis=(1, 2, 3)) > 0.5).astype(np.int64)[:, None]
    losses = []
    for _ in range(40):
        loss, = exe.run(main, feed={"img": xs, "label": ys},
                        fetch_list=[cost], scope=scope)
        losses.append(float(loss.ravel()[0]))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    floats = [t for t in scope.vars.values()
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)
    assert loss.dtype == np.float32


@pytest.fixture(scope="module")
def amp_resnet():
    """One amp step of resnet_cifar10 (depth 8, 16 x 16, B 2, Momentum
    0.1 / 0.9) in the JAX package from its startup, every var fetched
    (the persistables after the step), and the port's program from the
    same numpy weights, run free on the same feed. Torch runs in one
    thread (see torch_port_helpers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.RandomState(3)
    feed = {"img": rng.rand(2, 3, 16, 16).astype(np.float32),
            "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}
    built = {}
    for P, A in ((jpt, jamp), (pt, amp)):
        P.framework.reset_default_programs()
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            img = P.layers.data("img", [3, 16, 16])
            label = P.layers.data("label", [1], dtype="int64")
            probs = P.models.resnet.resnet_cifar10(img, class_dim=10,
                                                   depth=8)
            cost = P.layers.mean(P.layers.cross_entropy(probs, label))
            P.MomentumOptimizer(0.1, 0.9).minimize(cost)
        A.enable(main)
        built[P] = (main, startup, cost)
    jmain, jstart, jcost = built[jpt]
    pmain, _, pcost = built[pt]
    assert pmain.to_dict() == jmain.to_dict()
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    init = {k: np.array(jscope.get(k)) for k in jscope.keys()
            if not k.startswith("__")}
    block = pmain.global_block()
    names = [n for n in block.vars if n not in feed]
    jout = jexe.run(jmain, feed=feed, fetch_list=names, scope=jscope)
    pscope = scope_from_numpy(init, "cpu")
    temps = [n for n in names if not block.vars[n].persistable]
    pout = pt.Executor(pt.CPUPlace()).run(
        pmain, feed=feed, fetch_list=temps, scope=pscope,
        return_numpy=False)
    torch.set_num_threads(threads)
    return dict(feed=feed, init=init, pmain=pmain, cost=pcost.name,
                jax={n: np.asarray(v) for n, v in zip(names, jout)},
                port=dict(zip(temps, pout)), pscope=pscope)


def test_every_var_of_an_amp_resnet_step_has_the_reference_dtype(
        amp_resnet):
    """One amp step of resnet_cifar10 with every computed var fetched:
    each var's dtype in the port equals the JAX package's — bf16 conv
    outputs, batch-norm Y and residual adds (f32 statistics inside),
    pools and relus in what reaches them, f32 softmax, loss and weight
    gradients."""
    r = amp_resnet
    want = {n: str(r["jax"][n].dtype) for n in r["port"]}
    got = {n: str(t.dtype).replace("torch.", "")
           for n, t in r["port"].items()}
    assert got == want
    kinds = {}
    for n, d in got.items():
        kinds.setdefault(n.split("_")[0] + ("@GRAD" if "@GRAD" in n
                                            else ""), set()).add(d)
    assert kinds["conv2d"] == {"bfloat16"}
    assert kinds["batch"] == {"bfloat16", "float32"}   # Y; saved stats
    assert kinds["cross"] == kinds["mean"] == {"float32"}


# amp ResNet step against the JAX package (readings on the CPU, in
# brackets). Op by op, each output within AMP_OP_REL of its largest
# element [6.2e-3, a batch-norm X@GRAD]: bf16 outputs differ by an ulp
# (2^-8 = 3.9e-3 relative) where the two round a sum in another order;
# the f32 weight gradients are bf16 inside the tape in both and cast
# after [3.0e-3]; the reference's batch statistics of a bf16 X are
# 6.4e-4 off the exact float64 mean [the port's: 6e-8]. So the port's
# running stats are also held to float64 from the same X within
# AMP_STAT_EXACT [6e-8], which an unbiased or a two-pass variance would
# miss. Run free, a bf16 ulp flips relu inputs and the gradients of
# either package lie 15-50 % from the f32 run's (the port's no farther
# than the reference's); the loss [1.3e-3 relative] and the running
# stats [3.6e-3 of their largest] are held.
AMP_OP_REL, AMP_STAT_EXACT = 1e-2, 1e-6
AMP_LOSS_REL, AMP_FREE_STAT_REL = 5e-3, 1e-2


@pytest.mark.usefixtures("one_torch_thread")
def test_amp_resnet_step_matches_the_jax_package(amp_resnet):
    """The amp ResNet step's values against the JAX package's: op by
    op (forward, the grad ops' casts and batch-norm backward, the
    Momentum updates and the running stats) within AMP_OP_REL; the
    running stats exactly as float64 computes them from the same X;
    run free, the loss and the running stats."""
    r = amp_resnet
    pmain, jax_vals = r["pmain"], r["jax"]
    pairs = lower_ops_on(pmain, "cpu", r["init"], {**jax_vals, **r["feed"]})
    block = pmain.global_block()
    persist = [n for n, v in block.vars.items() if v.persistable]
    assert {n for n in persist if not n.startswith("learning_rate")} \
        <= set(pairs)
    assert sum("@GRAD" in n for n in pairs) > 40
    for n, (got, want) in pairs.items():
        assert got.dtype == want.dtype, n
        got, want = got.double(), want.double()
        tol = AMP_OP_REL * max(float(want.abs().max()), 1e-30)
        assert float((got - want).abs().max()) <= tol, n
    stats = 0
    for op in block.ops:
        if op.type != "batch_norm":
            continue
        x = torch.from_numpy(jax_vals[op.input("X")[0]].astype(np.float64))
        m = op.attrs["momentum"]
        mean = x.mean(dim=(0, 2, 3))
        var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
        for slot, batch in (("Mean", mean), ("Variance", var)):
            before = torch.from_numpy(
                r["init"][op.input(slot)[0]].astype(np.float64))
            exact = before * m + batch * (1 - m)
            got = pairs[op.output(slot + "Out")[0]][0].double()
            assert float((got - exact).abs().max()) <= AMP_STAT_EXACT * \
                float(exact.abs().max()), (op.output(slot + "Out")[0])
            stats += 1
    assert stats == 18
    loss = float(r["port"][r["cost"]][0])
    want = float(jax_vals[r["cost"]][0])
    assert abs(loss - want) <= AMP_LOSS_REL * abs(want), (loss, want)
    for n in persist:
        if ".mean" in n or ".var" in n:
            want = jax_vals[n].astype(np.float64)
            got = r["pscope"].get(n).double().numpy()
            assert not np.array_equal(want, r["init"][n]), n
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=AMP_FREE_STAT_REL * float(np.abs(want).max()),
                err_msg=n)
