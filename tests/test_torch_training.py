"""The port's training path (Program -> Executor -> Adam) against the
JAX package on the CPU.

Slice test: a 2-layer GPT-2 (vocab 96, H 64, 2 heads, T 16, B 2) is
built in both packages; the JAX `startup` initialises it, the scope is
carried into the port (`weights.scope_from_numpy`), and both take three
Adam steps on the same fed tokens. The reference runs with its Pallas
kernels forced on (flash attention and the lm-head lse, interpret mode
on the CPU). Also: equal Program text, the executor's contract, SGD,
and the bench's random-token program.
"""

import ast
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.models.transformer  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.weights import scope_from_numpy, scope_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, V, H, L, N_HEADS = 2, 16, 96, 64, 2, 2
LR = 1e-3
STEPS = 3


def _build(P, optimizer=None):
    """The GPT-2 training program of `P` (either package), tokens fed as
    data."""
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        tok = P.layers.data("tok", [T, 1], dtype="int64")
        nxt = P.layers.data("nxt", [T, 1], dtype="int64")
        cost = P.models.transformer.transformer_lm_cost(
            tok, nxt, V, hid=H, num_layers=L, num_heads=N_HEADS, max_len=T)
        _, params_grads = (optimizer or P.AdamOptimizer)(LR).minimize(cost)
    return main, startup, cost, params_grads


@pytest.fixture
def reference_kernels_forced():
    """The reference's flash attention and Pallas lse forced on (they run
    in interpret mode off the TPU), restored after."""
    prev = {k: jpt.flags.get(k) for k in ("flash_attention",
                                          "ce_pallas_lse")}
    for k in prev:
        jpt.flags.set_flag(k, True)
    yield
    for k, v in prev.items():
        jpt.flags.set_flag(k, v)


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"tok": rng.randint(0, V, (B, T, 1)).astype(np.int64),
            "nxt": rng.randint(0, V, (B, T, 1)).astype(np.int64)}


def test_both_packages_build_the_same_program_text():
    jmain, jstart, _, _ = _build(jpt)
    pmain, pstart, _, _ = _build(pt)
    assert pmain.to_dict() == jmain.to_dict()
    assert pstart.to_dict() == jstart.to_dict()
    types = {op.type for op in pmain.global_block().ops}
    assert {"lookup_table", "slice", "elementwise_add", "layer_norm",
            "mul", "gelu", "scaled_dot_product_attention",
            "fused_lm_head_xent", "mean", "sum", "fill_constant",
            "adam"} <= types


def test_gpt2_trains_like_the_jax_package(reference_kernels_forced):
    """Three Adam steps of the 2-layer GPT-2 in both packages from one
    initialisation.

    Tolerances: every step's loss within 1e-5 absolute (both f32, the
    sums taken in other orders); the step-1 gradient of every parameter
    within 1e-5 of its largest element; the parameters after step 3
    within 2e-5 absolute. Except the key biases (the middle third of
    each `qkv.b`): softmax is invariant to a per-row shift, so their
    true gradient is exactly zero, both packages compute rounding noise
    (~1e-9), and Adam's update m / (sqrt(v) + eps) turns noise of either
    sign into steps of up to lr — they are held to 2 * lr * steps."""
    jmain, jstart, jcost, jpg = _build(jpt)
    pmain, _, pcost, ppg = _build(pt)
    gnames = [g.name for _, g in jpg]
    assert gnames == [g.name for _, g in ppg]

    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    init = {k: np.array(jscope.get(k)) for k in jscope.keys()
            if not k.startswith("__")}
    pscope = scope_from_numpy(init, "cpu")
    pexe = pt.Executor(pt.CPUPlace())
    feed = _feed()
    for step in range(STEPS):
        fetch = [jcost.name] + (gnames if step == 0 else [])
        jout = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        pout = pexe.run(pmain, feed=feed, fetch_list=fetch, scope=pscope)
        np.testing.assert_allclose(pout[0], jout[0], rtol=0, atol=1e-5,
                                   err_msg=f"loss, step {step + 1}")
        for name, g, r in zip(gnames, pout[1:], jout[1:]):
            scale = float(np.abs(r).max())
            assert np.abs(g - r).max() <= 1e-5 * max(scale, 1e-30), name
    final = scope_to_numpy(pscope)
    for name in init:
        ref = np.asarray(jscope.get(name))
        diff = np.abs(final[name] - ref)
        if name.endswith(".qkv.b"):
            assert diff[H:2 * H].max() <= 2 * LR * STEPS, name
            diff = np.concatenate([diff[:H], diff[2 * H:]])
        assert diff.max() <= 2e-5, (name, float(diff.max()))


def test_port_loss_falls_on_a_fixed_batch():
    """The port's own startup (generator-seeded) and Adam: the loss on a
    fixed batch falls over five steps."""
    main, startup, cost, _ = _build(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = _feed(1)
    losses = [float(exe.run(main, feed=feed, fetch_list=[cost],
                            scope=scope)[0][0]) for _ in range(5)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.1, losses


def test_sgd_step_matches_the_jax_package():
    jmain, jstart, jcost, _ = _build(jpt, optimizer=jpt.SGDOptimizer)
    pmain, _, pcost, _ = _build(pt, optimizer=pt.SGDOptimizer)
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    pscope = scope_from_numpy({k: np.array(jscope.get(k))
                               for k in jscope.keys()
                               if not k.startswith("__")}, "cpu")
    pexe = pt.Executor(pt.CPUPlace())
    for _ in range(2):
        jl = jexe.run(jmain, feed=_feed(), fetch_list=[jcost.name],
                      scope=jscope)
        pl = pexe.run(pmain, feed=_feed(), fetch_list=[pcost.name],
                      scope=pscope)
        np.testing.assert_allclose(pl[0], jl[0], rtol=0, atol=1e-5)
    final = scope_to_numpy(pscope)
    for name in final:
        np.testing.assert_allclose(final[name], np.asarray(jscope.get(name)),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_bench_random_token_program_builds_alike_and_runs():
    """bench.py's feed: tokens drawn by uniform_random, floor and cast
    inside the program (the port draws from its generator)."""
    def build(P):
        P.framework.reset_default_programs()
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            lf = P.layers.uniform_random([B, T, 1], min=1.0,
                                         max=float(V) - 0.01)
            tok = P.layers.cast(P.layers.floor(lf), "int64")
            nxt = P.layers.cast(P.layers.floor(P.layers.uniform_random(
                [B, T, 1], min=1.0, max=float(V) - 0.01)), "int64")
            cost = P.models.transformer.transformer_lm_cost(
                tok, nxt, V, hid=H, num_layers=L, num_heads=N_HEADS,
                max_len=T)
            P.AdamOptimizer(LR).minimize(cost)
        return main, startup, cost, tok
    jmain, jstart, _, _ = build(jpt)
    main, startup, cost, tok = build(pt)
    assert main.to_dict() == jmain.to_dict()
    assert startup.to_dict() == jstart.to_dict()
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    loss, toks = exe.run(main, fetch_list=[cost, tok], scope=scope)
    assert np.isfinite(loss).all() and toks.dtype == np.int64
    assert toks.min() >= 1 and toks.max() < V
    _, toks2 = exe.run(main, fetch_list=[cost, tok], scope=scope)
    assert not np.array_equal(toks, toks2)     # fresh draws each run


def test_executor_contract():
    main, startup, cost, _ = _build(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    with pytest.raises(RuntimeError, match="run the startup program"):
        exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope)
    exe.run(startup, scope=scope)
    with pytest.raises(RuntimeError, match="must be fed"):
        exe.run(main, feed={"tok": _feed()["tok"]}, fetch_list=[cost],
                scope=scope)
    # int32 feeds are coerced to the data var's int64
    feed = {k: v.astype(np.int32) for k, v in _feed().items()}
    out = exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                  return_numpy=False)
    assert isinstance(out[0], torch.Tensor) and out[0].shape == (1,)
    # the default place is the card: it raises where there is none
    if torch.cuda.is_available():
        assert pt.Executor().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA card"):
            pt.Executor()


def test_scope_numpy_round_trip_keeps_dtypes():
    arrays = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
              "ids": np.array([3, 1], np.int64)}
    scope = scope_from_numpy(arrays, "cpu")
    assert scope.get("ids").dtype == torch.int64
    back = scope_to_numpy(scope)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


def test_training_modules_import_no_jax_or_reference():
    """The AST import rule over the modules this slice added, named one
    by one (the package-wide walk is
    test_torch_lm_serving.py::test_port_and_chip_smoke_import_no_jax_or_reference)."""
    mods = ["framework", "initializer", "param_attr", "layer_helper",
            "regularizer", "clip", "backward", "optimizer", "executor",
            "weights", "_build", "layers/__init__", "layers/io",
            "layers/tensor", "layers/nn", "layers/math_ops",
            "models/__init__", "models/transformer", "ops/__init__",
            "ops/registry", "ops/grad", "ops/math_ops", "ops/nn_ops",
            "ops/tensor_ops", "ops/attention_ops", "ops/chunked_ce",
            "ops/optimizer_ops", "ops/flash_attention"]
    paths = [os.path.join(REPO, "paddle_tpu_torch", m + ".py") for m in mods]
    paths.append(os.path.join(REPO, "chip_smoke.py"))
    bad = []
    for path in paths:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, m) for m in names
                    if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, bad


def test_attention_and_loss_shapes_infer_on_meta_tensors():
    """Build-time shape inference runs the torch lowerings on meta
    tensors: the -1 batch stays -1 through the whole model."""
    main, _, cost, _ = _build(pt)
    block = main.global_block()
    sdpa = next(op for op in block.ops
                if op.type == "scaled_dot_product_attention")
    assert block.var(sdpa.output("Out")[0]).shape == (-1, T, H)
    xent = next(op for op in block.ops if op.type == "fused_lm_head_xent")
    assert block.var(xent.output("Loss")[0]).shape == (-1, T, 1)
    assert cost.shape == (1,)


def test_regularization_and_gradient_clip_match_the_jax_package():
    """minimize's hooks: L2 decay on every gradient and a parameter's
    clip-by-value, on a small regression, one SGD step in both
    packages from one initialisation."""
    from paddle_tpu import clip as jclip
    from paddle_tpu import regularizer as jreg
    from paddle_tpu_torch import clip as pclip
    from paddle_tpu_torch import regularizer as preg

    def build(P, clip, reg):
        P.framework.reset_default_programs()
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            x = P.layers.data("x", [8], dtype="float32")
            y = P.layers.fc(x, 4, param_attr=P.ParamAttr(
                name="w", gradient_clip=clip.GradientClipByValue(0.05)))
            cost = P.layers.mean(y)
            P.SGDOptimizer(0.5, regularization=reg.L2DecayRegularizer(
                0.1)).minimize(cost)
        return main, startup, cost
    jmain, jstart, jcost = build(jpt, jclip, jreg)
    pmain, _, pcost = build(pt, pclip, preg)
    assert pmain.to_dict() == jmain.to_dict()
    types = [op.type for op in pmain.global_block().ops]
    assert "clip" in types and "scale" in types
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    pscope = scope_from_numpy({k: np.array(jscope.get(k))
                               for k in jscope.keys()
                               if not k.startswith("__")}, "cpu")
    feed = {"x": np.random.RandomState(2).randn(5, 8).astype(np.float32)}
    jexe.run(jmain, feed=feed, fetch_list=[jcost.name], scope=jscope)
    pt.Executor(pt.CPUPlace()).run(pmain, feed=feed,
                                   fetch_list=[pcost.name], scope=pscope)
    final = scope_to_numpy(pscope)
    for name in final:
        np.testing.assert_allclose(final[name], np.asarray(jscope.get(name)),
                                   rtol=0, atol=1e-6, err_msg=name)
