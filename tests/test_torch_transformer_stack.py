"""The stacked transformer (`transformer_stack`) in the port against the
JAX package on the CPU.

Small size: 2 layers, H 64, 2 heads (D 32), B 2, T 16 and T 65 (one row
past the kernels' 64-row tile). The same numpy inputs from a seed go
through the JAX lowering and the port's; the reference runs its Pallas
flash kernels in interpret mode (`reference_kernels_forced`). Then the
stacked GPT-2 front end: the Program text, three Adam steps, amp, the
remat flag, shape inference on meta tensors, and the backward's layer
split.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.models.transformer  # noqa: F401
from paddle_tpu import amp as jamp
from paddle_tpu.ops import transformer_ops as JT
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp, flags
from paddle_tpu_torch.ops import transformer_ops as PT
from paddle_tpu_torch.weights import scope_from_numpy, scope_to_numpy

B, L, H, N_HEADS = 2, 2, 64, 2
LEAVES = JT._LEAVES
ATTRS = {"num_heads": N_HEADS, "causal": True, "pp_axis": "",
         "tp_axis": "", "num_microbatches": 4, "pp_schedule": "gpipe"}


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


@pytest.fixture
def remat_flag():
    """Set the port's remat flag for one test (restored after)."""
    prev = flags.get("remat")
    yield lambda on: flags.set_flag("remat", on)
    flags.set_flag("remat", prev)


def _stack_inputs(T, seed=0):
    """X and the twelve stacked leaves, numpy f32: gains near 1, biases
    and weights large enough that attention is far from uniform."""
    rng = np.random.RandomState(seed)
    F = 4 * H
    shapes = {"Ln1G": (L, H), "Ln1B": (L, H), "Wqkv": (L, H, 3 * H),
              "Bqkv": (L, 3 * H), "Wproj": (L, H, H), "Bproj": (L, H),
              "Ln2G": (L, H), "Ln2B": (L, H), "Wup": (L, H, F),
              "Bup": (L, F), "Wdown": (L, F, H), "Bdown": (L, H)}
    ins = {"X": rng.randn(B, T, H).astype(np.float32)}
    for name, shape in shapes.items():
        if name in ("Ln1G", "Ln2G"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name.startswith("W"):
            v = 0.15 * rng.randn(*shape)
        else:
            v = 0.05 * rng.randn(*shape)
        ins[name] = v.astype(np.float32)
    cot = rng.randn(B, T, H).astype(np.float32)
    return ins, cot


def _jax_out_and_grads(ins, cot):
    ctx = types.SimpleNamespace(mesh=None)
    names = ["X"] + LEAVES

    def f(*vals):
        return JT._transformer_stack(
            ctx, {n: [v] for n, v in zip(names, vals)}, ATTRS)["Out"][0]
    out, vjp = jax.vjp(f, *[jnp.asarray(ins[n]) for n in names])
    grads = vjp(jnp.asarray(cot))
    return np.asarray(out), dict(zip(names, map(np.asarray, grads)))


def _port_out_and_grads(ins, cot):
    names = ["X"] + LEAVES
    leaves = {n: torch.from_numpy(ins[n]).requires_grad_() for n in names}
    out = PT._transformer_stack(None, {n: [leaves[n]] for n in names},
                                ATTRS)["Out"][0]
    grads = torch.autograd.grad(out, [leaves[n] for n in names],
                                torch.from_numpy(cot))
    return out.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("T", [16, 65])
def test_stack_output_and_all_13_gradients_match_the_jax_lowering(
        reference_kernels_forced, remat_flag, T, remat):
    """Out within 1e-5 absolute; each of the 13 input gradients within
    1e-5 of its largest element (f32 both sides, sums in other orders)."""
    ins, cot = _stack_inputs(T, seed=T)
    jout, jgrads = _jax_out_and_grads(ins, cot)
    remat_flag(remat)
    pout, pgrads = _port_out_and_grads(ins, cot)
    np.testing.assert_allclose(pout.numpy(), jout, rtol=0, atol=1e-5)
    assert set(pgrads) == set(jgrads) and len(pgrads) == 13
    for name, g in pgrads.items():
        ref = jgrads[name]
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= 1e-5 * scale, (name, err, scale)


def test_remat_on_equals_remat_off_bitwise_on_the_cpu(remat_flag):
    """Checkpointing recomputes the same layer on the same inputs: the
    output and every gradient are the same bits (the reference holds
    this at rtol 1e-5)."""
    ins, cot = _stack_inputs(65, seed=1)
    remat_flag(False)
    off = _port_out_and_grads(ins, cot)
    remat_flag(True)
    on = _port_out_and_grads(ins, cot)
    assert torch.equal(on[0], off[0])
    for name in off[1]:
        assert torch.equal(on[1][name], off[1][name]), name


def _grad_graph_nodes(out):
    nodes, seen, todo = [], set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        nodes.append(fn)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return nodes


@pytest.mark.parametrize("remat", [False, True])
def test_backward_stacks_the_layer_gradients_once(remat_flag, remat):
    """The stacked leaves are split by one unbind each (its backward
    stacks the L layer gradients once); no per-layer `p[l]` select,
    whose backward would write a zero [L, ...] tensor per layer."""
    ins, _ = _stack_inputs(16)
    remat_flag(remat)
    names = ["X"] + LEAVES
    leaves = {n: torch.from_numpy(ins[n]).requires_grad_() for n in names}
    with torch.enable_grad():
        out = PT._transformer_stack(None, {n: [leaves[n]] for n in names},
                                    ATTRS)["Out"][0]
    nodes = _grad_graph_nodes(out)
    kinds = [type(fn).__name__ for fn in nodes]
    assert kinds.count("UnbindBackward0") == len(LEAVES)
    stacked = {tuple(v.shape) for n, v in ins.items() if n != "X"}
    selects = [tuple(fn._saved_self_sym_sizes) for fn in nodes
               if type(fn).__name__ == "SelectBackward0"]
    assert not stacked & set(selects), selects
    if remat:
        assert "CheckpointFunctionBackward" not in kinds  # non-reentrant


def test_remat_flag_reads_the_reference_environment_spelling(monkeypatch):
    prev = flags.get("remat")
    try:
        flags.reset()
        assert flags.get("remat") is False
        flags.reset()
        monkeypatch.setenv("PADDLE_TPU_REMAT", "1")
        assert flags.get("remat") is True
    finally:
        flags.reset()
        monkeypatch.delenv("PADDLE_TPU_REMAT", raising=False)
        flags.set_flag("remat", prev)


def test_stack_refuses_a_hidden_size_the_heads_do_not_divide():
    ins, _ = _stack_inputs(16)
    t = {n: [torch.from_numpy(v)] for n, v in ins.items()}
    with pytest.raises(ValueError, match="not divisible by num_heads=3"):
        PT._transformer_stack(None, t, dict(ATTRS, num_heads=3))


# -- the stacked GPT-2 front end ----------------------------------------------

V, T_LM = 96, 16
LR, STEPS = 1e-3, 3


def _build(P, stacked=True, **kw):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        tok = P.layers.data("tok", [T_LM, 1], dtype="int64")
        nxt = P.layers.data("nxt", [T_LM, 1], dtype="int64")
        cost = P.models.transformer.transformer_lm_cost(
            tok, nxt, V, hid=H, num_layers=L, num_heads=N_HEADS,
            max_len=T_LM, stacked=stacked, **kw)
        _, params_grads = P.AdamOptimizer(LR).minimize(cost)
    return main, startup, cost, params_grads


def _feed(seed=0, T=T_LM, vocab=V):
    rng = np.random.RandomState(seed)
    return {"tok": rng.randint(0, vocab, (B, T, 1)).astype(np.int64),
            "nxt": rng.randint(0, vocab, (B, T, 1)).astype(np.int64)}


@pytest.mark.parametrize("kw", [{}, {"pp_axis": "pp",
                                     "num_microbatches": 2,
                                     "pp_schedule": "1f1b"}])
def test_both_packages_build_the_same_stacked_program_text(kw):
    jmain, jstart, _, _ = _build(jpt, **kw)
    pmain, pstart, _, _ = _build(pt, **kw)
    assert pmain.to_dict() == jmain.to_dict()
    assert pstart.to_dict() == jstart.to_dict()
    ops = [op for op in pmain.global_block().ops
           if op.type == "transformer_stack"]
    assert len(ops) == 1 and "transformer_stack_grad" in {
        op.type for op in pmain.global_block().ops}
    assert ops[0].attrs["pp_axis"] == kw.get("pp_axis", "")


def test_stacked_shapes_infer_on_meta_tensors():
    main, _, cost, _ = _build(pt)
    block = main.global_block()
    stack = next(op for op in block.ops if op.type == "transformer_stack")
    assert block.var(stack.output("Out")[0]).shape == (-1, T_LM, H)
    assert cost.shape == (1,)


def _jax_init(jstart):
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    init = {k: np.array(jscope.get(k)) for k in jscope.keys()
            if not k.startswith("__")}
    return jexe, jscope, init


def _key_bias_mask(n_cols):
    """The key columns of the head-major [n, (q, k, v), D] qkv bias."""
    D = H // N_HEADS
    return (np.arange(n_cols) // D) % 3 == 1


@pytest.mark.parametrize("remat", [False, True])
def test_stacked_gpt2_trains_like_the_jax_package(reference_kernels_forced,
                                                   remat_flag, remat):
    """Three Adam steps of the stacked 2-layer GPT-2 in both packages
    from one initialisation, at test_torch_training.py's tolerances:
    loss within 1e-5, step-1 gradients within 1e-5 of their largest
    element, parameters after step 3 within 2e-5, and the key biases
    (whose true gradient is zero, so Adam steps rounding noise) within
    2 * lr * steps."""
    jmain, jstart, jcost, jpg = _build(jpt)
    pmain, _, pcost, ppg = _build(pt)
    gnames = [g.name for _, g in jpg]
    assert gnames == [g.name for _, g in ppg]
    jexe, jscope, init = _jax_init(jstart)
    pscope = scope_from_numpy(init, "cpu")
    pexe = pt.Executor(pt.CPUPlace())
    remat_flag(remat)
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
        diff = np.abs(final[name] - np.asarray(jscope.get(name)))
        if name == "stack.Bqkv":
            keys = _key_bias_mask(diff.shape[-1])
            assert diff[:, keys].max() <= 2 * LR * STEPS, name
            diff = diff[:, ~keys]
        assert diff.max() <= 2e-5, (name, float(diff.max()))


# the amp slice: test_torch_amp.py's GPT-2 size (D 64), stacked
V_AMP, T_AMP, H_AMP = 512, 64, 128


def _amp_build(P, A):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        tok = P.layers.data("tok", [T_AMP, 1], dtype="int64")
        nxt = P.layers.data("nxt", [T_AMP, 1], dtype="int64")
        cost = P.models.transformer.transformer_lm_cost(
            tok, nxt, V_AMP, hid=H_AMP, num_layers=L, num_heads=N_HEADS,
            max_len=T_AMP, stacked=True)
        _, params_grads = P.AdamOptimizer(LR).minimize(cost)
    A.enable(main)
    return main, startup, cost, params_grads


@pytest.fixture
def amp_both(reference_kernels_forced, remat_flag):
    jmain, jstart, jcost, jpg = _amp_build(jpt, jamp)
    pmain, _, pcost, ppg = _amp_build(pt, amp)
    assert pmain.to_dict() == jmain.to_dict()
    jexe, jscope, init = _jax_init(jstart)
    remat_flag(True)
    yield dict(jmain=jmain, jexe=jexe, jscope=jscope, jcost=jcost, jpg=jpg,
               pmain=pmain, pexe=pt.Executor(pt.CPUPlace()),
               pscope=scope_from_numpy(init, "cpu"), pcost=pcost, ppg=ppg,
               feed=_feed(0, T_AMP, V_AMP))


def test_every_var_of_a_stacked_amp_step_has_the_reference_dtype(amp_both):
    """One amp step (remat on) with every computed var fetched: the
    stack's output and its input gradient are the JAX package's dtypes
    (bf16 residual stream out of the stack, f32 gradients of the f32
    inputs)."""
    b = amp_both
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
    stack = next(op for op in block.ops if op.type == "transformer_stack")
    assert want[stack.output("Out")[0]] == "bfloat16"
    for _, g in b["ppg"]:
        assert want[g.name] == "float32", g.name


def test_stacked_gpt2_trains_under_amp_like_the_jax_package(amp_both):
    """Three Adam steps under bf16 amp with remat on, at
    test_torch_amp.py's tolerances: each loss within 2e-3 relative, the
    step-1 gradients within 3e-2 of their largest element, every
    gradient and the master weights and moments f32."""
    b = amp_both
    gnames = [g.name for _, g in b["jpg"]]
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
    floats = [t for t in b["pscope"].vars.values()
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)


def test_the_port_loss_falls_with_its_own_startup(remat_flag):
    """The stacked model from the port's own startup (generator-seeded
    initialisers) and Adam, remat on: the loss on a fixed batch falls."""
    main, startup, cost, _ = _build(pt)
    remat_flag(True)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = _feed(1)
    losses = [float(exe.run(main, feed=feed, fetch_list=[cost],
                            scope=scope)[0][0]) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0] - 0.1

