"""The port's post-training int8 quantization against the JAX package,
on the CPU.

The same numpy inputs go through `paddle_tpu` and `paddle_tpu_torch`:
the scale math, the int8 matmul core (the port's plain int8 x int8 ->
int32 version against the reference's Pallas kernel K6 in interpret
mode), the quantized lowerings, the program rewrite, and a model
directory that the reference quantized, served by the port.

The reference's Executor compiles the whole program with XLA, whose
algebraic simplifier turns the dynamic scale's `absmax / 127` into a
multiplication by fl32(1/127); the port computes that product. So the
reference core is held here under `jax.jit`, as its Executor runs it:
eager op-by-op dispatch divides, and differs by one ulp on some rows.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu.models.transformer  # noqa: F401
from paddle_tpu import quant as jquant
from paddle_tpu.ops import quant_ops as jquant_ops
from paddle_tpu.ops.registry import get_op as jget_op
import paddle_tpu_torch as pt
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch import monitor as pmonitor
from paddle_tpu_torch import quant as pquant
from paddle_tpu_torch.ops import quant_ops as pquant_ops
from paddle_tpu_torch.ops.registry import get_op as pget_op
from paddle_tpu_torch.weights import scope_from_numpy, scope_to_numpy

# the slice test's model: every product is 128-divisible
B, T, V, H, L, N_HEADS = 4, 32, 256, 128, 2, 2


@pytest.fixture(autouse=True)
def _flags_restored():
    yield
    jpt.flags.reset()
    pflags.reset()


def _set_core(mode):
    jpt.flags.set_flag("int8_matmul", mode)
    pflags.set_flag("int8_matmul", mode)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# scale math and the int8 core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [((64, 48), (0,)), ((300, 7), (1,)),
                                        ((3, 16, 8), (0, 1))])
def test_quantize_array_bitwise_equals_reference(shape, axes):
    rng = np.random.RandomState(sum(shape))
    w = (rng.randn(*shape) * 3.0).astype(np.float32)
    w[..., 0] = 0.0                     # an all-zero plane (scale 1.0)
    q, s = pquant.quantize_array(w, axes)
    jq, js = jquant.quantize_array(w, axes)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    # a tensor on the port's side gives the same arrays
    q2, s2 = pquant.quantize_array(_t(w), axes)
    np.testing.assert_array_equal(q2, jq)
    np.testing.assert_array_equal(s2, js)


def _core_case(M, K, N, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    x[0] *= 40.0                         # one wide row, one narrow
    x[-1] *= 1e-3
    q, s = jquant.quantize_array(rng.randn(K, N).astype(np.float32), (0,))
    return x, q, s.reshape(-1)


def _reference_core(x, q, col, act_scale):
    """The reference's int8_matmul compiled as its Executor compiles it
    (traced anew: the core is elected from the flag at trace time)."""
    return np.asarray(jax.jit(lambda x, q, c, a: jquant_ops.int8_matmul(
        x, q, c, act_scale=a))(x, q, col, act_scale))


CORE_SHAPES = [(256, 128, 256),       # tests/test_quantize.py's case
               (128, 768, 2304),      # GPT-2-small qkv
               (128, 3072, 768)]      # ffn down: K where f32 sums round


def _laid_out(q, layout):
    """The int8 weight as a tensor, row-major or column-major (the
    layout the port stores on the card: same shape and values, strides
    (1, K))."""
    w = _t(q)
    return w if layout == "row" else w.t().contiguous().t()


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("act", ["dynamic", "static"])
@pytest.mark.parametrize("M,K,N", CORE_SHAPES)
def test_int8_core_bitwise_equals_reference_pallas_kernel(M, K, N, act,
                                                          layout):
    """The port's plain int8 core against the reference's K6 (Pallas,
    interpret mode): equal int32 accumulators on equal int8 operands,
    equal activation quantization, equal f32 results; with the weight
    row-major and column-major."""
    x, q, col = _core_case(M, K, N, M + K + N)
    act_scale = np.float32(0.02) if act == "static" else None
    wq = _laid_out(q, layout)
    assert pquant_ops.is_column_major(wq) == (layout == "col")
    _set_core("pallas")
    # the int32 accumulator, kernel against plain, on the port's xq
    xq, ax = pquant_ops.quantize_activations(
        _t(x), None if act_scale is None else torch.tensor(act_scale))
    acc = pquant_ops.int8_matmul_plain(xq, wq)
    ref_acc = jquant_ops._pallas_int8_matmul(
        jnp.asarray(xq.numpy()), jnp.asarray(q), interpret=True)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref_acc))
    # the whole core: quantize, K6, rescale
    args = (jnp.asarray(x), jnp.asarray(q), jnp.asarray(col),
            None if act_scale is None else jnp.asarray(act_scale))
    got = pquant_ops.int8_matmul(
        _t(x), wq, _t(col),
        act_scale=None if act_scale is None else torch.tensor(act_scale))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _reference_core(*args))
    # the reference's int8 dot core is the same arithmetic
    jpt.flags.set_flag("int8_matmul", "dot")
    np.testing.assert_array_equal(got.numpy(), _reference_core(*args))


@pytest.mark.parametrize("M,K,N", CORE_SHAPES[:2])
def test_auto_core_on_cpu_matches_reference_auto(M, K, N):
    """auto on a CPU tensor: the f32 matmul against the dequantized
    weight, as the reference computes off the TPU; within 1e-6
    relative (two f32 GEMMs, other summation orders)."""
    x, q, col = _core_case(M, K, N, 7)
    _set_core("auto")
    assert pquant_ops.resolve_int8_core("auto", "cpu") == "dequant"
    got = pquant_ops.int8_matmul(_t(x), _t(q), _t(col)).numpy()
    ref = np.asarray(jquant_ops.int8_matmul(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(col)))
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_core_election_table():
    for mode in ("auto", "pallas", "dot"):
        assert pquant_ops.resolve_int8_core(mode, "cuda") == "int8"
    assert pquant_ops.resolve_int8_core("auto", "cpu") == "dequant"
    assert pquant_ops.resolve_int8_core("pallas", "cpu") == "int8"
    assert pquant_ops.resolve_int8_core("dot", "cpu") == "int8"
    # ragged shapes stay on the int8 core (no % 128 gate): exact
    rng = np.random.RandomState(4)
    xq = _t(rng.randint(-127, 128, (17, 33)).astype(np.int8))
    wq = _t(rng.randint(-127, 128, (33, 5)).astype(np.int8))
    np.testing.assert_array_equal(
        pquant_ops.int8_matmul_i32(xq, wq).numpy(),
        xq.numpy().astype(np.int64) @ wq.numpy().astype(np.int64))


# ---------------------------------------------------------------------------
# the lowerings
# ---------------------------------------------------------------------------

def _run_lowering(op_type, ins, attrs, jit):
    """(port output, reference output) of one lowering on numpy ins."""
    jins = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}
    pins = {k: [_t(v) for v in vs] for k, vs in ins.items()}
    fn = lambda i: jget_op(op_type).lowering(None, i, attrs)["Out"][0]
    ref = jax.jit(fn)(jins) if jit else fn(jins)
    got = pget_op(op_type).lowering(None, pins, attrs)["Out"][0]
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_quant_mul_lowering_matches_reference(mode):
    rng = np.random.RandomState(11)
    q, s = jquant.quantize_array(rng.randn(128, 256).astype(np.float32),
                                 (0,))
    ins = {"X": [rng.randn(2, 64, 128).astype(np.float32)], "Y": [q],
           "YScale": [s]}
    attrs = {"x_num_col_dims": 2, "y_num_col_dims": 1,
             "quant_kernel": pquant_ops.KERNEL_ID}
    _set_core(mode)
    got, ref = _run_lowering("quant_mul", ins, attrs, jit=mode != "auto")
    assert got.shape == (2, 64, 256)
    if mode == "auto":
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    else:
        np.testing.assert_array_equal(got, ref)
    # with a calibrated static scale
    ins["ActScale"] = [np.asarray([0.03], np.float32)]
    got, ref = _run_lowering("quant_mul", ins, attrs, jit=mode != "auto")
    if mode != "auto":
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("transpose_x,alpha", [(False, 1.0), (True, 0.5)])
def test_quant_matmul_lowering_matches_reference(transpose_x, alpha):
    rng = np.random.RandomState(12)
    q, s = jquant.quantize_array(rng.randn(128, 128).astype(np.float32),
                                 (0,))
    x = rng.randn(3, 128, 128).astype(np.float32)
    ins = {"X": [x], "Y": [q], "YScale": [s]}
    attrs = {"transpose_X": transpose_x, "alpha": alpha}
    _set_core("pallas")
    got, ref = _run_lowering("quant_matmul", ins, attrs, jit=True)
    assert got.shape == (3, 128, 128)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("padding_idx", [-1, 3])
def test_quant_lookup_table_lowering_matches_reference(padding_idx):
    rng = np.random.RandomState(13)
    q, s = jquant.quantize_array(rng.randn(50, 24).astype(np.float32), (1,))
    ids = rng.randint(0, 50, (4, 9, 1)).astype(np.int64)
    ids[0, :3] = 3
    ins = {"W": [q], "WScale": [s], "Ids": [ids]}
    attrs = {"padding_idx": padding_idx, "quant_w_dtype": "float32"}
    got, ref = _run_lowering("quant_lookup_table", ins, attrs, jit=False)
    assert got.shape == (4, 9, 24) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    if padding_idx >= 0:
        assert not got[0, :3].any()


def test_strip_quant_hands_the_f32_op_its_dequantized_weight():
    rng = np.random.RandomState(14)
    q, s = jquant.quantize_array(rng.randn(16, 8).astype(np.float32), (0,))
    ins = {"X": [_t(rng.randn(2, 16).astype(np.float32))], "Y": [_t(q)],
           "YScale": [_t(s)], "ActScale": [torch.ones(1)]}
    attrs = {"x_num_col_dims": 1, "quant_kernel": pquant_ops.KERNEL_ID,
             "quant_w_dtype": "float32"}
    clean, f32_attrs = pquant_ops._strip_quant(ins, attrs, ("Y",))
    assert sorted(clean) == ["X", "Y"]
    assert f32_attrs == {"x_num_col_dims": 1}
    np.testing.assert_array_equal(
        clean["Y"][0].numpy(),
        np.asarray(jquant_ops.dequantize(jnp.asarray(q), jnp.asarray(s),
                                         np.float32)))


# ---------------------------------------------------------------------------
# the program rewrite and model directories
# ---------------------------------------------------------------------------

def _build_lm(P):
    """The inference program of `P`: logits and their argmax."""
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        tok = P.layers.data("tokens", [T], dtype="int64")
        logits = P.models.transformer.transformer_lm(
            tok, V, hid=H, num_layers=L, num_heads=N_HEADS, max_len=T)
        ids = P.layers.argmax(logits, axis=-1)
    return main, startup, logits, ids


@pytest.fixture(scope="module")
def lm():
    """Both packages' programs and one initialisation (the JAX startup's
    arrays, carried into the port)."""
    jmain, jstart, jlogits, jids = _build_lm(jpt)
    pmain, _, plogits, pids = _build_lm(pt)
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    init = {k: np.array(jscope.get(k)) for k in jscope.keys()
            if not k.startswith("__")}
    tokens = np.random.RandomState(5).randint(0, V, (B, T)).astype(np.int64)
    return dict(jmain=jmain, jscope=jscope, jexe=jexe, jlogits=jlogits,
                jids=jids, pmain=pmain, plogits=plogits, pids=pids,
                init=init, tokens=tokens)


def test_the_logits_program_builds_alike_and_runs_alike(lm):
    assert lm["pmain"].to_dict() == lm["jmain"].to_dict()
    pscope = scope_from_numpy(lm["init"], "cpu")
    feed = {"tokens": lm["tokens"]}
    logits, ids = pt.Executor(pt.CPUPlace()).run(
        lm["pmain"], feed=feed, fetch_list=[lm["plogits"], lm["pids"]],
        scope=pscope)
    jlogits, jids = lm["jexe"].run(lm["jmain"], feed=feed,
                                   fetch_list=[lm["jlogits"], lm["jids"]],
                                   scope=lm["jscope"])
    assert logits.shape == (B, T, V) and ids.dtype == np.int64
    assert np.abs(logits - jlogits).max() <= 1e-5 * np.abs(jlogits).max()
    np.testing.assert_array_equal(ids, logits.argmax(-1))
    # the port's pruned clone equals the reference's
    mine = pt.io._prune_for_inference(lm["pmain"], ["tokens"],
                                      [lm["pids"].name])
    theirs = jpt.io._prune_for_inference(lm["jmain"], ["tokens"],
                                         [lm["jids"].name])
    assert mine.to_dict() == theirs.to_dict()


def test_quantize_program_equals_reference(lm):
    """The rewritten Program text, the int8 arrays and their scales, and
    the report are the reference's."""
    jpruned = jpt.io._prune_for_inference(lm["jmain"], ["tokens"],
                                          [lm["jlogits"].name])
    ppruned = pt.io._prune_for_inference(lm["pmain"], ["tokens"],
                                         [lm["plogits"].name])
    jq, jqscope, jrep = jquant.quantize_program(jpruned, lm["jscope"])
    pscope = scope_from_numpy(lm["init"], "cpu")
    pq, pqscope, prep = pquant.quantize_program(ppruned, pscope)
    assert pq.to_dict() == jq.to_dict()
    types = [op.type for op in pq.global_block().ops]
    assert types.count("quant_mul") == 4 * L + 1
    assert types.count("quant_lookup_table") == 1
    arrays = scope_to_numpy(pqscope)
    for name, arr in arrays.items():
        ref = np.asarray(jqscope.get(name))
        assert arr.dtype == ref.dtype, name
        np.testing.assert_array_equal(arr, ref, err_msg=name)
    assert sorted(arrays) == sorted(k for k in jqscope.keys()
                                    if not k.startswith("__"))
    skip = ("baked_platform",)
    assert ({k: v for k, v in prep.items() if k not in skip}
            == {k: v for k, v in jrep.items() if k not in skip})
    assert prep["quantized_ops"] == 4 * L + 2
    # the original program and scope are untouched
    assert all(not op.type.startswith("quant_")
               for op in ppruned.global_block().ops)
    assert pscope.get("lm_head.w").dtype == torch.float32


@pytest.fixture(scope="module")
def reference_dirs(lm, tmp_path_factory):
    """An f32 model dir the reference saved and its int8 twin from the
    reference's `quantize_inference_model`."""
    root = tmp_path_factory.mktemp("refq")
    src, out = str(root / "f32"), str(root / "int8")
    jpt.io.save_inference_model(src, ["tokens"], [lm["jlogits"]],
                                lm["jexe"], main_program=lm["jmain"],
                                scope=lm["jscope"])
    jquant.quantize_inference_model(src, out)
    return src, out


def _reference_run(dirname, mode):
    jpt.flags.set_flag("int8_matmul", mode)
    exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    prog, feeds, fetch_vars = jpt.io.load_inference_model(dirname, exe,
                                                          scope=scope)
    return prog, scope, exe, fetch_vars


def _port_load(dirname):
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    prog, feeds, fetch_vars = pt.io.load_inference_model(dirname, exe,
                                                         scope=scope)
    return prog, feeds, fetch_vars, exe, scope


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_reference_quantized_dir_serves_in_the_port(lm, reference_dirs,
                                                    mode):
    """The carry-across: a dir the reference quantized loads in the port
    unchanged. auto: within 1e-5 of max |logit|. The int8 cores: within
    2e-2 end to end, because an f32 rounding difference upstream (the
    port's attention and layer norm sum in other orders) can move a
    quantized activation by one int8 step, which moves that row's
    outputs by up to about max|x| * max|w_n|."""
    _, out = reference_dirs
    feed = {"tokens": lm["tokens"]}
    jprog, jscope, jexe, jfetch = _reference_run(out, mode)
    ref, = jexe.run(jprog, feed=feed, fetch_list=jfetch, scope=jscope)
    pflags.set_flag("int8_matmul", mode)
    prog, feeds, fetch, exe, scope = _port_load(out)
    assert feeds == ["tokens"] and scope.get("lm_head.w").dtype == torch.int8
    got, = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    band = 1e-5 if mode == "auto" else 2e-2
    assert np.abs(got - ref).max() <= band * np.abs(ref).max()


def test_int8_ops_bitwise_on_the_reference_activations(lm, reference_dirs):
    """Every quant_mul of the reference's run (its K6 in interpret mode):
    its input X through the port's lowering, with the same int8 weight
    and scales, gives its output Out bit for bit."""
    _, out = reference_dirs
    jprog, jscope, jexe, _ = _reference_run(out, "pallas")
    muls = [op for op in jprog.global_block().ops if op.type == "quant_mul"]
    assert len(muls) == 4 * L + 1
    names = [n for op in muls for n in (op.input("X")[0],
                                        op.output("Out")[0])]
    vals = jexe.run(jprog, feed={"tokens": lm["tokens"]}, fetch_list=names,
                    scope=jscope)
    pflags.set_flag("int8_matmul", "pallas")
    prog, _, _, _, scope = _port_load(out)
    pmuls = [op for op in prog.global_block().ops if op.type == "quant_mul"]
    for i, op in enumerate(pmuls):
        x, ref = vals[2 * i], vals[2 * i + 1]
        ins = {slot: [scope.get(n) for n in op.inputs[slot]]
               for slot in ("Y", "YScale")}
        ins["X"] = [_t(x)]
        got = pget_op("quant_mul").lowering(None, ins, op.attrs)["Out"][0]
        np.testing.assert_array_equal(got.numpy(), ref,
                                      err_msg=op.input("Y")[0])


def test_port_quantized_dir_matches_the_reference_dir(lm, reference_dirs,
                                                      tmp_path):
    """The port's quantize_inference_model on the reference's f32 dir
    writes the reference's program text and arrays."""
    src, out = reference_dirs
    _, rep = pquant.quantize_inference_model(
        src, str(tmp_path / "int8"), executor=pt.Executor(pt.CPUPlace()))
    assert rep["quantized_ops"] == 4 * L + 2 and rep["dequant_ops"] == 1
    for name in ("__model__.json", "params.npz"):
        assert os.path.exists(tmp_path / "int8" / name)
    with open(tmp_path / "int8" / "__model__.json") as f:
        mine = json.load(f)
    with open(os.path.join(out, "__model__.json")) as f:
        theirs = json.load(f)
    assert mine == theirs
    with np.load(tmp_path / "int8" / "params.npz") as a, \
            np.load(os.path.join(out, "params.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(tmp_path / "int8" / "__quant__.json") as f:
        assert json.load(f)["kernel"] == pquant_ops.KERNEL_ID


@pytest.mark.parametrize("doctoring", ["kernel", "op_type"])
def test_foreign_quant_kernel_falls_back_per_op(lm, reference_dirs,
                                                tmp_path, doctoring):
    """A quantized model from a newer quantizer (an unknown kernel id or
    quant op type) warns, dequantizes that one op back to f32 and
    serves; the other ops stay quantized."""
    src, out = reference_dirs
    doctored = tmp_path / "doctored"
    doctored.mkdir()
    with open(os.path.join(out, "__model__.json")) as f:
        payload = json.load(f)
    op = next(o for o in payload["program"]["blocks"][0]["ops"]
              if o["type"] == "quant_mul")
    if doctoring == "kernel":
        op["attrs"]["quant_kernel"] = "int9.wonder.scheme/99"
    else:
        op["type"] += "_v99"
    fell_back_weight = op["inputs"]["Y"][0]
    with open(doctored / "__model__.json", "w") as f:
        json.dump(payload, f)
    os.link(os.path.join(out, "params.npz"), doctored / "params.npz")
    pmonitor.reset()
    pmonitor.set_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            prog, _, fetch, exe, scope = _port_load(str(doctored))
        fallbacks = pmonitor.snapshot()["counters"].get(
            "quant.fallback_ops")
    finally:
        pmonitor.reset()
        pmonitor.set_enabled(False)
    assert any("cannot execute" in str(w.message) for w in caught)
    assert fallbacks == 1
    types = [o.type for o in prog.global_block().ops]
    assert types.count("mul") == 1 and types.count("quant_mul") == 4 * L
    assert scope.get(fell_back_weight).dtype == torch.float32
    fprog, _, ffetch, fexe, fscope = _port_load(src)
    feed = {"tokens": lm["tokens"]}
    a, = fexe.run(fprog, feed=feed, fetch_list=ffetch, scope=fscope)
    b, = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    assert np.abs(a - b).max() <= 0.05 * np.abs(a).max()


def test_quant_modules_import_no_jax_or_reference():
    """The AST import rule over this slice's modules, named one by one
    (the package-wide walk is in test_torch_lm_serving.py)."""
    import ast
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mods = ["quant", "io", "cli", "flags", "ops/quant_ops",
            "serving/engine", "serving/batching", "serving/http"]
    bad = []
    for m in mods:
        path = os.path.join(repo, "paddle_tpu_torch", m + ".py")
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(m, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, bad


# ---------------------------------------------------------------------------
# the stacked transformer, quantized
# ---------------------------------------------------------------------------

_QSTACK = ("Wqkv", "Wproj", "Wup", "Wdown")


def _stack_case(seed, T_=33, L_=2, H_=64, n=2):
    """X, the twelve stacked leaves, and the four matmul planes
    quantized per layer and output channel (axes (1,), as the
    quantizer's transformer_stack spec)."""
    from paddle_tpu.ops.transformer_ops import _LEAVES
    rng = np.random.RandomState(seed)
    F = 4 * H_
    shapes = {"Ln1G": (L_, H_), "Ln1B": (L_, H_), "Wqkv": (L_, H_, 3 * H_),
              "Bqkv": (L_, 3 * H_), "Wproj": (L_, H_, H_), "Bproj": (L_, H_),
              "Ln2G": (L_, H_), "Ln2B": (L_, H_), "Wup": (L_, H_, F),
              "Bup": (L_, F), "Wdown": (L_, F, H_), "Bdown": (L_, H_)}
    ins = {"X": [rng.randn(2, T_, H_).astype(np.float32)]}
    for name in _LEAVES:
        scale = 0.15 if name.startswith("W") else 0.05
        v = (rng.randn(*shapes[name]) * scale).astype(np.float32)
        if name in ("Ln1G", "Ln2G"):
            v += 1.0
        if name in _QSTACK:
            q, s = jquant.quantize_array(v, (1,))
            ins[name], ins[name + "Scale"] = [q], [s]
        else:
            ins[name] = [v]
    attrs = {"num_heads": n, "causal": True, "pp_axis": "", "tp_axis": "",
             "num_microbatches": 4, "pp_schedule": "gpipe",
             "quant_kernel": pquant_ops.KERNEL_ID}
    return ins, attrs


def test_quant_transformer_stack_lowering_matches_reference():
    """Each layer's dequantized planes are bitwise the reference's
    boundary dequantization; the output is within 1e-5 of its largest
    element (f32, the stack's sums in other orders)."""
    import types
    ins, attrs = _stack_case(21)
    for name in _QSTACK:
        q, s = ins[name][0], ins[name + "Scale"][0]
        ref = np.asarray(jquant_ops.dequantize(jnp.asarray(q),
                                               jnp.asarray(s), np.float32))
        for l in range(q.shape[0]):
            got = pquant_ops.dequantize(_t(q[l]), _t(s[l]), "float32")
            np.testing.assert_array_equal(got.numpy(), ref[l],
                                          err_msg=f"{name}[{l}]")
    jins = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}
    ref = np.asarray(jget_op("quant_transformer_stack").lowering(
        types.SimpleNamespace(mesh=None), jins, attrs)["Out"][0])
    pins = {k: [_t(v) for v in vs] for k, vs in ins.items()}
    with torch.no_grad():
        got = pget_op("quant_transformer_stack").lowering(
            None, pins, attrs)["Out"][0].numpy()
    assert got.shape == ref.shape == (2, 33, 64)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def _build_stacked_lm(P):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        tok = P.layers.data("tokens", [T], dtype="int64")
        logits = P.models.transformer.transformer_lm(
            tok, V, hid=H, num_layers=L, num_heads=N_HEADS, max_len=T,
            stacked=True)
        ids = P.layers.argmax(logits, axis=-1)
    return main, startup, logits, ids


def test_quantized_stacked_program_equals_reference_and_runs_alike():
    """A stacked transformer_lm quantized in both packages: the same
    Program text (quant_transformer_stack with four int8 planes, and
    quant_mul for the head), int8 arrays and scales bitwise, and logits
    within 1e-5 of their largest element on the CPU's dequant core."""
    jmain, jstart, jlogits, _ = _build_stacked_lm(jpt)
    pmain, _, plogits, _ = _build_stacked_lm(pt)
    assert pmain.to_dict() == jmain.to_dict()
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    init = {k: np.array(jscope.get(k)) for k in jscope.keys()
            if not k.startswith("__")}
    jpruned = jpt.io._prune_for_inference(jmain, ["tokens"],
                                          [jlogits.name])
    ppruned = pt.io._prune_for_inference(pmain, ["tokens"], [plogits.name])
    jq, jqscope, _ = jquant.quantize_program(jpruned, jscope)
    pq, pqscope, _ = pquant.quantize_program(
        ppruned, scope_from_numpy(init, "cpu"))
    assert pq.to_dict() == jq.to_dict()
    stack = next(op for op in pq.global_block().ops
                 if op.type == "quant_transformer_stack")
    assert sorted(s for s in stack.inputs if s.endswith("Scale")) == [
        "WdownScale", "WprojScale", "WqkvScale", "WupScale"]
    for name, arr in scope_to_numpy(pqscope).items():
        np.testing.assert_array_equal(arr, np.asarray(jqscope.get(name)),
                                      err_msg=name)
    tokens = np.random.RandomState(6).randint(0, V, (B, T)).astype(np.int64)
    got, = pt.Executor(pt.CPUPlace()).run(
        pq, feed={"tokens": tokens}, fetch_list=[plogits.name],
        scope=pqscope)
    ref, = jexe.run(jq, feed={"tokens": tokens}, fetch_list=[jlogits.name],
                    scope=jqscope)
    assert np.abs(got - np.asarray(ref)).max() <= \
        1e-5 * np.abs(np.asarray(ref)).max()
