"""The int8 matmul's weight layout and its plain versions, on the CPU.

On the card K6 reads its weight K-major, so the port stores every int8
matmul weight there column-major (`quant.place_int8_weights`: the view
`w.t().contiguous().t()`, same shape, dtype and values). These tests
hold what the CPU can reach of that against the JAX package: the
re-laid weights are the reference's quantized arrays bit for bit, a
model directory saved from them is the same file, the lowerings give
the same bits on either layout, and the plain versions the card's
kernels are held to (`quantize_activations_plain`, the rescaled
product) keep their parity with the reference. The re-layout itself
runs only on CUDA tensors; here it is driven on CPU tensors by
treating them as on the card (`quant._on_card`).
"""

import zipfile

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
from paddle_tpu_torch import quant as pquant
from paddle_tpu_torch.ops import quant_ops as pquant_ops
from paddle_tpu_torch.ops.registry import get_op as pget_op
from paddle_tpu_torch.weights import scope_from_numpy, scope_to_numpy

# a small GPT-2-like model whose products are 128-divisible
B, T, V, H, L, N_HEADS = 2, 16, 256, 128, 2, 2


@pytest.fixture(autouse=True)
def _flags_restored():
    yield
    jpt.flags.reset()
    pflags.reset()


def _t(a):
    return torch.from_numpy(np.array(a))


def _col(w):
    return w.t().contiguous().t()


def _build_lm(P):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        tok = P.layers.data("tokens", [T], dtype="int64")
        logits = P.models.transformer.transformer_lm(
            tok, V, hid=H, num_layers=L, num_heads=N_HEADS, max_len=T)
        P.layers.argmax(logits, axis=-1)
    return main, startup, logits


@pytest.fixture(scope="module")
def quantized():
    """The reference's and the port's quantize_program of one pruned
    logits program and one initialisation (the JAX startup's arrays)."""
    jmain, jstart, jlogits = _build_lm(jpt)
    pmain, _, plogits = _build_lm(pt)
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    init = {k: np.array(jscope.get(k)) for k in jscope.keys()
            if not k.startswith("__")}
    jpruned = jpt.io._prune_for_inference(jmain, ["tokens"], [jlogits.name])
    ppruned = pt.io._prune_for_inference(pmain, ["tokens"], [plogits.name])
    _, jqscope, _ = jquant.quantize_program(jpruned, jscope)
    pq, pqscope, _ = pquant.quantize_program(ppruned,
                                             scope_from_numpy(init, "cpu"))
    ref = {k: np.asarray(jqscope.get(k)) for k in jqscope.keys()
           if not k.startswith("__")}
    return dict(prog=pq, scope=pqscope, ref=ref, logits=plogits)


def _dot_weights(prog):
    return sorted({op.input("Y")[0] for op in prog.global_block().ops
                   if op.type in ("quant_mul", "quant_matmul")})


def _copy(scope):
    out = pt.Scope()
    for k in scope.keys():
        out.set(k, scope.get(k))
    return out


def test_place_int8_weights_is_a_no_op_on_the_cpu(quantized):
    """quantize_program already ran it; CPU tensors stay as they are,
    row-major and the reference's arrays."""
    scope = _copy(quantized["scope"])
    before = {k: scope.get(k) for k in scope.keys()}
    assert pquant.place_int8_weights(quantized["prog"], scope) == 0
    assert all(scope.get(k) is v for k, v in before.items())
    for name in _dot_weights(quantized["prog"]):
        w = scope.get(name)
        assert w.dtype == torch.int8 and w.is_contiguous()


def test_placed_weights_are_the_reference_arrays(quantized, monkeypatch):
    """Every int8 matmul weight re-laid column-major: the same shape,
    dtype, bytes and values (bitwise the reference's quantized array);
    scales, the int8 embedding and f32 tensors untouched; a second call
    moves nothing."""
    monkeypatch.setattr(pquant, "_on_card", lambda w: True)
    prog, scope = quantized["prog"], _copy(quantized["scope"])
    names = _dot_weights(prog)
    assert len(names) == 4 * L + 1
    before = {k: scope.get(k) for k in scope.keys()}
    assert pquant.place_int8_weights(prog, scope) == len(names)
    for k, v in before.items():
        w = scope.get(k)
        if k not in names:
            assert w is v, k
            continue
        K, N = v.shape
        assert w.shape == (K, N) and w.dtype == torch.int8
        assert w.stride() == (1, K) and pquant_ops.is_column_major(w)
        assert w.numel() * w.element_size() == v.numel() * v.element_size()
        np.testing.assert_array_equal(w.numpy(), quantized["ref"][k],
                                      err_msg=k)
    assert pquant.place_int8_weights(prog, scope) == 0


def _npz_members(path):
    """{member: its .npy bytes} of an npz (the zip's own timestamps
    aside)."""
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_column_major_scope_saves_the_same_params(quantized, tmp_path,
                                                  monkeypatch):
    """save_inference_model of a scope holding column-major int8 weights
    writes the same arrays, byte for byte, as of the row-major scope; the
    saved model loads back to the reference's arrays."""
    prog, logits = quantized["prog"], quantized["logits"]
    exe = pt.Executor(pt.CPUPlace())
    row = _copy(quantized["scope"])
    col = _copy(row)
    monkeypatch.setattr(pquant, "_on_card", lambda w: True)
    assert pquant.place_int8_weights(prog, col) == 4 * L + 1
    monkeypatch.undo()
    for name, scope in (("row", row), ("col", col)):
        pt.io.save_inference_model(str(tmp_path / name), ["tokens"],
                                   [logits], exe, main_program=prog,
                                   scope=scope)
    a = _npz_members(tmp_path / "row" / "params.npz")
    b = _npz_members(tmp_path / "col" / "params.npz")
    assert sorted(a) == sorted(b) and a == b
    scope = pt.Scope()
    loaded, _, _ = pt.io.load_inference_model(str(tmp_path / "col"), exe,
                                              scope=scope)
    arrays = scope_to_numpy(scope)
    for name in _dot_weights(loaded):
        np.testing.assert_array_equal(arrays[name], quantized["ref"][name])
    with np.load(tmp_path / "col" / "params.npz") as data:
        for name in _dot_weights(loaded):
            assert data[name].flags["C_CONTIGUOUS"]


@pytest.mark.parametrize("act", ["dynamic", "static"])
def test_quant_mul_bitwise_across_layouts(act):
    """quant_mul on the int8 core: the same bits with the weight
    row-major and column-major, and the reference's bits (its Pallas K6
    in interpret mode under jit, at 128-divisible shapes)."""
    rng = np.random.RandomState(21)
    q, s = jquant.quantize_array(rng.randn(256, 128).astype(np.float32),
                                 (0,))
    x = rng.randn(2, 64, 256).astype(np.float32)
    attrs = {"x_num_col_dims": 2, "y_num_col_dims": 1,
             "quant_kernel": pquant_ops.KERNEL_ID}
    ins = {"X": [x], "Y": [q], "YScale": [s]}
    if act == "static":
        ins["ActScale"] = [np.asarray([0.025], np.float32)]
    jpt.flags.set_flag("int8_matmul", "pallas")
    pflags.set_flag("int8_matmul", "pallas")
    jins = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}
    ref = np.asarray(jax.jit(lambda i: jget_op("quant_mul").lowering(
        None, i, attrs)["Out"][0])(jins))
    outs = {}
    for layout in ("row", "col"):
        pins = {k: [_t(v) for v in vs] for k, vs in ins.items()}
        if layout == "col":
            pins["Y"] = [_col(pins["Y"][0])]
        outs[layout] = pget_op("quant_mul").lowering(None, pins,
                                                     attrs)["Out"][0]
    assert outs["row"].shape == (2, 64, 128)
    np.testing.assert_array_equal(outs["col"].numpy(), outs["row"].numpy())
    np.testing.assert_array_equal(outs["col"].numpy(), ref)


@pytest.mark.parametrize("act", ["dynamic", "static"])
def test_quant_matmul_bitwise_across_layouts(act):
    rng = np.random.RandomState(22)
    q, s = jquant.quantize_array(rng.randn(128, 256).astype(np.float32),
                                 (0,))
    x = rng.randn(3, 128, 128).astype(np.float32)
    attrs = {"transpose_X": True, "alpha": 0.5}
    act_scale = (None if act == "dynamic"
                 else torch.tensor([0.04], dtype=torch.float32))
    pflags.set_flag("int8_matmul", "pallas")
    outs = []
    for w in (_t(q), _col(_t(q))):
        ins = {"X": [_t(x)], "Y": [w], "YScale": [_t(s)]}
        if act_scale is not None:
            ins["ActScale"] = [act_scale]
        outs.append(pget_op("quant_matmul").lowering(None, ins,
                                                     attrs)["Out"][0])
    assert outs[0].shape == (3, 128, 256)
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("act", ["dynamic", "static"])
def test_int8_matmul_rescaled_plain_is_rescale_of_the_plain_core(layout,
                                                                 act):
    """The CPU face of K6 with its epilogue: rescale(int8_matmul_plain(xq,
    wq), ax, col) bit for bit, and int8_matmul_i32 the plain core, on
    either layout and ragged shapes."""
    rng = np.random.RandomState(23)
    M, K, N = 37, 50, 19
    xf = torch.from_numpy(rng.randn(M, K).astype(np.float32))
    wq = torch.from_numpy(rng.randint(-127, 128, (K, N)).astype(np.int8))
    if layout == "col":
        wq = _col(wq)
    col = torch.from_numpy(rng.rand(N).astype(np.float32) * 1e-2)
    xq, ax = pquant_ops.quantize_activations(
        xf, None if act == "dynamic" else torch.tensor([0.03]))
    got = pquant_ops.int8_matmul_rescaled(xq, wq, ax, col)
    acc = pquant_ops.int8_matmul_plain(xq, wq)
    ref = pquant_ops.rescale(acc, ax, col.reshape(1, -1))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.equal(got, ref)
    assert torch.equal(pquant_ops.int8_matmul_i32(xq, wq), acc)
    assert torch.equal(acc.to(torch.int64),
                       xq.to(torch.int64) @ wq.to(torch.int64))
    meta = pquant_ops.int8_matmul_rescaled(xq.to("meta"), wq.to("meta"),
                                           ax.to("meta"), col.to("meta"))
    assert meta.shape == (M, N) and meta.dtype == torch.float32


def _tie_rows(K):
    """Rows whose x / ax lands on exact halves: the row max 127 * 2^e
    gives ax = fl(127 * 2^e * fl(1/127)) = 2^e, and (k + 1/2) * 2^e is
    exact, so round-half-to-even decides every element."""
    rows = []
    for e in (-3, 0, 2):
        r = ((np.arange(K) % 253) - 126 + 0.5) * 2.0 ** e
        r[0] = 127 * 2.0 ** e
        rows.append(r.astype(np.float32))
    return np.stack(rows)


@pytest.mark.parametrize("act", ["dynamic", "static"])
def test_quantize_activations_plain_bitwise_equals_reference(act):
    """quantize_activations_plain, the version the quantize kernel is held
    to, against the reference's quantize as its executor runs it (jit):
    through the reference's dot core with an identity weight and unit
    column scales its output is fl(xq * ax) per element, so equal
    outputs on rows with |xq| = 1 and 127 pin ax and xq. Rows: random
    ones of several magnitudes, a row of zeros (ax = tiny, xq = 0) and
    rows of exact halves (round half to even)."""
    K = 256
    rng = np.random.RandomState(24)
    x = np.concatenate([
        rng.randn(8, K).astype(np.float32) * np.float32(40.0),
        rng.randn(4, K).astype(np.float32) * np.float32(1e-3),
        np.zeros((1, K), np.float32), _tie_rows(K)])
    act_scale = None if act == "dynamic" else np.float32(0.0625)
    xq, ax = pquant_ops.quantize_activations_plain(
        _t(x), None if act_scale is None else torch.tensor(act_scale))
    assert xq.dtype == torch.int8 and ax.dtype == torch.float32
    assert ax.shape == ((x.shape[0], 1) if act_scale is None else (1, 1))
    if act_scale is None:
        assert float(ax[8 + 4, 0]) == torch.finfo(torch.float32).tiny
        assert not xq[8 + 4].any()
        ties = x[-3:] / ax[-3:].numpy()
        assert (np.abs(ties - np.round(ties)) == 0.5).sum() > K
    jpt.flags.set_flag("int8_matmul", "dot")
    eye = np.eye(K, dtype=np.int8)
    ones = np.ones(K, np.float32)
    ref = np.asarray(jax.jit(lambda x, a: jquant_ops.int8_matmul(
        x, jnp.asarray(eye), jnp.asarray(ones), act_scale=a))(
            jnp.asarray(x),
            None if act_scale is None else jnp.asarray(act_scale)))
    mine = (xq.to(torch.float32) * ax).numpy()
    np.testing.assert_array_equal(mine, ref)


def test_k6_operand_rules():
    """What the card's wrappers hand K6, checked on CPU tensors: a
    column-major weight is read as it is, a row-major one repacked
    (counted), K padded with zeros to a multiple of 16 (counted), any
    other layout refused."""
    w8 = pquant_ops.int8_matmul_i32
    rng = np.random.RandomState(25)
    xq = torch.from_numpy(rng.randint(-127, 128, (5, 32)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (32, 24)).astype(np.int8))
    before = (w8.repacks, w8.k_pads)
    x, wt, K = pquant_ops._k6_operands(w8, xq, _col(w))
    assert (w8.repacks, w8.k_pads) == before and K == 32
    assert x is xq and wt.shape == (24, 32) and wt.is_contiguous()
    assert torch.equal(wt, w.t())
    x, wt, K = pquant_ops._k6_operands(w8, xq, w)
    assert (w8.repacks, w8.k_pads) == (before[0] + 1, before[1])
    assert torch.equal(wt, w.t()) and wt.is_contiguous()
    xr, wr = xq[:, :27].contiguous(), _col(w[:27])
    x, wt, K = pquant_ops._k6_operands(w8, xr, wr)
    assert (w8.repacks, w8.k_pads) == (before[0] + 1, before[1] + 1)
    assert K == 32 and x.shape == (5, 32) and wt.shape == (24, 32)
    assert not x[:, 27:].any() and not wt[:, 27:].any()
    assert torch.equal(x[:, :27], xr) and torch.equal(wt[:, :27], wr.t())
    with pytest.raises(ValueError, match="row-major or column-major"):
        pquant_ops._k6_operands(w8, xq, w[:, ::2])
    with pytest.raises(ValueError, match="contiguous row-major xq"):
        pquant_ops._k6_operands(w8, xq[:, ::2], w[:16])
    with pytest.raises(TypeError, match="int8"):
        pquant_ops._k6_operands(w8, xq.float(), w)
    w8.repacks, w8.k_pads = before
