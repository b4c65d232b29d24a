"""The binary ProgramDesc format in the port (`proto_io`, the hand-written
codec of `proto/program_desc.py`) against the JAX package's, which
serializes through google.protobuf, on the CPU.

  * `program_to_bytes` of the same Program built in both packages is
    byte-equal: the tiny LM, a tiny ResNet, seq2seq, CTR and the tiny
    SSD training programs, a program with `while` / `ifelse` sub-blocks
    (BLOCK attrs), a quantized program, and a hypothesis sweep of attr
    values (ints at the int32 / int64 edges, floats that round to inf,
    0 or keep a sign, NaN, unicode strings, lists of each kind, empty
    lists). A value neither can encode raises in both.
  * A `__model__` saved by either package loads in the other and runs
    to the same outputs (1e-6).
  * Buffers built by hand parse alike in both packages: packed repeated
    fields, fields the schema does not know (as the real Fluid
    framework.proto writes them), every truncation of a valid buffer.
  * The twins of tests/test_proto_export.py's Program cases, and
    `serve --model_dir` of a pb directory answering as the json one.
"""

import http.client
import json
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import paddle_tpu as jpt
import paddle_tpu.models  # noqa: F401
from paddle_tpu import proto_io as jpio
from paddle_tpu import quant as jquant
from paddle_tpu.proto import desc_pb2 as jpb
import paddle_tpu_torch as pt
from paddle_tpu_torch import proto_io as ppio
from paddle_tpu_torch import quant as pquant
from paddle_tpu_torch.proto import program_desc as ppb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, H, L, HEADS, T = 64, 32, 2, 2, 8


@pytest.fixture(autouse=True)
def _fresh():
    for P in (jpt, pt):
        P.flags.reset()
        P.framework.reset_default_programs()
    yield
    for P in (jpt, pt):
        P.flags.reset()


def _both(build):
    """`build(P)` under fresh default programs in each package: {P:
    (main, startup, result)}."""
    out = {}
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            res = build(P)
        out[P] = (main, startup, res)
    return out


def _same_bytes(progs):
    for i in (0, 1):
        jb = jpio.program_to_bytes(progs[jpt][i])
        pb = ppio.program_to_bytes(progs[pt][i])
        assert pb == jb
        # the port reads the bytes back to a Program that writes them again
        assert ppio.program_to_bytes(ppio.program_from_bytes(jb)) == jb


# -- the programs -------------------------------------------------------------

def _lm(P):
    tok = P.layers.data("tok", [T, 1], dtype="int64")
    nxt = P.layers.data("nxt", [T, 1], dtype="int64")
    cost = P.models.transformer.transformer_lm_cost(
        tok, nxt, V, hid=H, num_layers=L, num_heads=HEADS, max_len=T)
    P.AdamOptimizer(1e-3).minimize(cost)
    return cost


def _resnet(P):
    img = P.layers.data("img", [3, 32, 32])
    label = P.layers.data("label", [1], dtype="int64")
    probs = P.models.resnet.resnet_cifar10(img, class_dim=10, depth=8)
    cost = P.layers.mean(P.layers.cross_entropy(probs, label))
    P.MomentumOptimizer(0.1, 0.9).minimize(cost)
    return cost


def _seq2seq(P):
    src, tgt, nxt = [P.layers.data(n, [1], dtype="int64", lod_level=1)
                     for n in ("src", "tgt", "nxt")]
    cost = P.models.seq2seq.seq2seq_attention_cost(src, tgt, nxt, V, V,
                                                   16, 16)
    P.AdamOptimizer(1e-3).minimize(cost)
    return cost


def _ctr(P):
    ids = P.layers.data("ids", [8], dtype="int64")
    dense = P.layers.data("dense", [4])
    label = P.layers.data("label", [1])
    logits = P.models.ctr.wide_deep(ids, 200, 8, emb_dim=8, hidden=(16,),
                                    dense_input=dense)
    cost = P.models.ctr.ctr_cost(logits, label)
    P.AdamOptimizer(0.01).minimize(cost)
    return cost


def _ssd(P):
    from test_torch_detection import tiny_ssd
    cost, _, _ = tiny_ssd(P)
    P.MomentumOptimizer(1e-3, 0.9).minimize(cost)
    return cost


def _control_flow(P):
    cf = P.layers.control_flow
    x = P.layers.data("x", [4])
    m = P.layers.data("m", [1], dtype="bool")
    ie = cf.IfElse(m)
    with ie.true_block():
        ie.output(ie.input(x) * 3.0)
    with ie.false_block():
        ie.output(ie.input(x) + 1.0)
    out, = ie()
    s = P.layers.fill_constant([1], "float32", 0.0)
    i = P.layers.fill_constant([1], "int64", 0)
    n = P.layers.fill_constant([1], "int64", 5)
    cond = P.layers.less_than(i, n)
    w = cf.While(cond)
    with w.block():
        P.layers.assign(s + P.layers.cast(i, "float32"), output=s)
        P.layers.increment(i)
        P.layers.less_than(i, n, cond=cond)
    return P.layers.mean(out) + s


@pytest.mark.parametrize("build", [_lm, _resnet, _seq2seq, _ctr, _ssd,
                                   _control_flow],
                         ids=["lm", "resnet", "seq2seq", "ctr", "ssd",
                              "while_ifelse"])
def test_program_bytes_equal_the_reference(build):
    progs = _both(build)
    assert progs[pt][0].to_dict() == progs[jpt][0].to_dict()
    _same_bytes(progs)


def test_block_attrs_are_blocks():
    progs = _both(_control_flow)
    desc = ppio.program_to_proto(progs[pt][0])
    kinds = {(op.type, a.name): a.type for b in desc.blocks for op in b.ops
             for a in op.attrs if a.name in ppio._BLOCK_ATTRS}
    assert set(kinds.values()) == {ppb.BLOCK} and len(desc.blocks) == 4
    assert {t for t, _ in kinds} == {"while", "ifelse"}


def _infer_lm(P):
    tok = P.layers.data("tokens", [T], dtype="int64")
    logits = P.models.transformer.transformer_lm(
        tok, V, hid=H, num_layers=L, num_heads=HEADS, max_len=T)
    return logits, P.layers.argmax(logits, axis=-1)


@pytest.fixture(scope="module")
def lm_dirs(tmp_path_factory):
    """The tiny LM's inference model saved by the JAX package, json and
    pb, from one initialisation; its logits on a fixed batch."""
    root = tmp_path_factory.mktemp("pb")
    for P in (jpt, pt):
        P.framework.reset_default_programs()
    progs = _both(_infer_lm)
    main, startup, (logits, ids) = progs[jpt]
    exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    exe.run(startup, scope=scope)
    tokens = np.random.RandomState(3).randint(0, V, (3, T)).astype(np.int64)
    want, = exe.run(main, feed={"tokens": tokens}, fetch_list=[logits],
                    scope=scope)
    dirs = {}
    for fmt in ("json", "pb"):
        dirs[fmt] = str(root / f"jax_{fmt}")
        jpt.io.save_inference_model(dirs[fmt], ["tokens"], [logits], exe,
                                    main_program=main, scope=scope,
                                    format=fmt)
    return dirs, tokens, np.asarray(want), progs


def test_quantized_program_bytes_equal_the_reference(lm_dirs, tmp_path):
    dirs, tokens, _, _ = lm_dirs
    jdir, pdir = str(tmp_path / "j8"), str(tmp_path / "p8")
    jquant.quantize_inference_model(dirs["json"], jdir)
    pquant.quantize_inference_model(dirs["json"], pdir,
                                    executor=pt.Executor(pt.CPUPlace()))
    jprog, _, _ = jpt.io.load_inference_model(
        jdir, jpt.Executor(jpt.CPUPlace()), scope=jpt.Scope())
    pprog, _, _ = pt.io.load_inference_model(
        pdir, pt.Executor(pt.CPUPlace()), scope=pt.Scope())
    assert any(op.type == "quant_mul" for op in pprog.global_block().ops)
    # the JAX package's DataType has no int8: it cannot write the program;
    # the port writes its int8 weights as DataType 21 (the extension)
    with pytest.raises(KeyError, match="int8"):
        jpio.program_to_bytes(jprog)
    int8 = [n for n, v in pprog.global_block().vars.items()
            if v.dtype == "int8"]
    assert int8 == [n for n, v in jprog.global_block().vars.items()
                    if v.dtype == "int8"] and len(int8) == 4 * L + 2
    back = ppio.program_from_bytes(ppio.program_to_bytes(pprog))
    assert {n: v.dtype for n, v in back.global_block().vars.items()} == \
        {n: v.dtype for n, v in pprog.global_block().vars.items()}
    # quant_weights' [slot, weight, scale] triples come back as triples
    triples = {i: op.attrs["quant_weights"]
               for i, op in enumerate(pprog.global_block().ops)
               if "quant_weights" in op.attrs}
    assert triples and all(len(t) == 3 for ts in triples.values()
                           for t in ts)
    assert {i: back.global_block().ops[i].attrs["quant_weights"]
            for i in triples} == triples
    # every other byte: with the int8 vars declared int32 in both, and
    # the triples flattened in the JAX package's program, as the port
    # writes them
    for n in int8:
        jprog.global_block().vars[n].dtype = "int32"
        pprog.global_block().vars[n].dtype = "int32"
    for i in triples:
        op = jprog.global_block().ops[i]
        op.attrs["quant_weights"] = [c for t in op.attrs["quant_weights"]
                                     for c in t]
    assert ppio.program_to_bytes(pprog) == jpio.program_to_bytes(jprog)


def _run_port(dirname, tokens):
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    prog, feeds, fetch = pt.io.load_inference_model(dirname, exe,
                                                    scope=scope)
    out, = exe.run(prog, feed={feeds[0]: tokens}, fetch_list=fetch,
                   scope=scope)
    return prog, np.asarray(out)


def test_a_jax_pb_model_runs_in_the_port(lm_dirs):
    dirs, tokens, want, _ = lm_dirs
    assert os.listdir(dirs["pb"]) and not os.path.exists(
        os.path.join(dirs["pb"], "__model__.json"))
    prog, got = _run_port(dirs["pb"], tokens)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    jprog, _ = _run_port(dirs["json"], tokens)
    # the pb program: the json one's ops, slots and vars; float attrs
    # rounded to float32
    assert [(o.type, o.inputs, o.outputs) for o in prog.global_block().ops] \
        == [(o.type, o.inputs, o.outputs) for o in jprog.global_block().ops]


def test_a_port_pb_model_runs_in_the_jax_package(lm_dirs, tmp_path):
    dirs, tokens, want, progs = lm_dirs
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    prog, feeds, fetch = pt.io.load_inference_model(dirs["json"], exe,
                                                    scope=scope)
    d = str(tmp_path / "port_pb")
    pt.io.save_inference_model(d, feeds, fetch, exe, main_program=prog,
                               scope=scope, format="pb")
    with open(os.path.join(d, "__model__"), "rb") as f:
        with open(os.path.join(dirs["pb"], "__model__"), "rb") as g:
            assert f.read() == g.read()
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jprog, jfeeds, jfetch = jpt.io.load_inference_model(d, jexe,
                                                        scope=jscope)
    got, = jexe.run(jprog, feed={jfeeds[0]: tokens}, fetch_list=jfetch,
                    scope=jscope)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-6)


# -- attr values --------------------------------------------------------------

def _attr_bytes(P, pio, attrs):
    prog = P.Program()
    prog.global_block().append_op("scale", {"X": ["x"]}, {"Out": ["y"]},
                                  dict(attrs), infer_shape=False)
    try:
        return pio.program_to_bytes(prog)
    except (TypeError, ValueError) as e:
        return type(e).__name__


INT32 = (-(1 << 31), (1 << 31) - 1)
INT64 = (-(1 << 63), (1 << 63) - 1)
EDGE_INTS = [INT32[0] - 1, INT32[0], -1, 0, 1, INT32[1], INT32[1] + 1,
             INT64[0], INT64[1]]
EDGE_FLOATS = [1e39, -1e39, 3.4028235677973366e38, 3.4028234663852886e38,
               1e-46, -1e-46, 1.4e-45, float("nan"), float("inf"),
               float("-inf"), -0.0, 0.0, 0.1, 1e-5]
ints = st.one_of(st.sampled_from(EDGE_INTS),
                 st.integers(INT64[0], INT64[1]))
floats = st.one_of(st.sampled_from(EDGE_FLOATS),
                   st.floats(allow_nan=True, allow_infinity=True))
text = st.text(max_size=8)
values = st.one_of(
    st.booleans(), ints, floats, text, st.just([]),
    st.lists(st.booleans(), max_size=4),
    st.lists(st.integers(INT32[0], INT32[1]), max_size=4),
    st.lists(ints, min_size=1, max_size=3),
    st.lists(floats, min_size=1, max_size=4),
    st.lists(text, min_size=1, max_size=3),
    st.lists(st.one_of(st.integers(0, 3), text), min_size=2, max_size=3))


@settings(max_examples=80, deadline=None, derandomize=True)
@given(st.dictionaries(st.text(min_size=1, max_size=6), values,
                       max_size=5))
def test_attr_sweep_bytes_equal_the_reference(attrs):
    assert _attr_bytes(pt, ppio, attrs) == _attr_bytes(jpt, jpio, attrs)


@pytest.mark.parametrize("value", EDGE_FLOATS + EDGE_INTS,
                         ids=[repr(v) for v in EDGE_FLOATS + EDGE_INTS])
def test_attr_edges_bytes_equal_the_reference(value):
    got = _attr_bytes(pt, ppio, {"v": value, "vs": [value] * 2})
    assert got == _attr_bytes(jpt, jpio, {"v": value, "vs": [value] * 2})


def test_wire_details():
    a = ppb.OpDesc.Attr(name="v", type=ppb.INT, i=-1)
    assert a.SerializeToString().hex() == "0a0176100018ffffffffffffffffff01"
    f = ppb.OpDesc.Attr(name="v", type=ppb.FLOAT)
    for value, want in ((1e39, "0000807f"), (3.4028235677973366e38,
                                             "0000807f"),
                        (1e-46, "00000000"), (float("nan"), "0000c07f"),
                        (-0.0, "00000080")):
        f.f = value
        assert f.SerializeToString().hex()[-8:] == want
    # field-number order, not declaration order; proto2 presence
    op = ppb.OpDesc(type="t", inputs=[ppb.OpDesc.Var(parameter="X")])
    assert op.SerializeToString() == jpb.OpDesc(
        type="t", inputs=[jpb.OpDesc.Var(parameter="X")]).SerializeToString()
    vd = ppb.VarDesc(name="v", type=ppb.VarType(type=1), persistable=False)
    assert vd.SerializeToString().endswith(b"\x18\x00")
    with pytest.raises(ppb.EncodeError, match="missing required"):
        ppb.OpDesc.Attr(name="x").SerializeToString()


# -- buffers built by hand ----------------------------------------------------

def _varint(v):
    v &= (1 << 64) - 1
    out = b""
    while v > 0x7F:
        out += bytes([(v & 0x7F) | 0x80])
        v >>= 7
    return out + bytes([v])


def _fld(number, wire, payload):
    if wire == 2:
        payload = _varint(len(payload)) + payload
    return _varint(number << 3 | wire) + payload


def _str(number, s):
    return _fld(number, 2, s.encode())


def _vint(number, v):
    return _fld(number, 0, _varint(v))


def _hand_program(packed, unknown):
    """A ProgramDesc of one block: var x [-1, 4] f32, var y, op scale
    with INTS / FLOATS / BOOLEANS attrs; `packed` writes the repeated
    scalars as packed runs, `unknown` adds fields of the real Fluid
    framework.proto (Version, forward_block_idx, need_check_feed, attr
    `longs`) and a fixed64 / fixed32 / group nobody knows."""
    def rep_ints(number, vals):
        if packed:
            return _fld(number, 2, b"".join(_varint(v) for v in vals))
        return b"".join(_vint(number, v) for v in vals)

    def rep_floats(number, vals):
        if packed:
            return _fld(number, 2, np.asarray(vals, "<f4").tobytes())
        return b"".join(_fld(number, 5, np.asarray(v, "<f4").tobytes())
                        for v in vals)

    def var(name, dims):
        tensor = _vint(1, 5) + rep_ints(2, dims)
        lod = _fld(1, 2, tensor) + _vint(2, 0)
        body = _str(1, name) + _fld(2, 2, _vint(1, 1) + _fld(3, 2, lod))
        if unknown:
            body += _vint(4, 1)                       # need_check_feed
        return _fld(3, 2, body)

    attrs = [_str(1, "ints") + _vint(2, 3) + rep_ints(6, [3, -2, 1 << 30]),
             _str(1, "floats") + _vint(2, 4) + rep_floats(7, [0.5, -2.25]),
             _str(1, "bools") + _vint(2, 7) + rep_ints(11, [1, 0, 1]),
             _str(1, "scale") + _vint(2, 1) + _fld(4, 5, np.asarray(
                 3.0, "<f4").tobytes())]
    if unknown:
        attrs[0] += rep_ints(15, [1 << 40]) + _fld(9, 1, b"\x01" * 8)
    op = (_fld(1, 2, _str(1, "X") + _str(2, "x"))
          + _fld(2, 2, _str(1, "Out") + _str(2, "y")) + _str(3, "scale")
          + b"".join(_fld(4, 2, a) for a in attrs))
    if unknown:
        op += _fld(6, 5, b"\0\0\0\0") + _varint(7 << 3 | 3) \
            + _vint(1, 9) + _varint(7 << 3 | 4)
    block = (_vint(1, 0) + _vint(2, -1) + var("x", [-1, 4])
             + var("y", [-1, 4]) + _fld(4, 2, op))
    if unknown:
        block += _vint(5, -1)                         # forward_block_idx
    prog = _fld(1, 2, block)
    if unknown:
        prog += _fld(2, 2, _vint(1, 0))               # Version
    return prog


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("unknown", [False, True],
                         ids=["schema", "unknown_fields"])
def test_hand_built_buffers_parse_alike(packed, unknown):
    buf = _hand_program(packed, unknown)
    jprog, pprog = jpio.program_from_bytes(buf), ppio.program_from_bytes(buf)
    assert pprog.to_dict() == jprog.to_dict()
    attrs = pprog.global_block().ops[0].attrs
    assert attrs["ints"] == [3, -2, 1 << 30] and attrs["bools"] == [
        True, False, True] and attrs["floats"] == [0.5, -2.25]
    # written back unpacked and without the unknown fields, as protobuf
    assert ppio.program_to_bytes(pprog) == jpio.program_to_bytes(jprog)
    exe = pt.Executor(pt.CPUPlace())
    out, = exe.run(pprog, feed={"x": np.ones((2, 4), np.float32)},
                   fetch_list=["y"], scope=pt.Scope())
    np.testing.assert_array_equal(out, np.full((2, 4), 3.0, np.float32))


def _jax_parse(buf):
    try:
        return jpio.program_from_bytes(buf).to_dict()
    except Exception as e:     # google.protobuf.message.DecodeError
        return type(e).__name__


def _port_parse(buf):
    try:
        return ppio.program_from_bytes(buf).to_dict()
    except ppb.DecodeError:
        return "DecodeError"


def test_every_truncation_parses_alike():
    buf = _hand_program(packed=False, unknown=True)
    for n in range(len(buf)):
        assert _port_parse(buf[:n]) == _jax_parse(buf[:n]), n


@pytest.mark.parametrize("bad", [b"\x0a\x05ab", b"\x0a", b"\x08\x80",
                                 b"\x00\x01", b"\x0c",
                                 b"\x0a\x02\x0a\xff",
                                 b"\x0a\x0b" + b"\xff" * 11],
                         ids=["short_len", "no_len", "short_varint",
                              "field_0", "stray_end_group", "inner_len",
                              "long_varint"])
def test_malformed_buffers_raise_and_keep_the_message(bad):
    assert _port_parse(bad) == "DecodeError" == _jax_parse(bad)
    desc = ppb.ProgramDesc(blocks=[ppb.BlockDesc(idx=0, parent_idx=-1)])
    with pytest.raises(ppb.DecodeError):
        desc.ParseFromString(bad)
    assert len(desc.blocks) == 1 and desc.blocks[0].parent_idx == -1


def test_invalid_utf8_is_malformed():
    with pytest.raises(ppb.DecodeError, match="UTF-8"):
        ppb.OpDesc.Attr.FromString(b"\x0a\x02\xff\x00\x10\x00")


# -- twins of tests/test_proto_export.py --------------------------------------

def _build_mlp():
    x = pt.layers.data(name="x", shape=[8], dtype="float32")
    y = pt.layers.data(name="y", shape=[1], dtype="float32")
    h = pt.layers.fc(x, 16, act="relu")
    pred = pt.layers.fc(h, 1)
    cost = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    pt.SGDOptimizer(learning_rate=0.1).minimize(cost)
    return pred, cost


def _init_scope(startup):
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    return {n: scope.get(n).clone() for n in scope.keys()
            if not n.startswith("__")}


def test_program_proto_roundtrip_runs_identically():
    pred, cost = _build_mlp()
    prog = pt.default_main_program()
    exe = pt.Executor(pt.CPUPlace())
    init = _init_scope(pt.default_startup_program())
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(4, 8).astype(np.float32),
            "y": rng.randn(4, 1).astype(np.float32)}

    def run_steps(program, fetch):
        scope = pt.Scope()
        for n, v in init.items():
            scope.set(n, v.clone())
        for _ in range(3):
            out, = exe.run(program, feed=feed, fetch_list=[fetch],
                           scope=scope)
        return out, {n: scope.get(n).numpy().copy() for n in init}

    want, w_want = run_steps(prog, pred)
    clone = ppio.program_from_bytes(ppio.program_to_bytes(prog))
    got, w_got = run_steps(clone, pred.name)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for n in w_want:
        np.testing.assert_allclose(w_got[n], w_want[n], rtol=1e-6,
                                   err_msg=n)


def test_proto_attr_fidelity():
    prog = pt.Program()
    blk = prog.global_block()
    blk.create_var(name="a", shape=(2, 3), dtype="float32")
    sub = prog.create_block()
    prog.rollback()
    attrs = {
        "b_true": True, "b_false": False, "i": 42, "l": 1 << 40,
        "f": 0.5, "s": "hello", "ints": [1, 2, 3],
        "floats": [0.25, 0.75], "strings": ["a", "b"],
        "bools": [True, False], "sub_block": sub.idx,
    }
    blk.append_op("while", {"X": ["a"]}, {"Out": ["a"]}, dict(attrs),
                  infer_shape=False)
    clone = ppio.program_from_bytes(ppio.program_to_bytes(prog))
    op = clone.global_block().ops[0]
    for k, v in attrs.items():
        got = op.attrs[k]
        if isinstance(v, list) and v and isinstance(v[0], float):
            np.testing.assert_allclose(got, v)
        elif isinstance(v, float):
            assert abs(got - v) < 1e-7
        else:
            assert got == v, (k, got, v)
    assert len(clone.blocks) == 2


def test_proto_var_metadata_fidelity():
    prog = pt.Program()
    blk = prog.global_block()
    blk.create_var(name="w", shape=(10, 20), dtype="bfloat16",
                   persistable=True)
    blk.create_var(name="seq", shape=(-1, -1, 4), dtype="float32",
                   lod_level=1)
    blk.create_var(name="seq@SEQLEN", shape=(-1,), dtype="int32")
    blk.create_var(name="scalar", shape=(), dtype="int64")
    clone = ppio.program_from_bytes(ppio.program_to_bytes(prog))
    w = clone.global_block().var("w")
    assert w.shape == (10, 20) and w.dtype == "bfloat16" and w.persistable
    seq = clone.global_block().var("seq")
    assert seq.shape == (-1, -1, 4) and seq.lod_level == 1
    assert seq.seq_len_var == "seq@SEQLEN"
    assert clone.global_block().var("scalar").shape is None


def test_reference_style_proto_parses():
    """A ProgramDesc built with the reference's generated classes (as its
    pybind would emit it) loads in the port as a runnable Program."""
    proto = jpb.ProgramDesc()
    bd = proto.blocks.add()
    bd.idx = 0
    bd.parent_idx = -1
    for name, dims, dt in (("x", [-1, 4], jpb.FP32),
                           ("scale_out", [-1, 4], jpb.FP32)):
        vd = bd.vars.add()
        vd.name = name
        vd.type.type = jpb.VarType.LOD_TENSOR
        vd.type.lod_tensor.tensor.data_type = dt
        vd.type.lod_tensor.tensor.dims.extend(dims)
    od = bd.ops.add()
    od.type = "scale"
    vi = od.inputs.add()
    vi.parameter = "X"
    vi.arguments.append("x")
    vo = od.outputs.add()
    vo.parameter = "Out"
    vo.arguments.append("scale_out")
    at = od.attrs.add()
    at.name, at.type, at.f = "scale", jpb.FLOAT, 3.0
    prog = ppio.program_from_bytes(proto.SerializeToString())
    exe = pt.Executor(pt.CPUPlace())
    out, = exe.run(prog, feed={"x": np.ones((2, 4), np.float32)},
                   fetch_list=["scale_out"], scope=pt.Scope())
    np.testing.assert_allclose(out, 3.0 * np.ones((2, 4)))


def test_save_load_inference_model_pb_format(tmp_path):
    pred, cost = _build_mlp()
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    d = str(tmp_path / "m")
    pt.io.save_inference_model(d, ["x"], [pred], exe, scope=scope,
                               format="pb")
    assert os.path.exists(os.path.join(d, "__model__"))
    scope2 = pt.Scope()
    prog2, feeds, fetches = pt.io.load_inference_model(d, exe, scope=scope2)
    x_np = np.random.RandomState(1).randn(4, 8).astype(np.float32)
    want, = exe.run(pt.default_main_program(),
                    feed={"x": x_np, "y": np.zeros((4, 1), np.float32)},
                    fetch_list=[pred], scope=scope)
    got, = exe.run(prog2, feed={"x": x_np}, fetch_list=fetches,
                   scope=scope2)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_save_other_format_removes_stale_model(tmp_path):
    pred, cost = _build_mlp()
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    d = str(tmp_path / "m")
    pt.io.save_inference_model(d, ["x"], [pred], exe, scope=scope,
                               format="json")
    pt.io.save_inference_model(d, ["x"], [pred], exe, scope=scope,
                               format="pb")
    assert not os.path.exists(os.path.join(d, "__model__.json"))
    _, feeds, _ = pt.io.load_inference_model(d, exe, scope=pt.Scope())
    assert feeds == ["x"]
    pt.io.save_inference_model(d, ["x"], [pred], exe, scope=scope,
                               format="json")
    assert not os.path.exists(os.path.join(d, "__model__"))
    with pytest.raises(ValueError, match="unknown inference-model format"):
        pt.io.save_inference_model(d, ["x"], [pred], exe, scope=scope,
                                   format="onnx")


def test_mixed_attr_list_rejected():
    prog = pt.Program()
    prog.global_block().append_op("scale", {}, {}, {"bad": [1, "x"]},
                                  infer_shape=False)
    with pytest.raises(TypeError, match="no\\s+ProgramDesc encoding"):
        ppio.program_to_bytes(prog)


def test_round4_ops_proto_roundtrip():
    """cross_entropy_over_beam (multi-entry input slots), the pruning
    mask's startup ops, ModelAverage's average_accumulates and kmax /
    seq_slice round-trip and run identically."""
    import paddle_tpu_torch.trainer_config_helpers as tch
    from paddle_tpu_torch.trainer_config_helpers import BeamInput

    s0 = pt.layers.data("s0", shape=[1], dtype="float32", lod_level=1,
                        stop_gradient=False)
    ids0 = tch.kmax_seq_score_layer(input=s0, beam_size=3)
    g0 = pt.layers.data("g0", shape=[1], dtype="int64")
    cost = tch.cross_entropy_over_beam(input=[BeamInput(
        candidate_scores=s0, selected_candidates=ids0, gold=g0)])
    x = pt.layers.data("x", shape=[8])
    y = pt.layers.data("y", shape=[1])
    pred = pt.layers.fc(
        input=x, size=1, bias_attr=False,
        param_attr=pt.ParamAttr(
            name="w", update_hooks=pt.HookAttribute(sparsity_ratio=0.5)))
    total = cost + pt.layers.mean(
        pt.layers.square_error_cost(input=pred, label=y))
    pt.SGDOptimizer(0.1).minimize(total)
    pt.ModelAverage(average_window_rate=1.0, min_average_window=10 ** 6,
                    max_average_window=10 ** 6)
    prog = pt.default_main_program()
    startup = pt.default_startup_program()
    rng = np.random.RandomState(0)
    feed = {"s0": rng.randn(2, 5, 1).astype(np.float32),
            "s0@SEQLEN": np.asarray([5, 4], np.int64),
            "g0": np.asarray([[1], [0]], np.int64),
            "x": rng.randn(2, 8).astype(np.float32),
            "y": rng.randn(2, 1).astype(np.float32)}

    def run(main, start):
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(start, scope=scope)
        outs = [np.asarray(exe.run(main, feed=feed, fetch_list=[total],
                                   scope=scope)[0]) for _ in range(3)]
        return outs, scope.get("w").numpy().copy()

    want, w_want = run(prog, startup)
    clone = ppio.program_from_bytes(ppio.program_to_bytes(prog))
    sclone = ppio.program_from_bytes(ppio.program_to_bytes(startup))
    got, w_got = run(clone, sclone)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(w_got, w_want, rtol=1e-6)
    assert (w_got == 0).sum() == 4


# -- serve --model_dir of a pb directory --------------------------------------

def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/infer", json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _serve_ids(model_dir, tokens):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve",
         f"--model_dir={model_dir}", "--device", "cpu", "--port", "0",
         "--max_batch_size", "4", "--buckets", "1,4",
         "--batch_timeout_ms", "1"],
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        port = None
        for line in proc.stderr:
            m = re.search(r"on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "serve never reported its port"
        code, body = _post(port, {"feeds": {"tokens": tokens.tolist()}})
        assert code == 200, body
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        return body["outputs"][0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()


def test_cli_serves_a_pb_model_dir_as_the_json_one(tmp_path):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        _, ids = _infer_lm(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    dirs = {}
    for fmt in ("json", "pb"):
        dirs[fmt] = str(tmp_path / fmt)
        pt.io.save_inference_model(dirs[fmt], ["tokens"], [ids], exe,
                                   main_program=main, scope=scope,
                                   format=fmt)
    tokens = np.random.RandomState(9).randint(0, V, (2, T)).astype(np.int64)
    jprog, feeds, fetch = pt.io.load_inference_model(
        dirs["json"], exe, scope=(jscope := pt.Scope()))
    want, = exe.run(jprog, feed={"tokens": tokens}, fetch_list=fetch,
                    scope=jscope)
    assert _serve_ids(dirs["pb"], tokens) == want.tolist()


def test_a_quantized_model_round_trips_through_pb(lm_dirs, tmp_path):
    """Phase 42 (a)'s route at the tiny size: the JAX package's pb
    directory quantized by the port (read through the auto-detect),
    written again as pb, served: the same bits as the json route."""
    dirs, tokens, _, _ = lm_dirs
    exe = pt.Executor(pt.CPUPlace())
    qjson, qpb = str(tmp_path / "q_json"), str(tmp_path / "q_pb")
    _, report = pquant.quantize_inference_model(dirs["pb"], qjson,
                                                executor=exe)
    assert report["quantized_ops"] == 4 * L + 2
    scope = pt.Scope()
    prog, feeds, fetch = pt.io.load_inference_model(qjson, exe, scope=scope)
    pt.io.save_inference_model(qpb, feeds, fetch, exe, main_program=prog,
                               scope=scope, format="pb")
    assert sorted(os.listdir(qpb)) == ["__model__", "__targets__.json",
                                       "params.npz"]
    pb_prog, got = _run_port(qpb, tokens)
    _, want = _run_port(qjson, tokens)
    np.testing.assert_array_equal(got, want)
    assert [op.type for op in pb_prog.global_block().ops] == \
        [op.type for op in prog.global_block().ops]
