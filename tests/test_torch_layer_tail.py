"""The layer functions, `nets.glu` / `nets.scaled_dot_product_attention`,
the FLOP tally of the corpus's product ops, the new parameters' trip
through `weights` and the op registry, in the port against the JAX
package, on the CPU.

- Each of the 31 layer functions the port lacked (and `Print`) builds a
  Program whose dict (op types, slots, attrs, var shapes and dtypes)
  equals the JAX package's.
- `glu` and `scaled_dot_product_attention` build the reference's
  Programs and give its outputs on the same feed (1e-5). The
  reference's `layers.split` calls its own `range` layer where it means
  the builtin and raises (ROADMAP C34): the reference side runs with
  that module's `range` answering a one-argument call as the builtin.
- `program_flops` equals the reference auditor's tally on a tiny
  program with each product op, forward and with its gradients.
- `scope_from_numpy` / `scope_to_numpy` carry prelu's Alpha, NCE's and
  hsigmoid's W / Bias and bilinear_tensor_product's Weight both ways.
- The port registers every op of the reference's, with the same
  differentiable and stateful marks.
"""

import builtins

import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu.layers import tensor as jtensor
from paddle_tpu.monitor import introspect as jintrospect
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch.monitor import introspect
from paddle_tpu_torch.ops import registry as preg
from paddle_tpu_torch.weights import scope_from_numpy, scope_to_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def reference_split(monkeypatch):
    """The reference's layers.split with its `range(num)` meaning the
    builtin (ROADMAP C34); its range layer otherwise unchanged."""
    layer = jtensor.range

    def range_(*args, **kwargs):
        if len(args) == 1 and not kwargs:
            return builtins.range(args[0])
        return layer(*args, **kwargs)

    monkeypatch.setattr(jtensor, "range", range_)


def _inputs(P):
    L = P.layers
    return {
        "x": L.data("x", [6], dtype="float32"),
        "y": L.data("y", [6], dtype="float32"),
        "ids": L.data("ids", [1], dtype="int64"),
        "idx": L.data("idx", [1], dtype="int32"),
        "upd": L.data("upd", [6], dtype="float32"),
        "img": L.data("img", [3, 8, 8], dtype="float32"),
    }


LAYERS = {
    "sums": lambda L, v: L.sums([v["x"], v["y"]]),
    "clip": lambda L, v: L.clip(v["x"], -0.5, 0.5),
    "abs": lambda L, v: L.abs(v["x"]),
    "ceil": lambda L, v: L.ceil(v["x"]),
    "cos": lambda L, v: L.cos(v["x"]),
    "log": lambda L, v: L.log(v["x"]),
    "reciprocal": lambda L, v: L.reciprocal(v["x"]),
    "round": lambda L, v: L.round(v["x"]),
    "rsqrt": lambda L, v: L.rsqrt(v["x"]),
    "sin": lambda L, v: L.sin(v["x"]),
    "reduce_mean": lambda L, v: L.reduce_mean(v["x"], dim=1),
    "reduce_min": lambda L, v: L.reduce_min(v["x"], dim=[0, 1],
                                            keep_dim=True),
    "reduce_prod": lambda L, v: L.reduce_prod(v["x"]),
    "elementwise_pow": lambda L, v: L.elementwise_pow(v["x"], v["y"]),
    "split": lambda L, v: L.split(v["x"], 2, dim=1),
    "split_sections": lambda L, v: L.split(v["x"], [1, 2, 3], dim=-1),
    "cumsum": lambda L, v: L.cumsum(v["x"], axis=1, exclusive=True),
    "gaussian_random": lambda L, v: L.gaussian_random([3, 4], std=0.5),
    "create_tensor": lambda L, v: L.create_tensor("float32", name="t"),
    "ones": lambda L, v: L.ones([2, 3]),
    "zeros": lambda L, v: L.zeros([4], dtype="int64"),
    "one_hot": lambda L, v: L.one_hot(v["ids"], 10),
    "gather": lambda L, v: L.gather(v["x"], v["idx"]),
    "scatter": lambda L, v: L.scatter(v["x"], v["idx"], v["upd"]),
    "stack": lambda L, v: L.stack([v["x"], v["y"]], axis=1),
    "expand": lambda L, v: L.expand(v["x"], [2, 1]),
    "range": lambda L, v: L.range(0, 10, 2),
    "multiplex": lambda L, v: L.multiplex([v["x"], v["y"]], v["ids"]),
    "isfinite": lambda L, v: L.isfinite(v["x"]),
    "im2sequence": lambda L, v: L.im2sequence(v["img"], filter_size=2,
                                              stride=2),
    "nce": lambda L, v: L.nce(v["x"], v["ids"], 20, num_neg_samples=5),
    "hsigmoid": lambda L, v: L.hsigmoid(v["x"], v["ids"], 10),
    "Print": lambda L, v: L.Print(v["x"], message="m", summarize=3),
}


@pytest.mark.usefixtures("reference_split")
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_the_reference_program(name):
    progs = {}
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            LAYERS[name](P.layers, _inputs(P))
        progs[P] = (main.to_dict(), startup.to_dict())
    assert progs[pt] == progs[jpt]


NETS = {
    "glu": (lambda P, v: P.nets.glu(v["a"], dim=-1),
            {"a": [8]}),
    "scaled_dot_product_attention": (
        lambda P, v: P.nets.scaled_dot_product_attention(v["q"], v["k"],
                                                         v["v"]),
        {"q": [5, 8], "k": [7, 8], "v": [7, 4]}),
}


@pytest.mark.usefixtures("reference_split")
@pytest.mark.parametrize("name", sorted(NETS))
def test_nets_build_and_run_as_the_reference(name):
    build, shapes = NETS[name]
    rs = np.random.RandomState(3)
    feed = {k: rs.uniform(-1, 1, [3] + s).astype(np.float32)
            for k, s in shapes.items()}
    progs, outs = {}, {}
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            v = {k: P.layers.data(k, s, dtype="float32")
                 for k, s in shapes.items()}
            out = build(P, v)
        progs[P] = main.to_dict()
        outs[P], = P.Executor(P.CPUPlace()).run(main, feed=feed,
                                                fetch_list=[out])
    assert progs[pt] == progs[jpt]
    assert outs[pt].shape == outs[jpt].shape
    np.testing.assert_allclose(outs[pt], outs[jpt], rtol=0, atol=1e-5)


# (op, inputs {slot: (shape, dtype, "data" | "param")}, attrs, out slot)
FLOP_CASES = {
    "conv3d": ({"Input": ((2, 4, 5, 6, 7), "float32", "param"),
                "Filter": ((4, 2, 2, 3, 2), "float32", "param")},
               {"strides": [1, 2, 1], "paddings": [1, 0, 1], "groups": 2,
                "dilations": [2, 1, 1]}, "Output"),
    "conv3d_transpose": ({"Input": ((2, 3, 3, 4, 3), "float32", "param"),
                          "Filter": ((3, 4, 2, 3, 2), "float32", "param")},
                         {"strides": [2, 1, 2], "paddings": [0, 1, 0],
                          "dilations": [1, 2, 1]}, "Output"),
    "dynamic_conv2d": ({"X": ((2, 3, 6, 5), "float32", "param"),
                        "Filter": ((2, 4 * 3 * 3 * 2), "float32", "param")},
                       {"num_filters": 4, "num_channels": 3, "kh": 3,
                        "kw": 2, "sh": 2, "sw": 1, "ph": 1, "pw": 0}, "Out"),
    "bilinear_tensor_product": ({"X": ((4, 3), "float32", "data"),
                                 "Y": ((4, 5), "float32", "data"),
                                 "Weight": ((6, 3, 5), "float32", "param")},
                                {}, "Out"),
    "conv_shift": ({"X": ((4, 7), "float32", "param"),
                    "Y": ((4, 3), "float32", "param")}, {}, "Out"),
    "nce": ({"Input": ((4, 6), "float32", "data"),
             "Label": ((4, 1), "int64", "data"),
             "Weight": ((20, 6), "float32", "param"),
             "Bias": ((20,), "float32", "param"),
             "CustomSamples": ((4, 5), "int64", "data")},
            {"num_total_classes": 20, "num_neg_samples": 5}, "Cost"),
    "hsigmoid": ({"X": ((4, 6), "float32", "data"),
                  "Label": ((4, 1), "int64", "data"),
                  "W": ((9, 6), "float32", "param"),
                  "Bias": ((9,), "float32", "param")},
                 {"num_classes": 10}, "Cost"),
}


def _flop_program(P, op, spec, attrs, out_slot, train):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    feed = {}
    rs = np.random.RandomState(0)
    with P.program_guard(main, startup):
        ins = {}
        for slot, (shape, dtype, kind) in spec.items():
            name = slot.lower()
            if kind == "data":
                v = P.layers.data(name, list(shape[1:]), dtype=dtype)
                feed[name] = (rs.randint(0, 4, shape) if "int" in dtype
                              else rs.randn(*shape)).astype(dtype)
            else:
                v = P.layers.create_parameter(list(shape), dtype, name=name)
            ins[slot] = [v.name]
        block = main.global_block()
        out = block.create_var(name="out", dtype="float32")
        block.append_op(op, ins, {out_slot: [out.name]}, dict(attrs))
        loss = P.layers.mean(out)
        if train:
            P.backward.append_backward(loss)
    return main, startup, feed, loss


@pytest.mark.parametrize("train", [False, True], ids=["forward", "train"])
@pytest.mark.parametrize("op", sorted(FLOP_CASES))
def test_program_flops_equal_the_reference_auditor(op, train):
    spec, attrs, out_slot = FLOP_CASES[op]
    jmain, jstart, feed, jloss = _flop_program(jpt, op, spec, attrs,
                                               out_slot, train)
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    ref = jintrospect.program_flops(jmain, feed=feed,
                                    fetch_list=[jloss.name], scope=jscope,
                                    executor=jexe)
    pmain, _, _, _ = _flop_program(pt, op, spec, attrs, out_slot, train)
    assert introspect.program_flops(pmain, feed) == ref > 0


def test_new_parameters_travel_through_scope_from_numpy_and_back():
    """prelu's Alpha, NCE's and hsigmoid's W / Bias and
    bilinear_tensor_product's Weight, initialised by the JAX package's
    startup, into a port Scope and out again unchanged, and the port's
    startup names the same parameters with the same shapes."""
    def build(P):
        P.framework.reset_default_programs()
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            x = P.layers.data("x", [6], dtype="float32")
            lab = P.layers.data("lab", [1], dtype="int64")
            P.layers.nce(x, lab, 20, num_neg_samples=5)
            P.layers.hsigmoid(x, lab, 10)
            alpha = P.layers.create_parameter([1], "float32",
                                              name="prelu_alpha")
            w = P.layers.create_parameter([3, 6, 6], "float32",
                                          name="btp_w")
            block = main.global_block()
            out = block.create_var(name="prelu_out", dtype="float32")
            block.append_op("prelu", {"X": [x.name], "Alpha": [alpha.name]},
                            {"Out": [out.name]}, {"mode": "all"})
            bout = block.create_var(name="btp_out", dtype="float32")
            block.append_op("bilinear_tensor_product",
                            {"X": [x.name], "Y": [x.name],
                             "Weight": [w.name]}, {"Out": [bout.name]}, {})
        return main, startup

    jmain, jstart = build(jpt)
    pmain, pstart = build(pt)
    jscope = jpt.Scope()
    jpt.Executor(jpt.CPUPlace()).run(jstart, scope=jscope)
    params = {p.name: np.asarray(jscope.get(p.name))
              for p in jmain.global_block().all_parameters()}
    assert len(params) == 6
    pscope = scope_from_numpy(params, "cpu")
    back = scope_to_numpy(pscope)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    pscope2 = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(pstart, scope=pscope2)
    fresh = scope_to_numpy(pscope2)
    assert {k: v.shape for k, v in fresh.items() if k in params} == \
        {k: v.shape for k, v in params.items()}
    rs = np.random.RandomState(1)
    feed = {"x": rs.randn(4, 6).astype(np.float32),
            "lab": rs.randint(0, 10, (4, 1)).astype(np.int64)}
    fetch = ["prelu_out", "btp_out"]
    jout = jpt.Executor(jpt.CPUPlace()).run(jmain, feed=feed,
                                            fetch_list=fetch, scope=jscope)
    pout = pt.Executor(pt.CPUPlace()).run(pmain, feed=feed,
                                          fetch_list=fetch, scope=pscope)
    for j, p in zip(jout, pout):
        np.testing.assert_allclose(p, j, rtol=0, atol=1e-5)


def test_registry_equals_the_references():
    assert set(preg._REGISTRY) == set(jreg._REGISTRY)
    assert len(preg._REGISTRY) == len(jreg._REGISTRY) == 228
    for t in jreg._REGISTRY:
        j, p = jreg.get_op(t), preg.get_op(t)
        assert (j.differentiable, j.stateful) == \
            (p.differentiable, p.stateful), t
