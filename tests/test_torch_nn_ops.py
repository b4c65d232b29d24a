"""The port's nn lowerings (paddle_tpu_torch/ops/nn_ops.py) against the
JAX package's (paddle_tpu/ops/nn_ops.py) on the CPU.

Each case hands both lowerings the same seeded numpy inputs and compares
every output slot the reference returns, then the gradients of the
primary output with respect to the float inputs: `jax.vjp` against
`torch.autograd.grad` with the same seeded cotangent.

Tolerances: 1e-5 absolute on float32 forward values (tests/op_test.py's
default) and, on gradients, 1e-4 of the largest |reference| element of
each gradient (both packages sum the same terms in different orders).
The tie cases compare gradients exactly where the two packages must
pick the same rule: relu at 0 (1/2 to x), a clip at its bound (1/2),
max pooling over equal elements (all to the first in scan order).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt  # noqa: F401  (registers the reference's ops)
from paddle_tpu import flags as jflags
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops import registry as preg
from torch_port_helpers import one_torch_thread  # noqa: F401

FWD_ATOL = 1e-5
GRAD_REL = 1e-4

pytestmark = pytest.mark.usefixtures("one_torch_thread")


class _JCtx:
    is_test = False
    mesh = None
    amp_dtype = None

    def next_key(self):
        return jax.random.PRNGKey(0)


class _PCtx:
    is_test = False
    amp_dtype = None
    generator = None
    device = torch.device("cpu")


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "f" else a


def run_both(op, ins, attrs=None, out="Out", grad=(), seed=0,
             j_is_test=False, p_is_test=False):
    """Forward of both lowerings on the same inputs; gradients of output
    slot `out` w.r.t. the float input slots in `grad`. Returns
    (jax outputs, torch outputs, jax grads, torch grads)."""
    attrs = dict(attrs or {})
    ins = {k: [_f32(v) for v in vs] for k, vs in ins.items()}
    jctx, pctx = _JCtx(), _PCtx()
    jctx.is_test, pctx.is_test = j_is_test, p_is_test
    jfn = jreg.get_op(op).lowering
    pfn = preg.get_op(op).lowering

    jins = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}
    jout = jfn(jctx, jins, dict(attrs))
    pins = {k: [torch.from_numpy(np.array(v)) for v in vs]
            for k, vs in ins.items()}
    pout = pfn(pctx, pins, dict(attrs))
    if not grad:
        return jout, pout, None, None

    def jf(*vals):
        d = dict(jins)
        for s, v in zip(grad, vals):
            d[s] = [v]
        return jfn(jctx, d, dict(attrs))[out][0]

    y, vjp = jax.vjp(jf, *[jins[s][0] for s in grad])
    cot = np.random.RandomState(seed + 1).randn(*y.shape).astype(np.float32)
    jg = vjp(jnp.asarray(cot, y.dtype))
    leaves = {s: pins[s][0].clone().requires_grad_(True) for s in grad}
    d = dict(pins)
    for s in grad:
        d[s] = [leaves[s]]
    py = pfn(pctx, d, dict(attrs))[out][0]
    pg = torch.autograd.grad(py, [leaves[s] for s in grad],
                             torch.from_numpy(cot).to(py.dtype))
    return jout, pout, jg, pg


def check_outputs(jout, pout, atol=FWD_ATOL, skip=()):
    for slot, jvals in jout.items():
        if slot in skip:
            continue
        assert slot in pout, slot
        for jv, pv in zip(jvals, pout[slot]):
            jv = np.asarray(jv)
            pv = pv.detach().numpy()
            assert pv.shape == jv.shape, (slot, pv.shape, jv.shape)
            np.testing.assert_allclose(pv, jv, rtol=0, atol=atol,
                                       err_msg=slot)


def check_grads(jg, pg, rel=GRAD_REL):
    for j, p in zip(jg, pg):
        j = np.asarray(j)
        p = p.numpy()
        assert p.shape == j.shape
        tol = rel * max(float(np.abs(j).max()), 1e-30)
        np.testing.assert_allclose(p, j, rtol=0, atol=tol)


def rng_uniform(seed, shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


# -- the registry ----------------------------------------------------------

def test_every_reference_nn_op_is_registered():
    import paddle_tpu.ops.nn_ops as ref
    src = open(ref.__file__).read()
    names = set(re.findall(r'register_op\("(\w+)"', src))
    assert len(names) == 38
    extra = {"concat", "quant_conv2d", "quant_depthwise_conv2d"}
    missing = sorted(n for n in names | extra if not preg.has_op(n))
    assert not missing, missing
    for n in names:
        j, p = jreg.get_op(n), preg.get_op(n)
        assert (p.differentiable, p.stateful, p.test_aware) == \
            (j.differentiable, j.stateful, j.test_aware), n
    assert preg.get_op("batch_norm").test_aware
    assert preg.get_op("dropout").test_aware


# -- activations -----------------------------------------------------------

ACTS = [("relu", {}), ("relu6", {"threshold": 4.0}), ("sigmoid", {}),
        ("logsigmoid", {}), ("tanh", {}), ("gelu", {}),
        ("gelu", {"approximate": False}), ("leaky_relu", {"alpha": 0.1}),
        ("elu", {"alpha": 0.7}), ("softplus", {}), ("softsign", {}),
        ("softshrink", {"lambda": 0.4}), ("hard_sigmoid", {}),
        ("swish", {"beta": 1.3}), ("stanh", {}),
        ("thresholded_relu", {"threshold": 0.5}),
        ("brelu", {"t_min": -1.0, "t_max": 2.0}), ("softmax", {}),
        ("log_softmax", {})]


@pytest.mark.parametrize("op,attrs", ACTS,
                         ids=[f"{o}-{i}" for i, (o, _) in enumerate(ACTS)])
def test_activation(op, attrs):
    x = rng_uniform(3, (4, 7), -3.0, 3.0)
    jout, pout, jg, pg = run_both(op, {"X": [x]}, attrs, grad=("X",))
    check_outputs(jout, pout)
    check_grads(jg, pg)


@pytest.mark.parametrize("op,attrs,x,slope", [
    ("relu", {}, [0.0, -0.0, 2.0], 1.0),
    ("relu6", {"threshold": 6.0}, [0.0, 6.0, 3.0], 1.0),
    ("brelu", {"t_min": -1.0, "t_max": 2.0}, [-1.0, 2.0, 0.5], 1.0),
    ("hard_sigmoid", {}, [-2.5, 2.5, 0.0], 0.2),
])
def test_activation_gradient_at_ties(op, attrs, x, slope):
    """jnp.maximum / jnp.clip give 1/2 at a tie; so must the port: the
    first two elements sit on a bound, the third inside."""
    x = np.array([x], np.float32)
    _, _, jg, pg = run_both(op, {"X": [x]}, attrs, grad=("X",))
    np.testing.assert_array_equal(pg[0].numpy(), np.asarray(jg[0]))
    cot = np.random.RandomState(1).randn(1, 3).astype(np.float32)
    np.testing.assert_allclose(pg[0].numpy()[0, :2],
                               0.5 * slope * cot[0, :2], rtol=1e-6)


# -- losses ----------------------------------------------------------------

def _probs(seed, n=6, c=5):
    logits = np.random.RandomState(seed).randn(n, c)
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


def _labels(seed, n=6, c=5):
    return np.random.RandomState(seed).randint(0, c, (n, 1)).astype(np.int64)


LOSSES = [
    ("cross_entropy", lambda: {"X": [_probs(1)], "Label": [_labels(2)]},
     {}, "Y", ("X",)),
    ("cross_entropy", lambda: {"X": [_probs(1)], "Label": [_probs(2)]},
     {"soft_label": True}, "Y", ("X", "Label")),
    ("softmax_with_cross_entropy",
     lambda: {"Logits": [rng_uniform(1, (6, 5), -3, 3)],
              "Label": [_labels(2)]}, {}, "Loss", ("Logits",)),
    ("softmax_with_cross_entropy",
     lambda: {"Logits": [rng_uniform(1, (6, 5), -3, 3)],
              "Label": [_probs(2)]}, {"soft_label": True}, "Loss",
     ("Logits", "Label")),
    ("sigmoid_cross_entropy_with_logits",
     lambda: {"X": [rng_uniform(1, (6, 5), -3, 3)],
              "Label": [rng_uniform(2, (6, 5), 0, 1)]}, {}, "Out",
     ("X", "Label")),
    ("smooth_l1_loss", lambda: {"X": [rng_uniform(1, (6, 5), -2, 2)],
                                "Y": [rng_uniform(2, (6, 5), -2, 2)]},
     {"sigma": 1.5}, "Out", ("X", "Y")),
    ("huber_loss", lambda: {"X": [rng_uniform(1, (6, 1), -2, 2)],
                            "Y": [rng_uniform(2, (6, 1), -2, 2)]},
     {"delta": 0.7}, "Out", ("X", "Y")),
    ("hinge_loss", lambda: {"Logits": [rng_uniform(1, (6, 1), -2, 2)],
                            "Labels": [(rng_uniform(2, (6, 1), 0, 1) > .5)
                                       .astype(np.float32)]},
     {}, "Loss", ("Logits",)),
    ("rank_loss", lambda: {"Label": [(rng_uniform(3, (6, 1), 0, 1) > .5)
                                     .astype(np.float32)],
                           "Left": [rng_uniform(1, (6, 1), -2, 2)],
                           "Right": [rng_uniform(2, (6, 1), -2, 2)]},
     {}, "Out", ("Left", "Right")),
    ("square_error_cost", lambda: {"X": [rng_uniform(1, (6, 3))],
                                   "Y": [rng_uniform(2, (6, 3))]},
     {}, "Out", ("X", "Y")),
]


@pytest.mark.parametrize("op,make,attrs,out,grad", LOSSES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LOSSES)])
def test_loss(op, make, attrs, out, grad):
    jout, pout, jg, pg = run_both(op, make(), attrs, out=out, grad=grad)
    check_outputs(jout, pout)
    check_grads(jg, pg)


def test_cross_entropy_at_the_clip_bounds():
    """Probabilities of exactly 1.0 and below 1e-8: the values and the
    gradients (1/2 at 1.0 from the clip's minimum, 0 below 1e-8) equal
    the reference's."""
    x = np.array([[1.0, 0.0, 0.0], [1e-9, 0.5, 0.5], [0.2, 0.3, 0.5]],
                 np.float32)
    label = np.array([[0], [0], [2]], np.int64)
    jout, pout, jg, pg = run_both("cross_entropy",
                                  {"X": [x], "Label": [label]}, out="Y",
                                  grad=("X",))
    check_outputs(jout, pout)
    np.testing.assert_allclose(pg[0].numpy(), np.asarray(jg[0]), rtol=1e-6)
    g = pg[0].numpy()
    assert g[1, 0] == 0.0
    assert g[0, 0] != 0.0


# -- conv ------------------------------------------------------------------

CONVS = [
    ("basic", "conv2d", (2, 3, 7, 7), (4, 3, 3, 3),
     {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1]}),
    ("stride_dilation", "conv2d", (1, 2, 9, 9), (3, 2, 3, 3),
     {"strides": [2, 2], "paddings": [2, 2], "dilations": [2, 2]}),
    ("groups", "conv2d", (2, 4, 5, 5), (6, 2, 3, 3),
     {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
      "groups": 2}),
    ("depthwise", "depthwise_conv2d", (2, 3, 5, 5), (3, 1, 3, 3),
     {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1]}),
    ("transpose", "conv2d_transpose", (2, 3, 5, 5), (3, 4, 3, 3),
     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]}),
    ("transpose_dilated", "conv2d_transpose", (1, 2, 4, 4), (2, 3, 3, 3),
     {"strides": [1, 1], "paddings": [0, 0], "dilations": [2, 2]}),
]


@pytest.mark.parametrize("name,op,xs,ws,attrs", CONVS,
                         ids=[c[0] for c in CONVS])
def test_conv(name, op, xs, ws, attrs):
    x = rng_uniform(17, xs)
    w = rng_uniform(18, ws, -0.5, 0.5)
    jout, pout, jg, pg = run_both(op, {"Input": [x], "Filter": [w]}, attrs,
                                  out="Output", grad=("Input", "Filter"))
    check_outputs(jout, pout)
    check_grads(jg, pg)


@pytest.fixture
def s2d_flag():
    pflags.reset()
    jflags.reset()
    yield
    pflags.reset()
    jflags.reset()


S2D_CASES = [
    ("resnet_stem", (2, 3, 224, 224), (8, 3, 7, 7), 2, 3),
    ("alexnet_stem", (2, 3, 227, 227), (8, 3, 11, 11), 4, 2),
    ("odd_size", (1, 3, 31, 37), (4, 3, 7, 7), 2, 3),
    ("k_eq_s", (1, 1, 16, 16), (4, 1, 2, 2), 2, 0),
    ("four_channels", (2, 4, 30, 30), (6, 4, 5, 5), 2, 2),
]


def _port_conv(x, w, stride, pad, s2d_on):
    """The port's conv2d lowering with the flag set; the output and the
    filter gradient of mean(out^2)."""
    pflags.set_flag("conv_s2d_stem", s2d_on)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = preg.get_op("conv2d").lowering(
        _PCtx(), {"Input": [torch.from_numpy(x)], "Filter": [wt]},
        {"strides": [stride, stride], "paddings": [pad, pad],
         "dilations": [1, 1], "groups": 1})["Output"][0]
    g, = torch.autograd.grad(out.square().mean(), wt)
    return out.detach().numpy(), g.numpy()


@pytest.mark.parametrize("name,xs,ws,stride,pad", S2D_CASES,
                         ids=[c[0] for c in S2D_CASES])
def test_s2d_matches_direct(s2d_flag, name, xs, ws, stride, pad):
    """The twin of tests/test_conv_s2d.py: the rewrite is the direct
    conv's math, values and filter gradient, with that file's
    tolerances (the f32 sums run in another order)."""
    rng = np.random.RandomState(0)
    x = rng.randn(*xs).astype(np.float32)
    w = rng.randn(*ws).astype(np.float32)
    assert nn_ops._s2d_eligible(torch.from_numpy(x), torch.from_numpy(w),
                                (stride, stride), (pad, pad), (1, 1), 1)
    out_ref, g_ref = _port_conv(x, w, stride, pad, False)
    out_s2d, g_s2d = _port_conv(x, w, stride, pad, True)
    assert out_ref.shape == out_s2d.shape, name
    scale = float(np.abs(out_ref).max())
    np.testing.assert_allclose(out_s2d, out_ref, rtol=1e-4,
                               atol=1e-5 * max(scale, 1.0))
    gscale = float(np.abs(g_ref).max())
    np.testing.assert_allclose(g_s2d, g_ref, rtol=1e-3,
                               atol=1e-5 * max(gscale, 1.0))


def test_s2d_stem_matches_the_reference(s2d_flag):
    """With the flag on in both packages (the default), the ResNet stem
    runs the rewrite in both and agrees."""
    x = np.random.RandomState(1).randn(2, 3, 64, 64).astype(np.float32)
    w = np.random.RandomState(2).randn(8, 3, 7, 7).astype(np.float32) * .1
    attrs = {"strides": [2, 2], "paddings": [3, 3], "dilations": [1, 1]}
    jout, pout, jg, pg = run_both("conv2d", {"Input": [x], "Filter": [w]},
                                  attrs, out="Output",
                                  grad=("Input", "Filter"))
    check_outputs(jout, pout)
    check_grads(jg, pg)


def test_s2d_not_applied_to_wide_channels():
    z = torch.zeros
    assert not nn_ops._s2d_eligible(z(1, 64, 56, 56), z(128, 64, 3, 3),
                                    (2, 2), (1, 1), (1, 1), 1)
    x, w = z(1, 3, 224, 224), z(64, 3, 7, 7)
    assert nn_ops._s2d_eligible(x, w, (2, 2), (3, 3), (1, 1), 1)
    assert not nn_ops._s2d_eligible(x, w, (1, 1), (3, 3), (1, 1), 1)
    assert not nn_ops._s2d_eligible(x, w, (2, 2), (3, 3), (2, 2), 1)


# -- pool ------------------------------------------------------------------

POOLS = [
    ("max", (2, 3, 6, 6), {"pooling_type": "max", "ksize": [2, 2],
                           "strides": [2, 2], "paddings": [0, 0]}),
    ("max_padded", (2, 3, 7, 7), {"pooling_type": "max", "ksize": [3, 3],
                                  "strides": [2, 2], "paddings": [1, 1]}),
    ("avg_exclusive_pad", (2, 3, 7, 7),
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1], "exclusive": True}),
    ("avg_inclusive_pad", (2, 3, 7, 7),
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1], "exclusive": False}),
    ("avg_no_pad", (2, 3, 6, 6), {"pooling_type": "avg", "ksize": [2, 2],
                                  "strides": [2, 2], "paddings": [0, 0]}),
    ("global", (2, 3, 5, 5), {"pooling_type": "avg", "ksize": [2, 2],
                              "global_pooling": True}),
    ("avg_ceil", (2, 3, 7, 7), {"pooling_type": "avg", "ksize": [2, 2],
                                "strides": [2, 2], "paddings": [0, 0],
                                "ceil_mode": True}),
    ("max_ceil_pad", (1, 2, 8, 8), {"pooling_type": "max", "ksize": [3, 3],
                                    "strides": [2, 2], "paddings": [1, 1],
                                    "ceil_mode": True}),
]


@pytest.mark.parametrize("name,xs,attrs", POOLS, ids=[p[0] for p in POOLS])
def test_pool2d(name, xs, attrs):
    x = rng_uniform(17, xs)
    jout, pout, jg, pg = run_both("pool2d", {"X": [x]}, attrs, grad=("X",))
    check_outputs(jout, pout)
    check_grads(jg, pg)


@pytest.mark.parametrize("pads", [(0, 0), (1, 1)])
def test_max_pool_gradient_at_ties_goes_to_the_first_maximum(pads):
    """A window of equal elements (zeros) gives all its gradient to its
    first element in scan order, in both packages; padding never wins."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, 3, 3] = -1.0
    attrs = {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
             "paddings": list(pads)}
    _, _, jg, pg = run_both("pool2d", {"X": [x]}, attrs, grad=("X",))
    np.testing.assert_array_equal(pg[0].numpy(), np.asarray(jg[0]))
    g = pg[0].numpy()[0, 0]
    assert np.count_nonzero(g) == g.size // 4 if pads == (0, 0) \
        else np.count_nonzero(g) >= 4
    if pads == (0, 0):
        assert g[0, 0] != 0 and g[0, 1] == 0 and g[1, 0] == 0


# -- batch_norm ------------------------------------------------------------

def _bn_ins(xs, seed=5):
    C = xs[1]
    return {"X": [rng_uniform(seed, xs, -2, 2)],
            "Scale": [rng_uniform(seed + 1, (C,), 0.5, 1.5)],
            "Bias": [rng_uniform(seed + 2, (C,), -0.5, 0.5)],
            "Mean": [rng_uniform(seed + 3, (C,), -0.2, 0.2)],
            "Variance": [rng_uniform(seed + 4, (C,), 0.5, 1.5)]}


@pytest.mark.parametrize("name,xs,attrs,ctx_test", [
    ("train_nchw", (4, 3, 5, 5), {"momentum": 0.9, "epsilon": 1e-5}, False),
    ("train_nc", (8, 6), {"momentum": 0.8, "epsilon": 1e-3}, False),
    ("infer_attr", (4, 3, 5, 5), {"is_test": True, "epsilon": 1e-5}, False),
    ("infer_ctx", (4, 3, 5, 5), {"epsilon": 1e-5}, True),
])
def test_batch_norm(name, xs, attrs, ctx_test):
    """All five outputs; Y's gradients w.r.t. X, Scale and Bias. In test
    mode (the op's attr or the context's) the running stats come back
    unchanged, the same tensors."""
    ins = _bn_ins(xs)
    jout, pout, jg, pg = run_both("batch_norm", ins, attrs, out="Y",
                                  grad=("X", "Scale", "Bias"),
                                  j_is_test=ctx_test, p_is_test=ctx_test)
    check_outputs(jout, pout)
    check_grads(jg, pg)
    if attrs.get("is_test") or ctx_test:
        pins = {k: [torch.from_numpy(v[0])] for k, v in ins.items()}
        ctx = _PCtx()
        ctx.is_test = ctx_test
        out = preg.get_op("batch_norm").lowering(ctx, pins, attrs)
        assert out["MeanOut"][0] is pins["Mean"][0]
        assert out["VarianceOut"][0] is pins["Variance"][0]


# -- the rest --------------------------------------------------------------

OTHERS = [
    ("lrn", lambda: {"X": [rng_uniform(1, (2, 7, 3, 3))]},
     {"n": 5, "alpha": 1e-2, "beta": 0.75, "k": 1.0}, "Out", ("X",)),
    ("lrn", lambda: {"X": [rng_uniform(1, (2, 4, 3, 3))]},
     {"n": 4, "alpha": 1e-1, "beta": 0.5, "k": 2.0}, "Out", ("X",)),
    ("l2_normalize", lambda: {"X": [rng_uniform(1, (4, 6))]},
     {"axis": -1}, "Out", ("X",)),
    ("l2_normalize", lambda: {"X": [rng_uniform(1, (4, 6, 3))]},
     {"axis": 1}, "Out", ("X",)),
    ("maxout", lambda: {"X": [rng_uniform(1, (2, 6, 3, 3))]},
     {"groups": 3}, "Out", ("X",)),
    ("im2sequence", lambda: {"X": [rng_uniform(1, (2, 3, 6, 5))]},
     {"kernels": [2, 3], "strides": [2, 1], "paddings": [1, 0, 0, 1]},
     "Out", ("X",)),
    ("concat", lambda: {"X": [rng_uniform(1, (2, 3, 4)),
                              rng_uniform(2, (2, 5, 4))]},
     {"axis": 1}, "Out", ("X",)),
]


@pytest.mark.parametrize("op,make,attrs,out,grad", OTHERS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(OTHERS)])
def test_other_op(op, make, attrs, out, grad):
    jout, pout, jg, pg = run_both(op, make(), attrs, out=out, grad=grad)
    check_outputs(jout, pout)
    check_grads(jg, pg)


@pytest.mark.parametrize("ids_shape", [(5, 1), (5,)])
def test_one_hot(ids_shape):
    ids = np.random.RandomState(0).randint(0, 7, ids_shape).astype(np.int64)
    jout, pout, _, _ = run_both("one_hot", {"X": [ids]}, {"depth": 7})
    check_outputs(jout, pout)
    assert pout["Out"][0].dtype == torch.float32


# -- dropout ---------------------------------------------------------------

@pytest.mark.parametrize("attr_test,ctx_test", [(True, False),
                                                (False, True)])
def test_dropout_is_the_identity_in_test_mode(attr_test, ctx_test):
    x = rng_uniform(1, (4, 8))
    jout, pout, _, _ = run_both("dropout", {"X": [x]},
                                {"dropout_prob": 0.5, "is_test": attr_test},
                                j_is_test=ctx_test, p_is_test=ctx_test)
    check_outputs(jout, pout, atol=0)


def test_dropout_train_keeps_its_share_and_upscales():
    """p 0.3 over 200000 elements: the kept share within 0.01 of 0.7
    (seven standard deviations) and every kept element x / 0.7. The
    mask draws from the context's generator, not the reference's
    stream, so the test is statistical, not bitwise."""
    x = torch.from_numpy(rng_uniform(1, (400, 500), 0.5, 1.5))
    ctx = _PCtx()
    ctx.generator = torch.Generator().manual_seed(0)
    out = preg.get_op("dropout").lowering(ctx, {"X": [x]},
                                          {"dropout_prob": 0.3})
    y, mask = out["Out"][0], out["Mask"][0]
    kept = mask.bool()
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / 0.7, rtol=1e-6, atol=0)
    assert (y[~kept] == 0).all()
    again = preg.get_op("dropout").lowering(ctx, {"X": [x]},
                                            {"dropout_prob": 0.3})
    assert not torch.equal(again["Mask"][0], mask)


def test_conv_and_pool_shapes_infer_on_meta_tensors():
    """Build-time shape inference runs the lowerings on meta tensors:
    the -1 batch stays -1 through the stem, and the program's var
    shapes equal the JAX front end's."""
    shapes = {}
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            img = P.layers.data("img", [3, 32, 32])
            c = P.layers.conv2d(img, 8, 7, stride=2, padding=3,
                                bias_attr=False)
            b = P.layers.batch_norm(c, act="relu")
            p = P.layers.pool2d(b, pool_size=3, pool_stride=2,
                                pool_padding=1)
            d = P.layers.dropout(p, 0.5)
        shapes[P.__name__] = [tuple(v.shape) for v in (c, b, p, d)]
    assert shapes["paddle_tpu_torch"] == shapes["paddle_tpu"]
    assert shapes["paddle_tpu_torch"][2] == (-1, 8, 8, 8)
