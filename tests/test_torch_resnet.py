"""ResNet-50 in the port against the JAX package on the CPU.

Program text: resnet50 at 224 x 224 (1000 classes) and resnet_cifar10
build the JAX front end's Program dict, names included. Numerics:
full-depth ResNet-50 (53 convs, 53 batch norms) at 32 x 32, 10
classes, B 4, f32, from one initialisation (the JAX startup's, carried
over as numpy):

  * two Momentum steps (lr 0.01, momentum 0.9) op by op: every op of the
    training program lowered by the port on the reference's values of
    its inputs, against the reference's outputs (forward, gradients,
    updates, running stats), within 1e-4 of each var's largest element;
  * the first step run free in each package: probabilities and loss
    within 1e-2, running stats within 1e-2 of their largest element
    (why looser: see test_resnet50_two_momentum_steps_op_by_op);
  * the clone(for_test=True) inference probabilities within 1e-4, the
    running stats untouched;
  * clone(for_test=True) marks the test-aware ops as the reference does.
"""

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.models  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.executor import lower_ops_on
from paddle_tpu_torch.weights import scope_from_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401

B, HW, CLASSES = 4, 32, 10
LR, MOMENTUM = 0.01, 0.9
PROB_ATOL = 1e-4
STATE_REL = 1e-4

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _resnet_train(P, hw=HW, classes=CLASSES, net="resnet50",
                  opt=True):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        img = P.layers.data("img", [3, hw, hw])
        label = P.layers.data("label", [1], dtype="int64")
        probs = getattr(P.models.resnet, net)(img, class_dim=classes)
        cost = P.layers.mean(P.layers.cross_entropy(probs, label))
        if opt:
            P.MomentumOptimizer(learning_rate=LR,
                                momentum=MOMENTUM).minimize(cost)
    return main, startup, probs, cost


def _feed(seed, b=B, hw=HW, classes=CLASSES):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(b, 3, hw, hw).astype(np.float32),
            "label": rng.randint(0, classes, (b, 1)).astype(np.int64)}


def _numpy_scope(jscope):
    return {k: np.array(jscope.get(k)) for k in jscope.keys()
            if not k.startswith("__")}


@pytest.mark.parametrize("net,hw,classes", [("resnet50", 224, 1000),
                                                ("resnet_cifar10", 32, 10)])
def test_program_text_is_the_reference(net, hw, classes):
    dicts = []
    for P in (jpt, pt):
        main, startup, _, _ = _resnet_train(P, hw, classes, net)
        dicts.append((main.to_dict(), startup.to_dict()))
    assert dicts[1][0] == dicts[0][0]
    assert dicts[1][1] == dicts[0][1]
    ops = dicts[1][0]["blocks"][0]["ops"]
    if net == "resnet50":
        assert sum(op["type"] == "conv2d" for op in ops) == 53
        assert sum(op["type"] == "batch_norm" for op in ops) == 53


def _resnet_infer(P, net="resnet50", hw=HW, classes=CLASSES, **kw):
    """bench.py's inference program: the image feed, the net and its
    clone(for_test=True)."""
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        img = P.layers.data("img", [3, hw, hw])
        probs = getattr(P.models.resnet, net)(img, class_dim=classes,
                                                   **kw)
    return main, startup, probs


@pytest.fixture(scope="module")
def resnet50():
    """Both packages' ResNet-50 (32 x 32, 10 classes) and the JAX
    startup's initialisation as numpy."""
    jmain, jstart, jprobs, jcost = _resnet_train(jpt)
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    init = _numpy_scope(jscope)
    pmain, _, pprobs, pcost = _resnet_train(pt)
    assert pmain.to_dict() == jmain.to_dict()
    return dict(jmain=jmain, jexe=jexe, jscope=jscope, jprobs=jprobs,
                jcost=jcost, pmain=pmain, pprobs=pprobs, pcost=pcost,
                init=init)


def test_resnet50_two_momentum_steps_op_by_op(resnet50):
    """Two Momentum steps of the full-depth program: every op the port
    lowers (forward, its grad op, the gradient sums, the 161 momentum
    updates and the 53 batch norms' running stats) on the reference's
    values of its inputs, against the reference's outputs: within 1e-4
    of each var's largest |element| (the f32 sums run in other orders;
    XLA's batch mean over 1024 elements is the less exact of the two,
    ~6e-6 relative at the stem). Op by op, because run free the two
    packages' f32 roundings move a relu input across 0 somewhere in
    ResNet-50's 16 residual blocks, and the batch norms' backward
    spreads that element's changed gradient over its channel: the
    reference and the port each agree with their own float64 run
    (test_resnet50_first_step_runs_free holds the first step end to
    end)."""
    r = resnet50
    block = r["pmain"].global_block()
    names = [n for n in block.vars if n not in ("img", "label")]
    jscope = jpt.Scope()
    for k, v in r["init"].items():
        jscope.set(k, v)
    checked = set()
    for step in range(2):
        before = _numpy_scope(jscope)
        feed = _feed(10 + step)
        out = r["jexe"].run(r["jmain"], feed=feed, fetch_list=names,
                            scope=jscope)
        after = {n: np.asarray(v) for n, v in zip(names, out)}
        pairs = lower_ops_on(r["pmain"], "cpu", before, {**after, **feed})
        for n, (got, want) in pairs.items():
            got, want = got.numpy(), want.numpy()
            assert got.shape == want.shape and got.dtype == want.dtype, n
            tol = STATE_REL * max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                       err_msg=f"step {step + 1}: {n}")
        checked |= set(pairs)
    persist = [n for n, v in block.vars.items() if v.persistable]
    stats = [n for n in persist if ".mean" in n or ".var" in n]
    written = [n for n in persist if not n.startswith("learning_rate")]
    assert len(stats) == 106 and set(written) <= checked
    assert sum("@GRAD" in n for n in checked) > 300


def test_resnet50_first_step_runs_free(resnet50):
    """One Momentum step of the whole program in each package from the
    same weights: probabilities and loss within 1e-2 (read 4.6e-3: the
    f32 rounding differences grow through the last stage, whose batch
    norms see 4 values a channel at 1 x 1); the running stats, which
    the forward writes, within 1e-2 of their largest element (read
    1.6e-3, the last stage's variances)."""
    r = resnet50
    jscope = jpt.Scope()
    for k, v in r["init"].items():
        jscope.set(k, v)
    pexe = pt.Executor(pt.CPUPlace())
    pscope = scope_from_numpy(r["init"], "cpu")
    feed = _feed(10)
    jp, jl = r["jexe"].run(r["jmain"], feed=feed,
                           fetch_list=[r["jprobs"], r["jcost"]],
                           scope=jscope)
    pp, pl = pexe.run(r["pmain"], feed=feed,
                      fetch_list=[r["pprobs"], r["pcost"]], scope=pscope)
    np.testing.assert_allclose(pp, np.asarray(jp), rtol=0, atol=1e-2)
    np.testing.assert_allclose(pl, np.asarray(jl), rtol=0, atol=1e-2)
    for n in r["init"]:
        if ".mean" in n or ".var" in n:
            want = np.asarray(jscope.get(n))
            tol = 1e-2 * float(np.abs(want).max())
            np.testing.assert_allclose(pscope.get(n).numpy(), want, rtol=0,
                                       atol=tol, err_msg=n)
            assert not np.array_equal(want, r["init"][n]), n


def test_resnet50_inference_clone_matches(resnet50):
    """clone(for_test=True) of bench.py's inference program: both
    packages normalise with the running stats (here moved off their
    initial values), and the port leaves them unchanged."""
    res = []
    for P in (jpt, pt):
        main, _, probs = _resnet_infer(P)
        res.append((main.clone(for_test=True), probs))
    assert res[1][0].to_dict() == res[0][0].to_dict()
    rng = np.random.RandomState(7)
    jscope, init = jpt.Scope(), {}
    for k, v in resnet50["init"].items():
        if ".mean" in k:
            v = rng.uniform(-0.5, 0.5, v.shape).astype(v.dtype)
        elif ".var" in k:
            v = rng.uniform(0.5, 2.0, v.shape).astype(v.dtype)
        init[k] = v
        jscope.set(k, v)
    pscope = scope_from_numpy(init, "cpu")
    feed = {"img": _feed(20)["img"]}
    jp, = resnet50["jexe"].run(res[0][0], feed=feed,
                               fetch_list=[res[0][1].name], scope=jscope)
    pp, = pt.Executor(pt.CPUPlace()).run(
        res[1][0], feed=feed, fetch_list=[res[1][1].name], scope=pscope)
    np.testing.assert_allclose(pp, np.asarray(jp), rtol=0, atol=PROB_ATOL)
    for n, v in init.items():
        np.testing.assert_array_equal(pscope.get(n).numpy(), v, n)


def test_clone_for_test_marks_test_aware_ops_as_the_reference():
    attrs = []
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            x = P.layers.data("x", [3, 8, 8])
            y = P.layers.batch_norm(P.layers.conv2d(x, 4, 3), act="relu")
            y = P.layers.dropout(y, 0.5)
            P.layers.fc(y, 5, act="softmax")
        # a batch_norm without the attr is marked through the registry
        bn = next(op for op in main.global_block().ops
                  if op.type == "batch_norm")
        bn.attrs.pop("is_test")
        test = main.clone(for_test=True)
        attrs.append([(op.type, op.attrs.get("is_test"))
                      for op in test.global_block().ops])
        assert "is_test" not in bn.attrs
    assert attrs[1] == attrs[0]
    marked = {t for t, v in attrs[1] if v}
    assert marked == {"batch_norm", "dropout"}
