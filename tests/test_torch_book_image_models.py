"""The image "book" models trained in the port on the CPU.

The port twins of tests/test_book_models.py's
test_recognize_digits_mlp (with its `accuracy`),
test_recognize_digits_conv, test_image_classification_resnet,
test_image_classification_vgg and
test_image_classification_googlenet_smallnet: the same synthetic data,
steps, optimizer and convergence thresholds, with the port's own
initialisation (its generator, not the reference's stream). Each
model's Program dict equals the JAX front end's. AlexNet's forward (LRN,
dropout in test mode) is held to the JAX package's from one
initialisation.
"""

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.models  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.weights import scope_from_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401

_SEED = 1234

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _fresh_programs():
    for P in (jpt, pt):
        P.framework.reset_default_programs()
    yield


def _same_program_as_reference(build):
    """`build(P)` in both packages (fresh default programs): the main
    and startup Program dicts are equal. Leaves the port's programs as
    the default ones and returns what `build(pt)` returned."""
    jpt.framework.reset_default_programs()
    build(jpt)
    jmain = jpt.default_main_program().to_dict()
    jstart = jpt.default_startup_program().to_dict()
    pt.framework.reset_default_programs()
    out = build(pt)
    assert pt.default_main_program().to_dict() == jmain
    assert pt.default_startup_program().to_dict() == jstart
    return out


def _train(cost, feeds, steps=60, fetch_extra=()):
    """tests/test_book_models.py's _train, in the port (the program's Adam
    is built by _classifier): the startup program, `steps` runs on one
    batch; (first loss, last loss), and the last run's `fetch_extra`
    values when asked for."""
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    first = last = None
    for _ in range(steps):
        out = exe.run(feed=feeds, fetch_list=[cost] + list(fetch_extra),
                      scope=scope)
        loss = float(np.asarray(out[0]).ravel()[0])
        if first is None:
            first = loss
        last = loss
    assert np.isfinite(last), last
    if fetch_extra:
        return first, last, out[1:]
    return first, last


def _classifier(P, model, shape, lr, **kw):
    img = P.layers.data("img", shape)
    label = P.layers.data("label", [1], dtype="int64")
    probs = model(P)(img, **kw)
    cost = P.layers.mean(P.layers.cross_entropy(probs, label))
    P.AdamOptimizer(learning_rate=lr).minimize(cost)
    return cost


def test_recognize_digits_mlp():
    """The MLP on the reference's synthetic digits (64 rows, 784
    features, label = the argmax of |x[:, :10]|), Adam 1e-2, 80 steps:
    the loss falls below a fifth and the batch's `accuracy` (top-1,
    exact: a count over the batch) exceeds 0.9."""
    rng = np.random.RandomState(_SEED)
    x = rng.randn(64, 784).astype(np.float32)
    y = (np.abs(x[:, :10]).argmax(axis=1)).astype(np.int64)[:, None]

    def build(P):
        img = P.layers.data("img", [784])
        label = P.layers.data("label", [1], dtype="int64")
        probs = P.models.mnist.mlp(img)
        cost = P.layers.mean(P.layers.cross_entropy(probs, label))
        acc = P.layers.accuracy(input=probs, label=label)
        P.AdamOptimizer(learning_rate=1e-2).minimize(cost)
        return cost, acc

    cost, acc = _same_program_as_reference(build)
    first, last, (acc_v,) = _train(cost, {"img": x, "label": y}, steps=80,
                                   fetch_extra=[acc])
    assert last < first * 0.2, (first, last)
    assert acc_v.dtype == np.float32 and acc_v.shape == (1,)
    assert float(acc_v[0]) > 0.9


def test_recognize_digits_conv():
    rng = np.random.RandomState(_SEED)
    x = rng.randn(32, 1, 28, 28).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.int64)[:, None]
    cost = _same_program_as_reference(lambda P: _classifier(
        P, lambda P: P.models.mnist.conv_net, [1, 28, 28], 2e-3))
    first, last = _train(cost, {"img": x, "label": y}, steps=80)
    assert last < first * 0.5, (first, last)


def test_image_classification_resnet():
    rng = np.random.RandomState(_SEED)
    x = rng.randn(16, 3, 32, 32).astype(np.float32)
    y = (x[:, 0].mean(axis=(1, 2)) > x[:, 1].mean(axis=(1, 2)))\
        .astype(np.int64)[:, None]
    cost = _same_program_as_reference(lambda P: _classifier(
        P, lambda P: P.models.resnet.resnet_cifar10, [3, 32, 32], 1e-2,
        class_dim=2, depth=20))
    first, last = _train(cost, {"img": x, "label": y}, steps=30)
    assert last < first * 0.7, (first, last)


def test_image_classification_vgg():
    rng = np.random.RandomState(_SEED)
    x = rng.randn(8, 3, 32, 32).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.int64)[:, None]
    cost = _same_program_as_reference(lambda P: _classifier(
        P, lambda P: P.models.vgg.vgg16_bn_drop, [3, 32, 32], 1e-2,
        class_dim=2))
    first, last = _train(cost, {"img": x, "label": y}, steps=15)
    assert np.isfinite(last)   # heavyweight: smoke + finite loss


def test_image_classification_googlenet_smallnet():
    """GoogLeNet's inception stack (smoke: builds at 224, loss finite)
    and SmallNet cifar-quick trains."""
    rng = np.random.RandomState(_SEED)
    x = rng.randn(2, 3, 224, 224).astype(np.float32)
    y = np.array([[0], [1]], np.int64)
    cost = _same_program_as_reference(lambda P: _classifier(
        P, lambda P: P.models.googlenet.googlenet, [3, 224, 224], 1e-2,
        class_dim=2))
    _, last = _train(cost, {"img": x, "label": y}, steps=3)
    assert np.isfinite(last)

    x = rng.randn(16, 3, 32, 32).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.int64)[:, None]
    cost = _same_program_as_reference(lambda P: _classifier(
        P, lambda P: P.models.googlenet.smallnet_mnist_cifar, [3, 32, 32],
        2e-3, class_dim=2))
    first, last = _train(cost, {"img": x, "label": y}, steps=40)
    assert last < first * 0.7, (first, last)


def test_alexnet_forward_matches_the_reference():
    """AlexNet (11x11/4 stem through the s2d rewrite, LRN, max pools,
    dropout in test mode) at 67 x 67, 10 classes, B 2, from the JAX
    startup's weights: probabilities within 1e-5."""
    progs = []
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            img = P.layers.data("img", [3, 67, 67])
            probs = P.models.alexnet.alexnet(img, class_dim=10,
                                             is_test=True)
        progs.append((main, startup, probs))
    assert progs[1][0].to_dict() == progs[0][0].to_dict()
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(progs[0][1], scope=jscope)
    init = {k: np.array(jscope.get(k)) for k in jscope.keys()
            if not k.startswith("__")}
    x = np.random.RandomState(_SEED).rand(2, 3, 67, 67).astype(np.float32)
    jp, = jexe.run(progs[0][0], feed={"img": x},
                   fetch_list=[progs[0][2].name], scope=jscope)
    pp, = pt.Executor(pt.CPUPlace()).run(
        progs[1][0], feed={"img": x}, fetch_list=[progs[1][2].name],
        scope=scope_from_numpy(init, "cpu"))
    assert pp.shape == (2, 10)
    np.testing.assert_allclose(pp, np.asarray(jp), rtol=0, atol=1e-5)
