"""The paddle.v2-shaped API (`paddle_tpu_torch.v2`) and the `dataset`
loaders in the port, on the CPU.

- The five scripts of tests/test_v2_api.py (recognize-digits MLP with
  inference and Parameters, the sentiment LSTM over id sequences, the
  conv network's shapes, preset parameters surviving the trainer, the
  misc layers and the feeding order) through the port's v2 at
  `init(use_gpu=False)`, with the same assertions.
- The book's recognize-digits conv network (two simple_img_conv_pool of
  20 and 50 5x5 filters, fc 10 softmax) trained by `trainer.SGD` with
  Momentum in both packages from the JAX package's initial weights: the
  costs of 8 batches within 1e-5 relative, and `infer`'s probabilities
  after them within 1e-5.
- `dataset.mnist` and `dataset.cifar` samples bit-equal to the JAX
  package's (synthetic mode).
- The device rule: `init()` / `init(use_gpu=True)` choose the card and
  raise with none visible; after them the v2 entry points given no
  place raise as well.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.v2 as jpaddle
from paddle_tpu import event as jevents
from paddle_tpu import layers as jlayers
import paddle_tpu_torch.v2 as paddle
from paddle_tpu_torch import event as events
from paddle_tpu_torch import layers as flayers
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _cpu():
    paddle.init(use_gpu=False)
    yield
    paddle.init(use_gpu=False)


def test_v2_recognize_digits_end_to_end():
    paddle.init(use_gpu=False, trainer_count=1)
    images = paddle.layer.data(
        name="pixel", type=paddle.data_type.dense_vector(784))
    label = paddle.layer.data(
        name="label", type=paddle.data_type.integer_value(10))
    hidden = paddle.layer.fc(input=images, size=64,
                             act=paddle.activation.Relu())
    predict = paddle.layer.fc(input=hidden, size=10,
                              act=paddle.activation.Softmax())
    cost = paddle.layer.classification_cost(input=predict, label=label)

    parameters = paddle.parameters.create(cost)
    optimizer = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    trainer = paddle.trainer.SGD(cost=cost, parameters=parameters,
                                 update_equation=optimizer)
    costs = []

    def handler(e):
        if isinstance(e, events.EndIteration):
            costs.append(e.cost)

    trainer.train(
        reader=paddle.batch(
            paddle.reader.firstn(paddle.dataset.mnist.train(), 1024), 64),
        num_passes=3, event_handler=handler)
    assert costs[-1] < costs[0] * 0.5

    test_rows = [ex for ex in
                 paddle.reader.firstn(paddle.dataset.mnist.test(), 32)()]
    probs = paddle.infer(output_layer=predict, parameters=parameters,
                         input=[(x,) for x, _y in test_rows])
    assert probs.shape == (32, 10)
    acc = np.mean(probs.argmax(1) == [y for _x, y in test_rows])
    assert acc > 0.8, acc

    names = parameters.names()
    assert names
    w = parameters.get(names[0])
    assert isinstance(w, np.ndarray)
    parameters.set(names[0], w)
    np.testing.assert_array_equal(parameters.get(names[0]), w)


def test_v2_sentiment_lstm_sequences():
    words = paddle.layer.data(
        name="words", type=paddle.data_type.integer_value_sequence(100))
    label = paddle.layer.data(
        name="label", type=paddle.data_type.integer_value(2))
    emb = paddle.layer.embedding(input=words, size=16)
    lstm = paddle.networks.simple_lstm(input=emb, size=16)
    pooled = paddle.layer.pooling(input=lstm,
                                  pooling_type=paddle.pooling.Max())
    predict = paddle.layer.fc(input=pooled, size=2,
                              act=paddle.activation.Softmax())
    cost = paddle.layer.classification_cost(input=predict, label=label)

    parameters = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(
        cost=cost, parameters=parameters,
        update_equation=paddle.optimizer.Adam(learning_rate=0.01))
    rng = np.random.RandomState(0)

    def synth():
        for _ in range(256):
            y = int(rng.randint(0, 2))
            lo, hi = (3, 50) if y else (50, 100)
            yield rng.randint(lo, hi, size=rng.randint(4, 12)).tolist(), y

    costs = []
    trainer.train(
        reader=paddle.batch(synth, 32), num_passes=4,
        event_handler=lambda e: costs.append(e.cost)
        if isinstance(e, events.EndIteration) else None,
        feeding={"words": 0, "label": 1})
    assert costs[-1] < costs[0] * 0.6, (costs[0], costs[-1])


def test_v2_conv_network_shapes():
    img = paddle.layer.data(
        name="img", type=paddle.data_type.dense_vector(3 * 16 * 16))
    reshaped = flayers.reshape(img, [-1, 3, 16, 16])
    conv = paddle.layer.img_conv(input=reshaped, filter_size=3,
                                 num_filters=8, padding=1,
                                 act=paddle.activation.Relu())
    pooled = paddle.layer.img_pool(input=conv, pool_size=2,
                                   pool_type=paddle.pooling.Max())
    assert tuple(pooled.shape[1:]) == (8, 8, 8)
    seq_pool = paddle.networks.simple_img_conv_pool(
        reshaped, filter_size=3, num_filters=4, pool_size=2,
        act=paddle.activation.Relu())
    assert tuple(seq_pool.shape[1:]) == (4, 7, 7)


def test_v2_preset_parameters_survive_trainer_construction():
    x = paddle.layer.data(name="x", type=paddle.data_type.dense_vector(4))
    y = paddle.layer.data(name="y", type=paddle.data_type.dense_vector(1))
    pred = paddle.layer.fc(input=x, size=1)
    cost = paddle.layer.mse_cost(input=pred, label=y)
    parameters = paddle.parameters.create(cost)
    name = parameters.names()[0]
    preset = np.full_like(parameters.get(name), 7.25)
    parameters.set(name, preset)
    paddle.trainer.SGD(cost=cost, parameters=parameters,
                       update_equation=paddle.optimizer.SGD(0.1))
    np.testing.assert_array_equal(parameters.get(name), preset)
    with pytest.raises(KeyError, match="not initialised"):
        parameters.get("no_such_param")


def test_v2_misc_layers_build():
    a = paddle.layer.data(name="a", type=paddle.data_type.dense_vector(8))
    b = paddle.layer.data(name="b", type=paddle.data_type.dense_vector(8))
    s = paddle.layer.addto(input=[a, b], act=paddle.activation.Tanh())
    c = paddle.layer.concat(input=[a, b])
    d = paddle.layer.dropout(input=s, dropout_rate=0.3)
    m = paddle.layer.max_id(input=c)
    assert c.shape[-1] == 16 and m is not None and d is not None
    assert paddle.layer.default_feed_order() == ["a", "b"]
    assert paddle.layer.default_feed_order({"b": 0, "a": 1}) == ["b", "a"]


def _digits_conv(P, L):
    """The book's recognize-digits conv network in v2 package P (its
    fluid layers module L for the reshape)."""
    images = P.layer.data(name="pixel",
                          type=P.data_type.dense_vector(784))
    label = P.layer.data(name="label",
                         type=P.data_type.integer_value(10))
    x = L.reshape(images, [-1, 1, 28, 28])
    c1 = P.networks.simple_img_conv_pool(
        input=x, filter_size=5, num_filters=20, pool_size=2, pool_stride=2,
        act=P.activation.Relu())
    c2 = P.networks.simple_img_conv_pool(
        input=c1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act=P.activation.Relu())
    predict = P.layer.fc(input=c2, size=10, act=P.activation.Softmax())
    return predict, P.layer.classification_cost(input=predict,
                                                label=label)


def _digits_run(P, L, ev_mod, init=None, B=32, batches=8):
    P.init(use_gpu=False)
    predict, cost = _digits_conv(P, L)
    parameters = P.parameters.create(cost)
    if init is None:
        init = {n: parameters.get(n) for n in parameters.names()}
    for n, v in init.items():
        parameters.set(n, v)
    trainer = P.trainer.SGD(
        cost=cost, parameters=parameters,
        update_equation=P.optimizer.Momentum(learning_rate=0.01,
                                             momentum=0.9))
    costs = []
    trainer.train(
        reader=P.batch(P.reader.firstn(P.dataset.mnist.train(),
                                       B * batches), B),
        num_passes=1,
        event_handler=lambda e: costs.append(e.cost)
        if isinstance(e, ev_mod.EndIteration) else None)
    rows = [(x,) for x, _ in P.reader.firstn(P.dataset.mnist.test(), B)()]
    probs = P.infer(output_layer=predict, parameters=parameters,
                    input=rows)
    return init, costs, np.asarray(probs)


def test_v2_digits_conv_trains_as_the_reference():
    init, jcosts, jprobs = _digits_run(jpaddle, jlayers, jevents)
    _, pcosts, pprobs = _digits_run(paddle, flayers, events, init=init)
    assert len(pcosts) == len(jcosts) == 8
    np.testing.assert_allclose(pcosts, jcosts, rtol=1e-5)
    np.testing.assert_allclose(pprobs, jprobs, rtol=0, atol=1e-5)


def _same_samples(jreader, preader, n):
    for (jx, jy), (px, py) in zip(jpaddle.reader.firstn(jreader, n)(),
                                  paddle.reader.firstn(preader, n)()):
        assert px.dtype == jx.dtype and px.shape == jx.shape
        assert px.tobytes() == jx.tobytes()
        assert type(py) is type(jy) and py == jy


@pytest.mark.parametrize("split", ["mnist.train", "mnist.test",
                                   "cifar.train10", "cifar.test10",
                                   "cifar.train100", "cifar.test100"])
def test_dataset_samples_bit_equal_the_reference(split):
    mod, fn = split.split(".")
    jreader = getattr(getattr(jpaddle.dataset, mod), fn)()
    preader = getattr(getattr(paddle.dataset, mod), fn)()
    _same_samples(jreader, preader, 64)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
@pytest.mark.parametrize("use_gpu", [None, True])
def test_init_without_a_card_raises(use_gpu):
    kwargs = {} if use_gpu is None else {"use_gpu": use_gpu}
    with pytest.raises(RuntimeError, match="none is visible"):
        paddle.init(**kwargs)
    x = paddle.layer.data(name="x", type=paddle.data_type.dense_vector(4))
    cost = paddle.layer.mse_cost(input=paddle.layer.fc(input=x, size=1),
                                 label=x)
    with pytest.raises(RuntimeError, match="none is visible"):
        paddle.parameters.create(cost)
