"""The legacy config front end (`trainer_config_helpers.parse_config`) in
the port against the JAX package, on the CPU.

- The inline configs of tests/test_legacy_config.py (copied here as
  strings), the CLI fixture tests/fixtures/cli/tiny_config.py and a
  legacy AlexNet config written after the published benchmark config
  benchmark/paddle/image/alexnet.py (67 x 67 images, 10 classes, B 4,
  layer_num 1 and 2) build Programs whose dicts (op types, slots,
  attrs, var names and shapes) equal the JAX package's, with the same
  feed order: only the data layers a layer reads are materialised.
- AlexNet's structure as the JAX tests assert it: two LRNs, the grouped
  convs at layer_num 2, dropout and cross_entropy.
- Three Momentum steps (L2 regularisation, the config's settings) of
  AlexNet from the JAX package's initial weights: the losses and every
  parameter within 1e-5 relative. Dropout is off in this comparison
  (the `drop_rate` config arg 0): the two packages' random streams
  differ by design, so a dropout mask cannot be compared.
- The port's twins of the JAX tests that run a parsed config (the
  `bool` config arg, the optimizer's regularisation and clip, an inline
  config that trains).
- The process-global `paddle` alias: a config parsed by the port after
  the JAX package's `parse_config` builds into the port's Program and
  its provider module binds the port's `data_provider`; the JAX package
  parses into its own afterwards.
"""

import os
import sys

import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu import data_provider as jdp
from paddle_tpu import trainer_config_helpers as jtch
import paddle_tpu_torch as pt
from paddle_tpu_torch import data_provider as pdp
from paddle_tpu_torch import trainer_config_helpers as ptch
from paddle_tpu_torch.weights import scope_from_numpy, scope_to_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "fixtures", "cli", "tiny_config.py")

# after benchmark/paddle/image/alexnet.py, sizes and the dropout rate
# as config args so the tests can cut them
ALEXNET = """
from paddle.trainer_config_helpers import *

height = get_config_arg('height', int, 227)
width = height
num_class = get_config_arg('num_class', int, 1000)
batch_size = get_config_arg('batch_size', int, 128)
gp = get_config_arg('layer_num', int, 1)
is_infer = get_config_arg('is_infer', bool, False)
drop_rate = get_config_arg('drop_rate', float, 0.5)

settings(batch_size=batch_size, learning_rate=0.01 / batch_size,
         learning_method=MomentumOptimizer(0.9),
         regularization=L2Regularization(0.0005 * batch_size))

net = data_layer('data', size=height * width * 3)
net = img_conv_layer(input=net, filter_size=11, num_channels=3,
                     num_filters=96, stride=4, padding=1)
net = img_cmrnorm_layer(input=net, size=5, scale=0.0001, power=0.75)
net = img_pool_layer(input=net, pool_size=3, stride=2)
net = img_conv_layer(input=net, filter_size=5, num_filters=256, stride=1,
                     padding=2, groups=gp)
net = img_cmrnorm_layer(input=net, size=5, scale=0.0001, power=0.75)
net = img_pool_layer(input=net, pool_size=3, stride=2)
net = img_conv_layer(input=net, filter_size=3, num_filters=384, stride=1,
                     padding=1)
net = img_conv_layer(input=net, filter_size=3, num_filters=384, stride=1,
                     padding=1, groups=gp)
net = img_conv_layer(input=net, filter_size=3, num_filters=256, stride=1,
                     padding=1, groups=gp)
net = img_pool_layer(input=net, pool_size=3, stride=2)
net = fc_layer(input=net, size=4096, act=ReluActivation(),
               layer_attr=ExtraAttr(drop_rate=drop_rate))
net = fc_layer(input=net, size=4096, act=ReluActivation(),
               layer_attr=ExtraAttr(drop_rate=drop_rate))
net = fc_layer(input=net, size=num_class, act=SoftmaxActivation())
if is_infer:
    outputs(net)
else:
    lab = data_layer('label', num_class)
    outputs(cross_entropy(input=net, label=lab))
"""
SMALL = {"height": 67, "num_class": 10, "batch_size": 4}

BOOL_ARG = ("assert get_config_arg('flag', bool, True) is False\n"
            "outputs(fc_layer(input=data_layer('x', 4), size=2,"
            " act=SoftmaxActivation()))")

REG_CLIP = """
settings(batch_size=4, learning_rate=0.1,
         learning_method=MomentumOptimizer(0.9),
         regularization=L2Regularization(1e-3),
         gradient_clipping_threshold=5.0)
outputs(classification_cost(
    input=fc_layer(input=data_layer('x', 4), size=2,
                   act=SoftmaxActivation()),
    label=data_layer('label', 2)))
"""

INLINE = """
batch_size = get_config_arg('batch_size', int, 32)
settings(batch_size=batch_size, learning_rate=0.1,
         learning_method=AdamOptimizer(),
         regularization=L2Regularization(1e-4))
unused = data_layer('unused', size=3)
net = data_layer('x', size=16)
net = fc_layer(input=net, size=32, act=ReluActivation(),
               layer_attr=ExtraAttr(drop_rate=0.2))
net = fc_layer(input=net, size=2, act=SoftmaxActivation())
lab = data_layer('label', 2)
outputs(classification_cost(input=net, label=lab))
"""

EMBEDDING = """
settings(batch_size=8, learning_rate=0.01,
         learning_method=MomentumOptimizer(0.9))
words = data_layer('words', size=50)
emb = embedding_layer(input=words, size=8)
hidden = simple_lstm(input=emb, size=8)
outputs(classification_cost(input=fc_layer(input=last_seq(hidden),
                                           size=2,
                                           act=SoftmaxActivation()),
                            label=data_layer('label', 2)))
"""

CONFIGS = {
    "bool_arg": (BOOL_ARG, {"flag": "False"}),
    "regularization_and_clip": (REG_CLIP, {}),
    "inline": (INLINE, {}),
    "embedding_sequence": (EMBEDDING, {}),
    "tiny_config": (TINY, {"batch_size": "16", "hidden": "8"}),
    "alexnet_layer_num_1": (ALEXNET, {**SMALL, "layer_num": 1}),
    "alexnet_layer_num_2": (ALEXNET, {**SMALL, "layer_num": 2}),
    "alexnet_infer": (ALEXNET, {**SMALL, "is_infer": "True"}),
}


def _parse(P, src, args):
    P.framework.reset_default_programs()
    tch = jtch if P is jpt else ptch
    rec = tch.parse_config(src, config_args=dict(args))
    return rec, P.framework.default_startup_program()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_builds_the_reference_program(name):
    src, args = CONFIGS[name]
    (jrec, jstart), (prec, pstart) = (_parse(P, src, args)
                                      for P in (jpt, pt))
    assert prec.program.to_dict() == jrec.program.to_dict()
    assert pstart.to_dict() == jstart.to_dict()
    assert prec.feed_order == jrec.feed_order
    assert [v.name for v in prec.outputs] == [v.name for v in jrec.outputs]
    assert prec.batch_size == jrec.batch_size
    assert prec.data_sources == jrec.data_sources
    jopt, popt = jrec.create_optimizer(), prec.create_optimizer()
    assert type(popt).__name__ == type(jopt).__name__
    assert (type(popt.regularization).__name__
            == type(jopt.regularization).__name__)
    assert ((getattr(popt, "gradient_clip", None) is None)
            == (getattr(jopt, "gradient_clip", None) is None))
    if name == "inline":
        # lazy data layers: a declared layer no layer reads is never fed
        assert prec.feed_order == ["x", "label"]


@pytest.mark.parametrize("layer_num", [1, 2])
def test_alexnet_structure(layer_num):
    rec, _ = _parse(pt, ALEXNET, {**SMALL, "layer_num": layer_num})
    ops = rec.program.global_block().ops
    types = [op.type for op in ops]
    assert types.count("lrn") == 2
    assert "dropout" in types and "cross_entropy" in types
    groups = [op.attrs.get("groups", 1) for op in ops
              if op.type == "conv2d"]
    assert groups.count(2) == (3 if layer_num == 2 else 0)
    assert rec.feed_order == ["data", "label"]
    out, = _parse(pt, ALEXNET, {**SMALL, "is_infer": "True"})[0].outputs
    assert out.shape[-1] == SMALL["num_class"]


def _momentum_steps(P, src, args, init, feeds):
    rec, startup = _parse(P, src, args)
    loss, = rec.outputs
    rec.create_optimizer().minimize(loss)
    if P is jpt:
        exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
        exe.run(startup, scope=scope)
        if init is None:
            init = {k: np.array(scope.get(k)) for k in scope.keys()
                    if not k.startswith("__")}
    else:
        exe = pt.Executor(pt.CPUPlace())
        scope = scope_from_numpy(init, "cpu")
    losses = [float(np.ravel(exe.run(rec.program, feed=f,
                                     fetch_list=[loss], scope=scope)[0])[0])
              for f in feeds]
    if P is jpt:
        state = {k: np.array(scope.get(k)) for k in init}
    else:
        state = scope_to_numpy(scope)
    return init, losses, state


@pytest.mark.parametrize("layer_num", [1, 2])
def test_alexnet_momentum_steps_match_the_reference(layer_num):
    args = {**SMALL, "layer_num": layer_num, "drop_rate": 0.0}
    rng = np.random.RandomState(layer_num)
    B, D = SMALL["batch_size"], 3 * SMALL["height"] ** 2
    feeds = [{"data": rng.rand(B, D).astype(np.float32),
              "label": rng.randint(0, 10, (B, 1)).astype(np.int64)}
             for _ in range(3)]
    init, jl, js = _momentum_steps(jpt, ALEXNET, args, None, feeds)
    _, pl, ps = _momentum_steps(pt, ALEXNET, args, init, feeds)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for k, v in js.items():
        scale = max(float(np.abs(v).max()), 1e-30)
        err = float(np.abs(ps[k].astype(np.float64) - v).max()) / scale
        assert err <= 1e-5, (k, err)


def test_bool_config_arg_string_parsing():
    pt.framework.reset_default_programs()
    ptch.parse_config(BOOL_ARG, config_args={"flag": "False"})
    with pytest.raises(ValueError, match="not a bool"):
        ptch.parse_config(BOOL_ARG, config_args={"flag": "maybe"})


def test_optimizer_carries_regularization_and_clip():
    pt.framework.reset_default_programs()
    opt = ptch.parse_config(REG_CLIP).create_optimizer()
    assert isinstance(opt, pt.optimizer.MomentumOptimizer)
    assert isinstance(opt.regularization, pt.regularizer.L2DecayRegularizer)
    assert opt.gradient_clip is not None


def test_inline_legacy_config_trains():
    pt.framework.reset_default_programs()
    rec = ptch.parse_config(INLINE)
    loss, = rec.outputs
    rec.create_optimizer().minimize(loss)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    rng = np.random.RandomState(1)
    x = rng.randn(64, 16).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int64)[:, None]
    losses = [float(np.ravel(exe.run(rec.program,
                                     feed={"x": x, "label": y},
                                     fetch_list=[loss], scope=scope)[0])[0])
              for _ in range(40)]
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def _all_op_ids(program):
    return {id(op) for blk in program.blocks for op in blk.ops}


def test_port_parse_after_the_reference_builds_into_the_port():
    """The JAX package parses first (installing its `paddle` alias),
    then the port: every op of the port's config lands in the port's
    default Program, none in the JAX package's, and the provider module
    binds the port's data_provider. The JAX package then parses into
    its own Program again."""
    jpt.framework.reset_default_programs()
    jrec = jtch.parse_config(TINY)
    assert sys.modules["paddle"].trainer_config_helpers is jtch
    j_ops = _all_op_ids(jpt.framework.default_main_program())

    pt.framework.reset_default_programs()
    prec = ptch.parse_config(TINY)
    assert sys.modules["paddle"].trainer_config_helpers is ptch
    assert sys.modules["paddle.trainer.PyDataProvider2"] is pdp
    assert prec.program is pt.framework.default_main_program()
    assert isinstance(prec.program, pt.framework.Program)
    p_ops = _all_op_ids(prec.program)
    assert p_ops and p_ops == _all_op_ids(pt.framework.default_main_program())
    assert _all_op_ids(jpt.framework.default_main_program()) == j_ops
    assert not p_ops & _all_op_ids(jrec.program)

    cfg_dir = os.path.dirname(TINY)
    prov = ptch.import_provider_module("tiny_provider", cfg_dir).process
    assert isinstance(prov, pdp.DataProvider)
    assert not isinstance(prov, jdp.DataProvider)
    types = prov.bind({"dim": 8, "num_class": 2,
                       "num_samples": 4}).input_types
    assert all(isinstance(t, pdp.InputType) for t in types)
    ds = dict(prec.data_sources, train_list=os.path.join(cfg_dir, "x"))
    bound = ptch._provider_input_types(ds)
    assert bound and all(isinstance(t, pdp.InputType) for t in bound)

    jpt.framework.reset_default_programs()
    jrec2 = jtch.parse_config(TINY)
    assert sys.modules["paddle"].trainer_config_helpers is jtch
    assert jrec2.program is jpt.framework.default_main_program()
    assert _all_op_ids(pt.framework.default_main_program()) == p_ops
