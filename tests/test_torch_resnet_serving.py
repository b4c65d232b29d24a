"""The image model's serving and feeding pieces in the port on the CPU:
the uint8 host feed of bench.py's host-fed ResNet-50 program, the
one-shot engine over a ResNet (batch norm in test mode, running stats
untouched) and int8 quant_conv2d against the JAX package's quantized
program."""

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.models  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.serving import EngineConfig, InferenceEngine
from paddle_tpu_torch.weights import scope_from_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _images(seed, b, hw=32):
    return np.random.RandomState(seed).rand(b, 3, hw, hw).astype(np.float32)


def _resnet_infer(P, net, **kw):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        img = P.layers.data("img", [3, 32, 32])
        probs = getattr(P.models.resnet, net)(img, class_dim=10, **kw)
    return main, startup, probs


def test_uint8_host_feed_casts_and_scales_in_the_program():
    """bench.py's host-fed program: a uint8 data var fed through the
    DeviceFeeder stays uint8 on the wire; the program casts and scales
    it, as the JAX package does."""
    from paddle_tpu_torch.reader import DeviceFeeder
    raw = np.random.RandomState(0).randint(0, 256, (2, 3, 8, 8)) \
        .astype(np.uint8)
    outs = []
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            u8 = P.layers.data("img_u8", [3, 8, 8], dtype="uint8")
            img = P.layers.scale(P.layers.cast(u8, "float32"),
                                 scale=1.0 / 255.0)
        outs.append((P, main, img))
    jout, = jpt.Executor(jpt.CPUPlace()).run(outs[0][1], feed={"img_u8": raw},
                                             fetch_list=[outs[0][2]])
    exe = pt.Executor(pt.CPUPlace())
    _, main, img = outs[1]
    feeder = DeviceFeeder(lambda: iter([{"img_u8": raw}]), main, exe,
                          workers=1)
    fed = list(feeder)
    assert len(fed) == 1 and fed[0]["img_u8"].dtype == torch.uint8
    pout, = exe.run(main, feed=fed[0], fetch_list=[img])
    assert pout.dtype == np.float32
    np.testing.assert_array_equal(pout, np.asarray(jout))



def test_one_shot_engine_on_a_resnet_equals_executor_run():
    """from_program on resnet_cifar10 (depth 8) on the CPU: the served
    probabilities equal Executor.run on the test clone, bitwise, and the
    running stats stay as they were."""
    main, startup, probs = _resnet_infer(pt, "resnet_cifar10", depth=8)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    # one run in training mode moves the stats off their initial values
    exe.run(main, feed={"img": _images(4, 4)}, fetch_list=[probs],
            scope=scope)
    stats = {n: t.clone() for n, t in scope.vars.items()
             if ".mean" in n or ".var" in n}
    assert len(stats) == 18
    engine = InferenceEngine.from_program(
        main, ["img"], [probs], executor=exe, scope=scope,
        config=EngineConfig(max_batch_size=4, batch_timeout_ms=0))
    try:
        x = _images(5, 3)
        served = engine.infer({"img": x}, timeout=60)
    finally:
        engine.shutdown()
    want, = exe.run(main.clone(for_test=True), feed={"img": x},
                    fetch_list=[probs], scope=scope)
    np.testing.assert_array_equal(np.asarray(served[0]), want)
    for n, t in stats.items():
        assert torch.equal(scope.get(n), t), n


def test_quant_conv2d_matches_the_reference():
    """The inference program of resnet_cifar10 (depth 8), pruned and
    quantized by each package: the same rewritten Program, bitwise the
    same int8 filters and scales, and probabilities within 1e-5 (both
    dequantize each filter and run the f32 conv)."""
    res = [_resnet_infer(P, "resnet_cifar10", depth=8) for P in (jpt, pt)]
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(res[0][1], scope=jscope)
    init = {k: np.array(jscope.get(k)) for k in jscope.keys()
            if not k.startswith("__")}
    jinfer = jpt.io._prune_for_inference(res[0][0], ["img"],
                                         [res[0][2].name])
    pinfer = pt.io._prune_for_inference(res[1][0], ["img"],
                                        [res[1][2].name])
    jq, jqs, _ = jpt.quant.quantize_program(jinfer, jscope, min_elements=1)
    pq, pqs, _ = pt.quant.quantize_program(pinfer,
                                           scope_from_numpy(init, "cpu"),
                                           min_elements=1)
    assert pq.to_dict() == jq.to_dict()
    types = [op.type for op in pq.global_block().ops]
    assert types.count("quant_conv2d") == 9 and "conv2d" not in types
    int8 = [n for n in jqs.keys() if str(np.asarray(jqs.get(n)).dtype)
            == "int8"]
    assert len(int8) == 10                  # 9 filters and the fc weight
    for n in jqs.keys():
        if n in int8 or n.endswith("@QSCALE"):
            np.testing.assert_array_equal(pqs.get(n).numpy(),
                                          np.asarray(jqs.get(n)), n)
    x = _images(6, 4)
    jp, = jexe.run(jq, feed={"img": x}, fetch_list=[res[0][2].name],
                   scope=jqs)
    pp, = pt.Executor(pt.CPUPlace()).run(pq, feed={"img": x},
                                         fetch_list=[res[1][2].name],
                                         scope=pqs)
    np.testing.assert_allclose(pp, np.asarray(jp), rtol=0, atol=1e-5)
