"""Optimizer op lowerings (the port of `sgd` and `adam` from
`paddle_tpu/ops/optimizer_ops.py`).

The reference's update ops are pure functions whose state buffers the
executor donates, so XLA updates them in place in HBM. Here each update
runs in place on the scope's own tensors under `torch.no_grad`
(`ParamOut` is `Param`, `Moment1Out` is `Moment1`, ...): the same
memory behaviour, with no second copy of any parameter or moment. The
ops run after every grad op of the step, so no taped graph still needs
the old values. The arithmetic is the reference's, in float32.
"""

from __future__ import annotations

import torch

from .registry import register_op


@register_op("sgd", differentiable=False, is_optimizer=True)
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    with torch.no_grad():
        p.sub_(lr * g)
    return {"ParamOut": [p]}


@register_op("adam", differentiable=False, is_optimizer=True)
def _adam(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    lr = ins["LearningRate"][0].reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    with torch.no_grad():
        b1p.mul_(b1)
        b2p.mul_(b2)
        lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
        m1.mul_(b1).add_((1 - b1) * g)
        m2.mul_(b2).add_((1 - b2) * g.square())
        p.sub_(lr_t * m1 / (m2.sqrt() + eps))
    return {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
            "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]}
