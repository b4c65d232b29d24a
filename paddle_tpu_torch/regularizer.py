"""Weight-decay regularizers appended onto gradients (the port's copy of
`paddle_tpu/regularizer.py`, L2 and L1 decay: `minimize` calls
`append_regularization_ops` on every (param, grad) pair)."""

from __future__ import annotations

from .framework import unique_name


class WeightDecayRegularizer:
    def append_ops(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_ops(self, param, grad, block):
        decay = block.create_var(name=unique_name(param.name + "@L2DECAY"),
                                 shape=param.shape, dtype=param.dtype)
        block.append_op("scale", {"X": [param.name]}, {"Out": [decay.name]},
                        {"scale": self.coeff}, infer_shape=False)
        out = block.create_var(name=unique_name(grad.name + "@REG"),
                               shape=grad.shape, dtype=grad.dtype)
        block.append_op("sum", {"X": [grad.name, decay.name]},
                        {"Out": [out.name]}, {}, infer_shape=False)
        return out


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_ops(self, param, grad, block):
        sign = block.create_var(name=unique_name(param.name + "@SIGN"),
                                shape=param.shape, dtype=param.dtype)
        block.append_op("sign", {"X": [param.name]}, {"Out": [sign.name]},
                        {}, infer_shape=False)
        decay = block.create_var(name=unique_name(param.name + "@L1DECAY"),
                                 shape=param.shape, dtype=param.dtype)
        block.append_op("scale", {"X": [sign.name]}, {"Out": [decay.name]},
                        {"scale": self.coeff}, infer_shape=False)
        out = block.create_var(name=unique_name(grad.name + "@REG"),
                               shape=grad.shape, dtype=grad.dtype)
        block.append_op("sum", {"X": [grad.name, decay.name]},
                        {"Out": [out.name]}, {}, infer_shape=False)
        return out


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for param, grad in params_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if reg is None:
            out.append((param, grad))
            continue
        block = grad.block
        out.append((param, reg.append_ops(param, grad, block)))
        block.program.bump()
    return out



# fluid-compatible aliases
L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
