"""v2 activation objects (reference python/paddle/v2/activation.py →
trainer_config_helpers/activations.py). Each maps to an activation op."""

__all__ = ["Tanh", "Sigmoid", "Softmax", "Relu", "BRelu", "SoftRelu",
           "STanh", "Linear", "Identity", "Square", "Exp", "Log", "Abs"]


class _Act:
    op_type = None

    def __repr__(self):
        return f"activation.{type(self).__name__}()"


def _make(name, op):
    return type(name, (_Act,), {"op_type": op})


Tanh = _make("Tanh", "tanh")
Sigmoid = _make("Sigmoid", "sigmoid")
Softmax = _make("Softmax", "softmax")
Relu = _make("Relu", "relu")
BRelu = _make("BRelu", "brelu")
SoftRelu = _make("SoftRelu", "softplus")
STanh = _make("STanh", "tanh")
Square = _make("Square", "square")
Exp = _make("Exp", "exp")
Log = _make("Log", "log")
Abs = _make("Abs", "abs")


class Linear(_Act):
    op_type = None   # identity


Identity = Linear
