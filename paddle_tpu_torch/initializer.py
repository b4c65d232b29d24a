"""Initializers appended as ops into the startup program.

The port's copy of `paddle_tpu/initializer.py`: an initializer is an op
written into the startup program (fill_constant, uniform_random,
gaussian_random, truncated_gaussian_random), so the program text matches
the JAX package's and initialisation runs on the executor's device. The
random ops draw from the executor's `torch.Generator` (seeded from
`Program.seed`), so their values differ from the JAX package's threefry
streams; carry a JAX scope across (`weights.scope_from_numpy`) where the
values must match.
"""

from __future__ import annotations

import math

import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", {}, {"Out": [var.name]},
                        {"shape": list(var.shape), "dtype": var.dtype,
                         "value": float(self.value)}, infer_shape=False)


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op("uniform_random", {}, {"Out": [var.name]},
                        {"shape": list(var.shape), "dtype": var.dtype,
                         "min": float(self.low), "max": float(self.high),
                         "seed": self.seed}, infer_shape=False)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("gaussian_random", {}, {"Out": [var.name]},
                        {"shape": list(var.shape), "dtype": var.dtype,
                         "mean": float(self.loc), "std": float(self.scale),
                         "seed": self.seed}, infer_shape=False)


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("truncated_gaussian_random", {}, {"Out": [var.name]},
                        {"shape": list(var.shape), "dtype": var.dtype,
                         "mean": float(self.loc), "std": float(self.scale),
                         "seed": self.seed}, infer_shape=False)


def _fans(var):
    shape = var.shape
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) >= 3:
        receptive = int(np.prod(shape[2:]))
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    else:
        fan_in = fan_out = int(np.prod(shape))
    return fan_in, fan_out


class XavierInitializer(Initializer):
    """Glorot init (fluid initializer.py XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out = fan_in, fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)

