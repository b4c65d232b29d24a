"""ParamAttr: per-parameter configuration (the port's copy of
`paddle_tpu/param_attr.py`, without the per-parameter learning rate,
the update hooks and the sharding hint, which no ported path reads)."""

from __future__ import annotations

from .initializer import Initializer


class ParamAttr:
    def __init__(self, name=None, initializer=None, regularizer=None,
                 trainable=True, gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else None
        raise TypeError(f"cannot interpret {arg!r} as ParamAttr")
