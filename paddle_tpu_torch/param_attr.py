"""ParamAttr: per-parameter configuration (the port's copy of
`paddle_tpu/param_attr.py`, with the update hooks and the sharding hint
and without the per-parameter learning rate, which no ported path
reads)."""

from __future__ import annotations

from .initializer import Initializer


class HookAttribute:
    """Parameter-updater hook spec. type="pruning" applies a static
    magnitude mask: the smallest `sparsity_ratio` fraction of the
    initialised weights is zeroed and kept zero through every update
    (the optimizer's `_append_update_hooks`)."""

    def __init__(self, type="pruning", sparsity_ratio=0.6):
        if type != "pruning":
            raise ValueError(f"unknown update hook type {type!r} "
                             "(the reference ships only 'pruning')")
        if not 0.0 <= float(sparsity_ratio) < 1.0:
            raise ValueError("sparsity_ratio must be in [0, 1)")
        self.type = type
        self.sparsity_ratio = float(sparsity_ratio)


class ParamAttr:
    def __init__(self, name=None, initializer=None, regularizer=None,
                 trainable=True, gradient_clip=None, sharding=None,
                 update_hooks=None):
        self.name = name
        self.initializer = initializer
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        if update_hooks is not None and not isinstance(update_hooks,
                                                       (list, tuple)):
            update_hooks = [update_hooks]
        self.update_hooks = list(update_hooks or [])
        # optional tuple of mesh axis names / None per dim: how the
        # reference partitions this parameter (an EP vocab-sharded
        # table). One card has no mesh; the hint is kept on the
        # Variable, and the sparse-gradient dispatch reads it.
        self.sharding = sharding

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
