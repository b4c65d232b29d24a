"""Gradient clipping (the port's copy of `paddle_tpu/clip.py`: by value,
by norm and by global norm). `append_gradient_clip_ops` applies a
parameter's `gradient_clip` attr (`ParamAttr(gradient_clip=...)`) or
the process-wide `set_gradient_clip(...)` to the gradients; a global
`GradientClipByGlobalNorm` scales every gradient by
clip_norm / max(global_norm, clip_norm)."""

from __future__ import annotations

from .framework import unique_name


class BaseGradientClipAttr:
    def create_ops(self, param, grad, block):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def create_ops(self, param, grad, block):
        out = block.create_var(name=unique_name(grad.name + "@CLIP"),
                               shape=grad.shape, dtype=grad.dtype)
        block.append_op("clip", {"X": [grad.name]}, {"Out": [out.name]},
                        {"min": float(self.min), "max": float(self.max)},
                        infer_shape=False)
        return out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def create_ops(self, param, grad, block):
        out = block.create_var(name=unique_name(grad.name + "@CLIP"),
                               shape=grad.shape, dtype=grad.dtype)
        block.append_op("clip_by_norm", {"X": [grad.name]},
                        {"Out": [out.name]},
                        {"max_norm": float(self.clip_norm)},
                        infer_shape=False)
        return out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scales all grads by clip_norm/max(global_norm, clip_norm).

    Set via `set_gradient_clip` or per-param attr, applied in
    append_gradient_clip_ops over the whole group like the reference.
    """

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def create_group_ops(self, params_grads, block):
        sq_names = []
        for _, grad in params_grads:
            sq = block.create_var(name=unique_name(grad.name + "@SQ"),
                                  shape=grad.shape, dtype=grad.dtype)
            block.append_op("square", {"X": [grad.name]}, {"Out": [sq.name]},
                            {}, infer_shape=False)
            ssum = block.create_var(name=unique_name(grad.name + "@SSUM"),
                                    shape=(1,), dtype=grad.dtype)
            block.append_op("reduce_sum", {"X": [sq.name]},
                            {"Out": [ssum.name]}, {"reduce_all": True},
                            infer_shape=False)
            sq_names.append(ssum.name)
        total = block.create_var(name=unique_name("global_norm_sq"),
                                 shape=(1,), dtype=params_grads[0][1].dtype)
        block.append_op("sum", {"X": sq_names}, {"Out": [total.name]}, {},
                        infer_shape=False)
        gnorm = block.create_var(name=unique_name("global_norm"),
                                 shape=(1,), dtype=total.dtype)
        block.append_op("sqrt", {"X": [total.name]}, {"Out": [gnorm.name]},
                        {}, infer_shape=False)
        # scale = clip_norm / max(gnorm, clip_norm)
        denom = block.create_var(name=unique_name("global_norm_max"),
                                 shape=(1,), dtype=gnorm.dtype)
        cn = block.create_var(name=unique_name("clip_norm_const"),
                              shape=(1,), dtype=gnorm.dtype)
        block.append_op("fill_constant", {}, {"Out": [cn.name]},
                        {"shape": [1], "dtype": gnorm.dtype,
                         "value": float(self.clip_norm)}, infer_shape=False)
        block.append_op("elementwise_max", {"X": [gnorm.name], "Y": [cn.name]},
                        {"Out": [denom.name]}, {}, infer_shape=False)
        scale = block.create_var(name=unique_name("clip_scale"),
                                 shape=(1,), dtype=gnorm.dtype)
        block.append_op("elementwise_div", {"X": [cn.name], "Y": [denom.name]},
                        {"Out": [scale.name]}, {}, infer_shape=False)
        out = []
        for param, grad in params_grads:
            clipped = block.create_var(name=unique_name(grad.name + "@CLIP"),
                                       shape=grad.shape, dtype=grad.dtype)
            block.append_op("elementwise_mul",
                            {"X": [grad.name], "Y": [scale.name]},
                            {"Out": [clipped.name]}, {}, infer_shape=False)
            out.append((param, clipped))
        return out


_global_clip = None


def set_gradient_clip(clip):
    global _global_clip
    _global_clip = clip


def append_gradient_clip_ops(params_grads):
    if not params_grads:
        return params_grads
    block = params_grads[0][1].block
    if isinstance(_global_clip, GradientClipByGlobalNorm):
        out = _global_clip.create_group_ops(params_grads, block)
        block.program.bump()
        return out
    out = []
    changed = False
    for param, grad in params_grads:
        clip = getattr(param, "gradient_clip", None) or _global_clip
        if clip is None:
            out.append((param, grad))
        else:
            out.append((param, clip.create_ops(param, grad, block)))
            changed = True
    if changed:
        block.program.bump()
    return out


# fluid spelling
ErrorClipByValue = GradientClipByValue
