"""Gradient clipping: the part of `paddle_tpu/clip.py` that `minimize`
reaches. `append_gradient_clip_ops` applies a parameter's
`gradient_clip` attr (`ParamAttr(gradient_clip=...)`) to its gradient;
the port carries clip-by-value, the one clip whose op (`clip`) it
lowers, and not the global `set_gradient_clip` setting."""

from __future__ import annotations

from .framework import unique_name


class GradientClipByValue:
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


def append_gradient_clip_ops(params_grads):
    if not params_grads:
        return params_grads
    block = params_grads[0][1].block
    out = []
    changed = False
    for param, grad in params_grads:
        clip = getattr(param, "gradient_clip", None)
        if clip is None:
            out.append((param, grad))
        else:
            out.append((param, clip.create_ops(param, grad, block)))
            changed = True
    if changed:
        block.program.bump()
    return out
