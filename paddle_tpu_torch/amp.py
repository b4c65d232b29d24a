"""Automatic mixed precision (bfloat16 compute, float32 master weights).

The port of `paddle_tpu/amp.py`. `amp.enable(program)` marks the program
and the executor casts at op boundaries, explicitly (no
`torch.autocast`), while parameters, optimizer state and normalization
statistics stay float32. One role table drives the casts:

  compute — matmul-class ops: f32 inputs cast DOWN to the amp dtype
            (weights included; master copies stay f32 in the scope), so
            the products take bf16 operands and accumulate in f32.
  follow  — elementwise glue (bias add, residual add): cast f32 operands
            down ONLY when another floating operand is already amp-typed,
            so bf16 activations flow through without promotion back to
            f32 between compute ops.
  f32     — numerically-sensitive ops (softmax, losses, means): amp
            inputs cast UP to f32.
Everything else runs in whatever dtype reaches it (layer_norm computes
its statistics in f32 internally).

Gradients: the executor applies the casts inside the per-op autograd
tape (ops/grad.py), so autograd differentiates through them and an f32
master weight gets an f32 gradient, upcast from the bf16 one, as the
reference's vjp through `astype` does; the optimizer ops apply f32
updates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import framework

__all__ = ["enable", "disable", "is_enabled", "amp_dtype_of", "cast_ins",
           "active_policy", "AmpPolicy", "ROLES"]


_COMPUTE = {
    "conv2d", "depthwise_conv2d", "conv2d_transpose", "mul", "matmul",
    "scaled_dot_product_attention", "transformer_stack", "sequence_conv",
    # the head matmul dominates; its loss math accumulates f32 inside
    # (chunked_ce.py preferred_element_type), so bf16 inputs are safe
    "fused_lm_head_xent",
}

_FOLLOW = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min", "sum",
    "concat",
}
# single-input ops (relu, pool2d, reshape...) need no entry: they run in
# whatever dtype reaches them

_F32 = {
    "softmax", "log_softmax", "softmax_with_cross_entropy",
    "cross_entropy", "sigmoid_cross_entropy_with_logits", "mean",
    "square_error_cost", "smooth_l1_loss", "huber_loss", "hinge_loss",
    "rank_loss", "reduce_mean", "reduce_sum", "accuracy",
    "linear_chain_crf", "sequence_softmax", "cos_sim", "l2_normalize",
    # recurrences carry hidden state across the scan — keep them f32
    # (their gate GEMMs still hit the MXU via bf16 passes)
    "gru", "lstm", "simple_rnn",
}

ROLES = {}
ROLES.update({t: "compute" for t in _COMPUTE})
ROLES.update({t: "follow" for t in _FOLLOW})
ROLES.update({t: "f32" for t in _F32})


def enable(program=None, dtype="bfloat16"):
    """Mark `program` for mixed-precision execution.

    Only bfloat16 is supported: it shares float32's exponent range, so
    the products' f32 reductions are overflow-safe without loss scaling.
    float16 would need loss scaling to be safe."""
    if dtype != "bfloat16":
        raise ValueError(f"amp dtype {dtype!r} unsupported: only bfloat16 "
                         "(TPU-native, overflow-safe without loss scaling)")
    program = program or framework.default_main_program()
    program._amp_dtype = dtype
    program.bump()
    return program


def disable(program=None):
    program = program or framework.default_main_program()
    program._amp_dtype = None
    program.bump()
    return program


def is_enabled(program=None):
    program = program or framework.default_main_program()
    return getattr(program, "_amp_dtype", None) is not None


def amp_dtype_of(program):
    """The torch dtype of the program's amp setting (or None)."""
    d = getattr(program, "_amp_dtype", None)
    if d is None:
        return None
    return getattr(torch, d)


class AmpPolicy(NamedTuple):
    """The program's resolved AMP policy: the compute dtype by name and
    as a torch dtype, and a snapshot of the op-role table."""
    dtype: str                 # "bfloat16"
    torch_dtype: torch.dtype   # torch.bfloat16
    roles: dict                # op type -> compute|follow|f32


def active_policy(program=None):
    """The active AMP policy of `program` (None when AMP is off)."""
    program = program or framework.default_main_program()
    d = getattr(program, "_amp_dtype", None)
    if d is None:
        return None
    return AmpPolicy(dtype=d, torch_dtype=amp_dtype_of(program),
                     roles=dict(ROLES))


def cast_ins(op_type, ins, amp_dtype):
    """Apply the role table to a lowering's input dict. Returns `ins`
    unchanged (same object) when no cast applies."""
    role = ROLES.get(op_type)
    if role is None:
        return ins
    f32 = torch.float32

    def is_f32(v):
        return getattr(v, "dtype", None) == f32

    def is_amp(v):
        return getattr(v, "dtype", None) == amp_dtype

    if role == "compute":
        cast, pred = amp_dtype, is_f32
    elif role == "f32":
        cast, pred = f32, is_amp
    else:  # follow: downcast f32 operands only if an amp operand exists
        if not any(is_amp(v) for vals in ins.values() for v in vals):
            return ins
        cast, pred = amp_dtype, is_f32

    if not any(pred(v) for vals in ins.values() for v in vals):
        return ins
    return {slot: [v.to(cast) if pred(v) else v for v in vals]
            for slot, vals in ins.items()}
