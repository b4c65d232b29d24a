"""Generic gradient lowering via a per-op autograd tape.

The port's counterpart of `paddle_tpu/ops/grad.py`, where the executor
tapes `jax.vjp` of a forward op's lowering and the `<type>_grad` op
replays the closure. Here `lower_with_tape` runs the forward lowering
under `torch.enable_grad` on detached inputs that require grad and keeps
(inputs, outputs); `lower_grad_op` calls `torch.autograd.grad` from the
kept outputs with the grad op's cotangents. Each op's graph is its own:
the executor stores detached outputs in its env, so autograd never
chains across ops, and the grad op frees its entry's graph (the eager
counterpart of XLA freeing a residual after its last use).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TapeEntry(NamedTuple):
    ins: dict          # slot -> [input tensors as lowered (leaves)]
    outs: dict         # slot -> [output tensors, graph attached]


def filtered_inputs(op):
    """Drop empty slots/names — optional inputs a layer chose not to wire."""
    return {slot: [n for n in names if n]
            for slot, names in op.inputs.items()
            if any(n for n in names)}


def _leaf(t):
    """Detached input; floating tensors require grad so the tape can
    differentiate with respect to them (integer ids and labels cannot)."""
    if not isinstance(t, torch.Tensor):
        return t
    leaf = t.detach()
    if leaf.is_floating_point():
        leaf.requires_grad_(True)
    return leaf


def lower_with_tape(ctx, op, opdef, ins, attrs):
    """Lower a forward op under autograd and tape (inputs, outputs);
    returns the outputs detached, for the executor's env.

    Mixed precision: the amp cast is applied to the leaves INSIDE the
    taped graph, so autograd differentiates through it and gradients
    return in the ORIGINAL input dtypes — an f32 master weight gets an
    f32 gradient (the bf16 one upcast by the cast's backward), not a
    bf16-quantized one, as the reference's vjp through `astype` does.
    """
    leaves = {slot: [_leaf(t) for t in vals] for slot, vals in ins.items()}
    with torch.enable_grad():
        cast = leaves
        if ctx.amp_dtype is not None:
            from ..amp import cast_ins
            cast = cast_ins(op.type, leaves, ctx.amp_dtype)
        outs = opdef.lowering(ctx, cast, dict(attrs))
    ctx.tape[op.id] = TapeEntry(leaves, outs)
    return {slot: [t.detach() if isinstance(t, torch.Tensor) else t
                   for t in vals] for slot, vals in outs.items()}


def _grad_hook(ctx, op, fwd_id):
    """The forward op's registered `grad` hook's result, stored into the
    env under the grad op's output names; None when the op has no hook
    or the hook declines."""
    from . import registry
    base = op.type[:-len("_grad")]
    hook = registry.get_op(base).grad if registry.has_op(base) else None
    if hook is None:
        return None
    fwd_op = next((o for o in ctx.block.ops if o.id == fwd_id), None)
    results = hook(ctx, fwd_op, op)
    if results is None:
        return None
    for slot, names in op.outputs.items():
        for name, val in zip(names, results.get(slot, ())):
            if name:
                ctx.env[name] = val
    return results


def lower_grad_op(ctx, op):
    """Lower a `<type>_grad` op by replaying the taped graph.

    IR contract (written by backward.append_backward):
      attrs.fwd_op_id       — id of the forward Operator
      inputs  "<slot>@GRAD" — incoming grad var names aligned positionally
                              with the forward op's *output* slot <slot>
                              ("" where no grad flows)
      outputs "<slot>@GRAD" — produced grad var names aligned positionally
                              with the forward op's filtered *input* slot
                              <slot> ("" where not needed)

    An output with no incoming grad, and an integer output (which JAX
    gives a float0 cotangent), contributes nothing: it is left out of
    the `autograd.grad` call, which is the same as a zero cotangent.

    A forward op registered with a `grad=` hook gets it first (the
    reference's :116-135): values it returns become the grad op's
    outputs, and the taped graph is freed unused; None falls back to
    the tape.
    """
    fwd_id = op.attrs["fwd_op_id"]
    results = _grad_hook(ctx, op, fwd_id)
    if results is not None:
        ctx.tape.pop(fwd_id, None)
        return results
    entry = ctx.tape.pop(fwd_id, None)
    if entry is None:
        raise RuntimeError(
            f"grad op {op.type} references forward op id {fwd_id} which was "
            "not taped — grad ops must appear after their forward op in the "
            "same program")

    outs, cots = [], []
    for slot, vals in entry.outs.items():
        grad_names = op.inputs.get(slot + "@GRAD", [])
        for i, o in enumerate(vals):
            name = grad_names[i] if i < len(grad_names) else ""
            if (name and isinstance(o, torch.Tensor) and o.requires_grad
                    and o.is_floating_point()):
                outs.append(o)
                cots.append(ctx.lookup(name).to(o.dtype))

    wanted = []          # (grad var name, input leaf)
    for slot, leaves in entry.ins.items():
        out_names = op.outputs.get(slot + "@GRAD", [])
        for i, leaf in enumerate(leaves):
            gname = out_names[i] if i < len(out_names) else ""
            if not gname:
                continue
            if not (isinstance(leaf, torch.Tensor) and leaf.requires_grad):
                raise RuntimeError(
                    f"{op.type}: grad {gname!r} requested for the "
                    f"non-differentiable input {slot}[{i}]")
            wanted.append((gname, leaf))

    grads = [None] * len(wanted)
    if outs and wanted:
        grads = torch.autograd.grad(outs, [leaf for _, leaf in wanted],
                                    cots, allow_unused=True)
    results = {}
    for (gname, leaf), g in zip(wanted, grads):
        if g is None:                 # the input did not reach an output
            g = torch.zeros_like(leaf)
        ctx.env[gname] = g
        results.setdefault(gname, g)
    return results
