"""Block-based control-flow op lowerings: while / ifelse / switch / the
tensor arrays.

The port of `paddle_tpu/ops/control_flow_ops.py`. The reference lowers a
sub-block once, at trace time, into `lax.while_loop` or masked
`jnp.where`; here the executor interprets a sub-block's ops each time
the op runs (`lower_block`), into an overlay env over the bindings the
op was given:

  * `while` is a Python loop. It reads its condition on the host once an
    iteration (a device sync, counted under the monitor counter
    `control_flow.host_syncs`) and honours `max_iters`. Its loop vars
    (the ancestor vars the body writes) carry from one iteration to the
    next; the body's random ops draw from the executor's generator, a
    fresh draw each iteration, as the reference threads its key through
    the loop carry.
  * `ifelse` runs BOTH branches on the full batch and merges rows with
    `torch.where` on the condition mask, as the reference does; so the
    branches must be row-wise (`_check_rowwise_branch`). Taped, the
    branches' ops build the enclosing op's autograd graph, and gradients
    reach the captured vars, masked.
  * `switch` (scalar conditions, the piecewise learning rates) runs
    every case block and keeps the first true case's values.
  * The tensor arrays are fixed-capacity `[max_len, ...]` tensors read
    and written at a device index. The reference's
    `lax.dynamic_index_in_dim` / `dynamic_update_index_in_dim` wrap a
    negative index once (i + max_len) and clamp the result to
    [0, max_len - 1]; torch index ops raise (CPU) or trip a device-side
    assert (CUDA) out of range, so `_array_index` computes the same
    clamp on the device, and the index is never read on the host.

Capture contract (set up by layers/control_flow.py): every variable a
sub-block reads from an ancestor block is declared in the op's `X`
input slot with its name mirrored in `attrs["x_names"]`; the lowering
binds `ins["X"]` to those names, so the autograd tape sees them as the
op's inputs.

Shape inference on meta tensors (ops/registry.py) cannot read a
condition: on the meta device `while` gives its loop vars as they are
(shapes are static across iterations).
"""

from __future__ import annotations

import torch

from .registry import LoweringContext, register_op, sub_block_idxs

_NO_TAPE = frozenset()


class _SubCtx(LoweringContext):
    """The lowering context of a sub-block's ops: an overlay env over the
    enclosing op's bindings, the parent's device, generator, amp policy
    and test mode. Its ops write new tensors (`in_place` False), never a
    binding of the parent in place, and run in the grad mode of the op
    that encloses them (`sub_block`, executor.py `_lower_op`)."""

    sub_block = True

    def __init__(self, parent, block, env):
        super().__init__(parent.program, block, env, parent.device,
                         generator=parent.generator, in_place=False)
        self.amp_dtype = parent.amp_dtype
        self.is_test = parent.is_test


def lower_block(parent_ctx, block_idx, env):
    """Lower every op of sub-block `block_idx` into `env`; returns the
    child context. While a device profile is active each op runs inside
    its own "<block>/<idx>:<op_type>" scope, nested under the enclosing
    op's scope, so a body's kernels are attributed to its own ops."""
    from ..executor import Executor
    from ..monitor import deviceprof
    block = parent_ctx.program.blocks[block_idx]
    ctx = _SubCtx(parent_ctx, block, env)
    scoped = deviceprof.scopes_active()
    for op_idx, op in enumerate(block.ops):
        if scoped:
            with torch.profiler.record_function(
                    deviceprof.op_scope(block.idx, op_idx, op.type)):
                Executor._lower_op(ctx, op, _NO_TAPE)
        else:
            Executor._lower_op(ctx, op, _NO_TAPE)
    return ctx


@register_op("while", differentiable=False)
def _while(ctx, ins, attrs):
    from .. import monitor
    x_names = list(attrs["x_names"])
    loop_vars = list(attrs["loop_vars"])
    cond_name = attrs["cond"]
    max_iters = attrs.get("max_iters", 0)

    base_env = dict(zip(x_names, ins.get("X", [])))
    vals = [base_env[n] if n in base_env else ctx.lookup(n)
            for n in loop_vars]
    if ctx.device.type == "meta":
        return {"Out": vals}
    cond = ctx.lookup(cond_name)
    it = 0
    while not (max_iters and it >= max_iters):
        # the reference's while_op.cc takes a [1] bool condition; any
        # shape is reduced with `all`, as the reference's lowering does
        monitor.counter_inc("control_flow.host_syncs")
        if not bool(torch.all(cond)):
            break
        env = dict(base_env)
        env.update(zip(loop_vars, vals))
        lower_block(ctx, attrs["sub_block"], env)
        vals = [env[n] for n in loop_vars]
        cond = env[cond_name]
        it += 1
    return {"Out": vals}


def _check_rowwise_branch(ctx, block_idx, which):
    """ifelse's run-both-and-mask formulation is only correct when each
    branch treats batch rows independently. Ops that MIX rows (whole-
    tensor reductions, batch-dim reductions, train-mode batch norm)
    would silently see the padded full batch instead of the selected
    sub-batch — reject them loudly (the reference's rule, word for
    word)."""
    program = ctx.program
    for op in program.blocks[block_idx].ops:
        bad = None
        if op.type == "mean":
            bad = "mean reduces over the batch"
        elif op.type.startswith("reduce_"):
            dim = op.attrs.get("dim")
            dims = ([] if dim is None
                    else (list(dim) if isinstance(dim, (list, tuple))
                          else [dim]))
            if not dims or op.attrs.get("reduce_all"):
                bad = f"{op.type} reduces over every axis"
            elif 0 in dims:
                bad = f"{op.type} reduces over the batch dim"
            elif any(d < 0 for d in dims):
                # normalise negatives against the input's rank when the
                # block knows it; an unknown rank is rejected
                xvar = program.blocks[block_idx]._find_var(
                    op.inputs.get("X", [""])[0])
                rank = (len(xvar.shape) if xvar is not None
                        and xvar.shape is not None else None)
                if rank is None:
                    bad = (f"{op.type} uses negative dims {dims} whose "
                           "rank is unknown here — use non-negative dims")
                elif any(d % rank == 0 for d in dims):
                    bad = f"{op.type} reduces over the batch dim"
        elif op.type == "batch_norm" and not (
                op.attrs.get("is_test") or ctx.is_test):
            bad = "train-mode batch_norm computes cross-row statistics"
        elif op.type == "accuracy":
            bad = "accuracy aggregates over the batch"
        if bad:
            raise NotImplementedError(
                f"ifelse {which} branch contains op {op.type!r}: {bad}, "
                "but ifelse lowers to run-both-branches + row mask, so "
                "cross-row ops would see unselected rows. Move the "
                "aggregation outside the ifelse (compute row-wise values "
                "in the branches, reduce after the merge).")
        for sub_idx in sub_block_idxs(op):
            _check_rowwise_branch(ctx, sub_idx, which)


@register_op("ifelse")
def _ifelse(ctx, ins, attrs):
    _check_rowwise_branch(ctx, attrs["true_block"], "true")
    _check_rowwise_branch(ctx, attrs["false_block"], "false")
    cond = ins["Cond"][0]
    base_env = dict(zip(attrs["x_names"], ins.get("X", [])))
    env_t = dict(base_env)
    lower_block(ctx, attrs["true_block"], env_t)
    env_f = dict(base_env)
    lower_block(ctx, attrs["false_block"], env_f)

    # squeeze the condition to [N] first, then broadcast it over each
    # output's trailing dims: a [N, 1] cond against a 1-D [N] output
    # must not outer-broadcast to [N, N]
    row_mask = cond.to(torch.bool).reshape(cond.shape[0])
    outs = []
    for tn, fn in zip(attrs["true_outs"], attrs["false_outs"]):
        tv, fv = env_t[tn], env_f[fn]
        if tv.shape != fv.shape:
            raise ValueError(
                f"ifelse branch outputs {tn!r} {tuple(tv.shape)} and {fn!r} "
                f"{tuple(fv.shape)} must have equal (static) shapes")
        mask = row_mask.reshape((-1,) + (1,) * (tv.dim() - 1))
        outs.append(torch.where(mask, tv, fv))
    return {"Out": outs}


@register_op("switch")
def _switch(ctx, ins, attrs):
    conds = ins.get("Cond", [])
    base_env = dict(zip(attrs["x_names"], ins.get("X", [])))
    case_envs = []
    for idx in attrs["case_blocks"]:
        env = dict(base_env)
        lower_block(ctx, idx, env)
        case_envs.append(env)
    default_block = attrs.get("default_block", -1)
    if default_block >= 0:
        denv = dict(base_env)
        lower_block(ctx, default_block, denv)
    else:
        denv = base_env

    outs = []
    for name in attrs["out_names"]:
        # no default branch wrote it: keep the var's current value
        acc = denv[name] if name in denv else ctx.lookup(name)
        # first true wins: fold the cases in reverse, so that earlier
        # cases override later ones
        for cond, env in zip(reversed(conds), reversed(case_envs)):
            acc = torch.where(torch.all(cond), env[name], acc)
        outs.append(acc)
    return {"Out": outs}


def _array_index(i, capacity):
    """The array slot of index tensor `i` (any shape of one element), on
    the device: a negative index wraps once, then the result is clamped
    to [0, capacity - 1], as `lax.dynamic_index_in_dim` does (ROADMAP
    C18). No value is read on the host."""
    idx = i.reshape(-1)[:1].to(torch.int64)
    idx = torch.where(idx < 0, idx + capacity, idx)
    return idx.clamp(0, capacity - 1)


@register_op("array_write")
def _array_write(ctx, ins, attrs):
    arr, x = ins["Array"][0], ins["X"][0]
    idx = _array_index(ins["I"][0], arr.shape[0])
    return {"Out": [torch.index_copy(arr, 0, idx,
                                     x.to(arr.dtype).unsqueeze(0))]}


@register_op("array_read")
def _array_read(ctx, ins, attrs):
    arr = ins["Array"][0]
    idx = _array_index(ins["I"][0], arr.shape[0])
    return {"Out": [torch.index_select(arr, 0, idx).squeeze(0)]}
