"""append_backward: program-level reverse-mode autodiff.

The port's copy of `paddle_tpu/backward.py`, unchanged in what it
writes: walks the forward ops in reverse, appends one `<type>_grad` op
per contributing forward op (carrying `fwd_op_id`), and inserts `sum`
ops where a variable receives gradient from several consumers — so the
two packages emit the same grad program. The executor replays each grad
op from its forward op's autograd tape (ops/grad.py).
"""

from __future__ import annotations

from .framework import Variable, grad_var_name, unique_name
from .ops.grad import filtered_inputs
from .ops.registry import get_op, has_op


def _is_float(var):
    return var is not None and var.dtype in (
        "float16", "bfloat16", "float32", "float64")


def _find_contributing(block, loss_name, no_grad_set):
    """Reverse reachability: which ops/vars are on a grad path to the loss."""
    need = {loss_name}
    contributing = []
    for op in reversed(block.ops):
        if not any(n in need for names in op.outputs.values() for n in names):
            continue
        if op.type.endswith("_grad"):
            continue
        if has_op(op.type) and not get_op(op.type).differentiable:
            continue
        contributing.append(op)
        for names in filtered_inputs(op).values():
            for n in names:
                var = block._find_var(n)
                if (n not in no_grad_set and _is_float(var)
                        and not (var is not None and var.stop_gradient)):
                    need.add(n)
    contributing.reverse()
    return contributing, need


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None):
    """Append grad ops computing d(loss)/d(param) for every trainable param.

    Returns [(param, grad_var)] like the reference (backward.py:338).
    """
    params_and_grads, _ = _append_backward_impl(loss, parameter_list,
                                                no_grad_set)
    return params_and_grads


def _append_backward_impl(loss, parameter_list=None, no_grad_set=None):
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())

    contributing, need = _find_contributing(block, loss.name, no_grad)

    # Seed: d loss / d loss = ones(loss.shape).
    loss_grad = block.create_var(
        name=grad_var_name(loss.name), shape=loss.shape, dtype=loss.dtype)
    block.append_op(
        "fill_constant", {}, {"Out": [loss_grad.name]},
        {"shape": list(loss.shape), "value": 1.0, "dtype": loss.dtype},
        infer_shape=False)

    grad_map = {loss.name: loss_grad.name}

    def accumulate(var_name, new_grad_name):
        if var_name not in grad_map:
            grad_map[var_name] = new_grad_name
            return
        old = grad_map[var_name]
        acc_name = unique_name(grad_var_name(var_name) + "@ACC")
        src = block.var(new_grad_name)
        block.create_var(name=acc_name, shape=src.shape, dtype=src.dtype)
        block.append_op("sum", {"X": [old, new_grad_name]},
                        {"Out": [acc_name]}, {}, infer_shape=False)
        grad_map[var_name] = acc_name

    for op in reversed(contributing):
        fwd_ins = filtered_inputs(op)
        grad_inputs = {}
        has_any = False
        for slot, names in op.outputs.items():
            gnames = []
            for n in names:
                g = grad_map.get(n, "")
                if g:
                    has_any = True
                gnames.append(g)
            if any(gnames):
                grad_inputs[slot + "@GRAD"] = gnames
        if not has_any:
            continue

        grad_outputs = {}
        produced = []  # (input var name, grad var name)
        for slot, names in fwd_ins.items():
            gnames = []
            for n in names:
                var = block._find_var(n)
                if (n in need and n not in no_grad and _is_float(var)
                        and not var.stop_gradient):
                    gname = unique_name(grad_var_name(n))
                    block.create_var(name=gname, shape=var.shape,
                                     dtype=var.dtype)
                    gnames.append(gname)
                    produced.append((n, gname))
                else:
                    gnames.append("")
            if any(gnames):
                grad_outputs[slot + "@GRAD"] = gnames

        if not grad_outputs:
            continue

        block.append_op(op.type + "_grad", grad_inputs, grad_outputs,
                        {"fwd_op_id": op.id}, infer_shape=False)
        for var_name, gname in produced:
            accumulate(var_name, gname)

    program.bump()

    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]

    params_and_grads = []
    for p in params:
        g = grad_map.get(p.name)
        if g is None:
            continue
        params_and_grads.append((p, block.var(g)))
    return params_and_grads, grad_map


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Grad of targets w.r.t. arbitrary inputs (fluid backward.py:464)."""
    if isinstance(targets, Variable):
        targets = [targets]
    if isinstance(inputs, Variable):
        inputs = [inputs]
    assert len(targets) == 1, "calc_gradient currently supports one target"
    _, grad_map = _append_backward_impl(targets[0], parameter_list=None,
                                        no_grad_set=no_grad_set)
    block = targets[0].block
    return [block.var(grad_map[v.name]) if v.name in grad_map else None
            for v in inputs]
