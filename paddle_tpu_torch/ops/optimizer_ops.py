"""Optimizer op lowerings (the port of `paddle_tpu/ops/optimizer_ops.py`).

The reference's update ops are pure functions whose state buffers the
executor donates, so XLA updates them in place in HBM. Here each update
runs in place on the scope's own tensors under `torch.no_grad`
(`ParamOut` is `Param`, `Moment1Out` is `Moment1`, ...): the same
memory behaviour, with no second copy of any parameter or moment. The
ops run after every grad op of the step, so no taped graph still needs
the old values.

Under the executor's NaN guard (`ctx.in_place` False) every update
writes new tensors instead and leaves its inputs as they were, so a
tripped step can leave the scope at its pre-step state: `sgd` and
`adam` run their in-place arithmetic on copies, the other ops return
their functional results. Either way the values are the same bits.

The arithmetic is the reference's, in float32 and in its order of
operations.

A SelectedRows gradient (an is_sparse lookup_table's, selected_rows.py)
takes the reference's sparse branches of `sgd`, `momentum`, `adam` and
`adagrad`: only the touched rows move, read with `index_select` and
written back with `index_copy_` (each row's new value computed from the
sum of all its gradient rows, so a duplicated row is written with the
same bits each time); Adam's bias correction stays global. Every index
is a real row. Under the NaN guard these write into copies of the
state, the table included. Every other update op gets the dense
gradient (the executor's `densify_ins`), as in the reference.
"""

from __future__ import annotations

import torch

from ..selected_rows import is_selected_rows, row_sums
from .registry import register_op


def _f32(x):
    return x.float()


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


def _out(ctx, dst, val):
    """The update's result for state var `dst`: written into the
    scope's tensor in place, or (under the NaN guard) a new tensor."""
    if ctx.in_place:
        return dst.copy_(val)
    return val.to(dst.dtype)


def _rows_out(ctx, dst, rows, val):
    """A sparse update's result for state var `dst`: `val` written at
    `rows`, into the scope's tensor in place or (under the NaN guard)
    into a copy of it."""
    if not ctx.in_place:
        dst = dst.clone()
    return dst.index_copy_(0, rows, val.to(dst.dtype))


@register_op("sgd", differentiable=False, is_optimizer=True)
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _lr(ins)
    if is_selected_rows(g):
        with torch.no_grad():
            rows, gsum = row_sums(g)
            p_row = _f32(p.index_select(0, rows)) - lr * gsum
            return {"ParamOut": [_rows_out(ctx, p, rows, p_row)]}
    with torch.no_grad():
        if not ctx.in_place:
            p = p.clone()
        p.sub_(lr * g)
    return {"ParamOut": [p]}


@register_op("momentum", differentiable=False, is_optimizer=True)
def _momentum(ctx, ins, attrs):
    p, v = ins["Param"][0], ins["Velocity"][0]
    g = ins["Grad"][0]
    lr = _lr(ins)
    mu = attrs.get("mu", 0.9)
    if is_selected_rows(g):
        with torch.no_grad():
            rows, gsum = row_sums(g)
            v_row = mu * _f32(v.index_select(0, rows)) + gsum
            upd = (gsum + mu * v_row if attrs.get("use_nesterov", False)
                   else v_row)
            p_row = _f32(p.index_select(0, rows)) - lr * upd
            return {"ParamOut": [_rows_out(ctx, p, rows, p_row)],
                    "VelocityOut": [_rows_out(ctx, v, rows, v_row)]}
    with torch.no_grad():
        v_out = mu * _f32(v) + _f32(g)
        if attrs.get("use_nesterov", False):
            p_out = _f32(p) - lr * (_f32(g) + mu * v_out)
        else:
            p_out = _f32(p) - lr * v_out
        return {"ParamOut": [_out(ctx, p, p_out)],
                "VelocityOut": [_out(ctx, v, v_out)]}


@register_op("adam", differentiable=False, is_optimizer=True)
def _adam(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    lr = _lr(ins)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    if is_selected_rows(g):
        return _sparse_adam(ctx, p, g, m1, m2, b1p, b2p, lr, b1, b2, eps)
    with torch.no_grad():
        if not ctx.in_place:
            p, m1, m2, b1p, b2p = (t.clone() for t in (p, m1, m2, b1p, b2p))
        b1p.mul_(b1)
        b2p.mul_(b2)
        lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
        m1.mul_(b1).add_((1 - b1) * g)
        m2.mul_(b2).add_((1 - b2) * g.square())
        p.sub_(lr_t * m1 / (m2.sqrt() + eps))
    return {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
            "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]}


def _sparse_adam(ctx, p, g, m1, m2, b1p, b2p, lr, b1, b2, eps):
    """Lazy sparse Adam (the reference's): the moments and the parameter
    move on the touched rows only; the beta powers, and so the bias
    correction, advance every step."""
    with torch.no_grad():
        b1po = _f32(b1p) * b1
        b2po = _f32(b2p) * b2
        lr_t = lr * torch.sqrt(1 - b2po.reshape(())) / (1 - b1po.reshape(()))
        rows, gsum = row_sums(g)
        m1_row = b1 * _f32(m1.index_select(0, rows)) + (1 - b1) * gsum
        m2_row = (b2 * _f32(m2.index_select(0, rows))
                  + (1 - b2) * torch.square(gsum))
        upd = lr_t * m1_row / (torch.sqrt(m2_row) + eps)
        p_row = _f32(p.index_select(0, rows)) - upd
        return {"ParamOut": [_rows_out(ctx, p, rows, p_row)],
                "Moment1Out": [_rows_out(ctx, m1, rows, m1_row)],
                "Moment2Out": [_rows_out(ctx, m2, rows, m2_row)],
                "Beta1PowOut": [_out(ctx, b1p, b1po)],
                "Beta2PowOut": [_out(ctx, b2p, b2po)]}


@register_op("adagrad", differentiable=False, is_optimizer=True)
def _adagrad(ctx, ins, attrs):
    p, mom = ins["Param"][0], ins["Moment"][0]
    g = ins["Grad"][0]
    lr = _lr(ins)
    eps = attrs.get("epsilon", 1e-6)
    if is_selected_rows(g):
        with torch.no_grad():
            rows, gsum = row_sums(g)
            m_row = _f32(mom.index_select(0, rows)) + torch.square(gsum)
            p_row = (_f32(p.index_select(0, rows))
                     - lr * gsum / (torch.sqrt(m_row) + eps))
            return {"ParamOut": [_rows_out(ctx, p, rows, p_row)],
                    "MomentOut": [_rows_out(ctx, mom, rows, m_row)]}
    with torch.no_grad():
        gf = _f32(g)
        m_out = _f32(mom) + torch.square(gf)
        p_out = _f32(p) - lr * gf / (torch.sqrt(m_out) + eps)
        return {"ParamOut": [_out(ctx, p, p_out)],
                "MomentOut": [_out(ctx, mom, m_out)]}


@register_op("decayed_adagrad", differentiable=False, is_optimizer=True)
def _decayed_adagrad(ctx, ins, attrs):
    p, mom = ins["Param"][0], ins["Moment"][0]
    g = ins["Grad"][0]
    lr = _lr(ins)
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    with torch.no_grad():
        gf = _f32(g)
        m_out = decay * _f32(mom) + (1 - decay) * torch.square(gf)
        p_out = _f32(p) - lr * gf / (torch.sqrt(m_out) + eps)
        return {"ParamOut": [_out(ctx, p, p_out)],
                "MomentOut": [_out(ctx, mom, m_out)]}


@register_op("adadelta", differentiable=False, is_optimizer=True)
def _adadelta(ctx, ins, attrs):
    p = ins["Param"][0]
    g = ins["Grad"][0]
    avg_sq_g = ins["AvgSquaredGrad"][0]
    avg_sq_u = ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    with torch.no_grad():
        gf = _f32(g)
        g_acc = rho * _f32(avg_sq_g) + (1 - rho) * torch.square(gf)
        update = -torch.sqrt((_f32(avg_sq_u) + eps) / (g_acc + eps)) * gf
        u_acc = rho * _f32(avg_sq_u) + (1 - rho) * torch.square(update)
        p_out = _f32(p) + update
        return {"ParamOut": [_out(ctx, p, p_out)],
                "AvgSquaredGradOut": [_out(ctx, avg_sq_g, g_acc)],
                "AvgSquaredUpdateOut": [_out(ctx, avg_sq_u, u_acc)]}


@register_op("adamax", differentiable=False, is_optimizer=True)
def _adamax(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, inf_norm = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0]
    lr = _lr(ins)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    with torch.no_grad():
        gf = _f32(g)
        m_out = b1 * _f32(m) + (1 - b1) * gf
        inf_out = torch.maximum(b2 * _f32(inf_norm), torch.abs(gf))
        lr_t = lr / (1 - _f32(b1p).reshape(()))
        p_out = _f32(p) - lr_t * m_out / (inf_out + eps)
        return {"ParamOut": [_out(ctx, p, p_out)],
                "MomentOut": [_out(ctx, m, m_out)],
                "InfNormOut": [_out(ctx, inf_norm, inf_out)]}


@register_op("rmsprop", differentiable=False, is_optimizer=True)
def _rmsprop(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    lr = _lr(ins)
    rho = attrs.get("decay", 0.9)
    eps = attrs.get("epsilon", 1e-10)
    mu = attrs.get("momentum", 0.0)
    with torch.no_grad():
        gf = _f32(g)
        ms_out = rho * _f32(ms) + (1 - rho) * torch.square(gf)
        mom_out = mu * _f32(mom) + lr * gf / torch.sqrt(ms_out + eps)
        p_out = _f32(p) - mom_out
        return {"ParamOut": [_out(ctx, p, p_out)],
                "MeanSquareOut": [_out(ctx, ms, ms_out)],
                "MomentOut": [_out(ctx, mom, mom_out)]}


@register_op("ftrl", differentiable=False, is_optimizer=True)
def _ftrl(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    sq_acc = ins["SquaredAccumulator"][0]
    lin_acc = ins["LinearAccumulator"][0]
    lr = _lr(ins)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    with torch.no_grad():
        gf, pf = _f32(g), _f32(p)
        new_sq = _f32(sq_acc) + torch.square(gf)
        if lr_power == -0.5:
            sigma = (torch.sqrt(new_sq) - torch.sqrt(_f32(sq_acc))) / lr
        else:
            sigma = (torch.pow(new_sq, -lr_power)
                     - torch.pow(_f32(sq_acc), -lr_power)) / lr
        lin_out = _f32(lin_acc) + gf - sigma * pf
        if lr_power == -0.5:
            denom = torch.sqrt(new_sq) / lr + 2 * l2
        else:
            denom = torch.pow(new_sq, -lr_power) / lr + 2 * l2
        pre = torch.clamp(lin_out, -l1, l1) - lin_out
        p_out = pre / denom
        return {"ParamOut": [_out(ctx, p, p_out)],
                "SquaredAccumOut": [_out(ctx, sq_acc, new_sq)],
                "LinearAccumOut": [_out(ctx, lin_acc, lin_out)]}


def _shrink(prox, lr, l1, l2):
    """sign(prox) * max(|prox| - lr * l1, 0) / (1 + lr * l2)."""
    return (torch.sign(prox) * torch.clamp_min(torch.abs(prox) - lr * l1, 0.0)
            / (1.0 + lr * l2))


@register_op("proximal_gd", differentiable=False, is_optimizer=True)
def _proximal_gd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _lr(ins)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    with torch.no_grad():
        prox = _f32(p) - lr * _f32(g)
        return {"ParamOut": [_out(ctx, p, _shrink(prox, lr, l1, l2))]}


@register_op("proximal_adagrad", differentiable=False, is_optimizer=True)
def _proximal_adagrad(ctx, ins, attrs):
    p, mom = ins["Param"][0], ins["Moment"][0]
    g = ins["Grad"][0]
    lr = _lr(ins)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    with torch.no_grad():
        gf = _f32(g)
        m_out = _f32(mom) + torch.square(gf)
        lr_t = lr / torch.sqrt(m_out + 1e-12)
        prox = _f32(p) - lr_t * gf
        return {"ParamOut": [_out(ctx, p, _shrink(prox, lr_t, l1, l2))],
                "MomentOut": [_out(ctx, mom, m_out)]}


@register_op("gen_pruning_mask", differentiable=False)
def _gen_pruning_mask(ctx, ins, attrs):
    """Static pruning mask from the initialised parameter values (the
    reference's StaticPruningHook::generateMask): keep the largest-
    magnitude (1 - sparsity_ratio) fraction, zero the rest. Rank-based
    (argsort of a stable argsort), so exactly int(size * (1 - ratio))
    entries survive and ties keep the earlier index."""
    p = ins["Param"][0]
    ratio = float(attrs["sparsity_ratio"])
    flat = torch.abs(_f32(p)).reshape(-1)
    n_keep = int(flat.shape[0] * (1.0 - ratio))
    order = torch.argsort(-flat, stable=True)
    rank = torch.argsort(order, stable=True)
    mask = (rank < n_keep).to(p.dtype).reshape(p.shape)
    return {"Mask": [mask]}


@register_op("average_accumulates", differentiable=False,
             is_optimizer=True)
def _average_accumulates(ctx, ins, attrs):
    """Windowed parameter-value accumulation for ModelAverage (the
    reference's three-sum scheme): sum_1 += param each step; every
    kMaxNumAccumulates updates sum_1 rolls into sum_2; when the window
    outgrows min(max_average_window, num_updates * average_window) the
    sums collapse into sum_3 and the window restarts. average_apply
    reads (sum_1 + sum_2 + sum_3) / (num_accumulates +
    old_num_accumulates)."""
    p = _f32(ins["Param"][0])
    s1, s2, s3 = (_f32(ins[k][0]) for k in ("Sum1", "Sum2", "Sum3"))
    num_acc = ins["NumAccumulates"][0].long()
    old_acc = ins["OldNumAccumulates"][0].long()
    num_upd = ins["NumUpdates"][0].long()
    window = float(attrs.get("average_window", 0.0))
    max_w = min(int(attrs.get("max_average_window", 2 ** 31 - 1)),
                2 ** 31 - 1)
    min_w = min(int(attrs.get("min_average_window", 10000)), 2 ** 31 - 1)
    k_max = int(attrs.get("kMaxNumAccumulates", 16384))
    with torch.no_grad():
        num_upd = num_upd + 1
        num_acc = num_acc + 1
        s1 = s1 + p
        roll = (num_upd % k_max) == 0
        s2 = torch.where(roll, s2 + s1, s2)
        s1 = torch.where(roll, torch.zeros_like(s1), s1)
        limit = torch.clamp_max((num_upd.float() * window).long(), max_w)
        restart = (num_acc >= min_w) & (num_acc >= limit)
        s3 = torch.where(restart, s1 + s2, s3)
        s1 = torch.where(restart, torch.zeros_like(s1), s1)
        s2 = torch.where(restart, torch.zeros_like(s2), s2)
        old_acc = torch.where(restart, num_acc, old_acc)
        num_acc = torch.where(restart, torch.zeros_like(num_acc), num_acc)
        return {"Sum1Out": [_out(ctx, ins["Sum1"][0], s1)],
                "Sum2Out": [_out(ctx, ins["Sum2"][0], s2)],
                "Sum3Out": [_out(ctx, ins["Sum3"][0], s3)],
                "NumAccumulatesOut": [_out(ctx, ins["NumAccumulates"][0],
                                           num_acc)],
                "OldNumAccumulatesOut": [
                    _out(ctx, ins["OldNumAccumulates"][0], old_acc)],
                "NumUpdatesOut": [_out(ctx, ins["NumUpdates"][0],
                                       num_upd)]}


@register_op("average_apply", differentiable=False)
def _average_apply(ctx, ins, attrs):
    """param := (sum_1 + sum_2 + sum_3) / (num_accumulates +
    old_num_accumulates), backup := param (AverageOptimizer::apply).
    Functional: the backup takes the parameter's tensor and the
    parameter a new one."""
    p = ins["Param"][0]
    s = (_f32(ins["Sum1"][0]) + _f32(ins["Sum2"][0])
         + _f32(ins["Sum3"][0]))
    total = ins["NumAccumulates"][0].long() \
        + ins["OldNumAccumulates"][0].long()
    avg = s / torch.clamp_min(total, 1).float()
    return {"Backup": [p], "ParamOut": [avg.to(p.dtype)]}
