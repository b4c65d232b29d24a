"""Recurrent op lowerings (the port's copy of `paddle_tpu/ops/rnn_ops.py`).

The reference runs each recurrence as a `lax.scan` over the padded time
axis; here each is an explicit time loop of torch ops, taped by
autograd step by step. As in the reference, the large input projection
(x @ W_x over [B*T, D]) is hoisted out of the recurrence by the layer,
so the loop only adds the [B, D] @ [D, gD] recurrent product a step.

The masking contract, copied exactly:
  * a padded step CARRIES the state: h_new * m + h * (1 - m), so the
    outputs at padded positions (and their gradients) are the carried
    state, not zero;
  * `is_reverse` flips time and builds the mask from t = T-1 .. 0, so a
    reverse scan carries h0 through the padded tail before it reaches a
    row's valid steps (padding sits at the end of each row).

Gate order: i, f, c (candidate), o for the LSTMs; [update, reset] ++
candidate for the GRU weight [D, 3D]. No reference kernel here is a
Pallas kernel (scans are XLA), so all of it is plain torch.
"""

from __future__ import annotations

import torch

from .nn_ops import _maximum
from .registry import register_op

__all__ = ["gru_core", "gru_cell"]


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


ACT = {
    "sigmoid": _sigmoid,
    "tanh": torch.tanh,
    "relu": lambda x: _maximum(x, 0),
    "identity": lambda x: x,
}


def _act_attr(v, default):
    """Activation attr -> fn; takes the reference's int codes
    (gru_unit_op.cc: 0 identity, 1 sigmoid, 2 tanh, 3 relu) or names."""
    if isinstance(v, int):
        v = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}.get(v, default)
    return ACT[v]


def _time_major(x, seqlen, is_reverse):
    """(x as [T, B, ...] in scan order, mask [T, B] in x's dtype)."""
    T = x.shape[1]
    xt = x.transpose(0, 1)
    t_idx = torch.arange(T, device=x.device)
    if is_reverse:
        xt = torch.flip(xt, (0,))
        # the mask follows the flipped order: valid steps are the last len
        t_idx = torch.flip(t_idx, (0,))
    mask_t = (t_idx[:, None] < seqlen[None, :]).to(x.dtype)
    return xt, mask_t


def _batch_major(steps, is_reverse):
    """Per-step [B, ...] outputs in scan order -> [B, T, ...]."""
    hs = torch.stack(steps, 0)
    if is_reverse:
        hs = torch.flip(hs, (0,))
    return hs.transpose(0, 1)


def _meta_out(x, *widths):
    """Shape-only outputs for build-time inference on meta tensors (the
    time loop would otherwise run over the sentinel length)."""
    B, T = x.shape[:2]
    return [torch.empty((B, T, w), dtype=x.dtype, device=x.device)
            for w in widths]


@register_op("lstm")
def _lstm(ctx, ins, attrs):
    """Fused LSTM (operators/lstm_op.cc analog).

    Input [B, T, 4D] (pre-projected x), Weight [D, 4D] recurrent weights,
    Bias [1, 4D] (+ a [1, 3D] peephole tail when use_peepholes), SeqLen
    [B], optional H0 / C0 [B, D]. Outputs Hidden [B, T, D], Cell
    [B, T, D]."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    seqlen = ins["SeqLen"][0]
    B, T, D4 = x.shape
    D = D4 // 4
    if x.device.type == "meta":
        h, c = _meta_out(x, D, D)
        return {"Hidden": [h], "Cell": [c]}
    use_peep = attrs.get("use_peepholes", False)
    gate_act = ACT[attrs.get("gate_activation", "sigmoid")]
    cell_act = ACT[attrs.get("cell_activation", "tanh")]
    cand_act = ACT[attrs.get("candidate_activation", "tanh")]
    is_reverse = attrs.get("is_reverse", False)

    bias = ins["Bias"][0] if ins.get("Bias") else None
    peep = None
    if bias is not None:
        bias = bias.reshape(-1)
        gate_bias = bias[:4 * D]
        if use_peep and bias.shape[0] > 4 * D:
            peep = bias[4 * D:]
    else:
        gate_bias = None
    h = ins["H0"][0] if ins.get("H0") else x.new_zeros((B, D))
    c = ins["C0"][0] if ins.get("C0") else x.new_zeros((B, D))

    xt, mask_t = _time_major(x, seqlen, is_reverse)
    hs, cs = [], []
    for t in range(T):
        gates = xt[t] + torch.matmul(h, w)
        if gate_bias is not None:
            gates = gates + gate_bias
        gi = gates[:, 0 * D:1 * D]
        gf = gates[:, 1 * D:2 * D]
        gc = gates[:, 2 * D:3 * D]
        go = gates[:, 3 * D:4 * D]
        if peep is not None:
            gi = gi + c * peep[0 * D:1 * D]
            gf = gf + c * peep[1 * D:2 * D]
        i = gate_act(gi)
        f = gate_act(gf)
        c_new = f * c + i * cand_act(gc)
        if peep is not None:
            go = go + c_new * peep[2 * D:3 * D]
        o = gate_act(go)
        h_new = o * cell_act(c_new)
        m = mask_t[t][:, None]
        h = h_new * m + h * (1 - m)
        c = c_new * m + c * (1 - m)
        hs.append(h)
        cs.append(c)
    return {"Hidden": [_batch_major(hs, is_reverse)],
            "Cell": [_batch_major(cs, is_reverse)]}


def gru_core(xg, h, w, bias=None, gate_act=None, cand_act=None):
    """One GRU step on pre-projected gates xg [B, 3D], hidden h [B, D],
    recurrent weight w [D, 3D] ([D, 2D] update/reset ++ [D, D]
    candidate). Returns (h_new, u, r, r_h, cand): the one definition of
    the gate math, shared by the `gru` loop, the single-step `gru_unit`
    and the beam decoder, so train and decode cells cannot diverge."""
    D = h.shape[-1]
    gate_act = gate_act or ACT["sigmoid"]
    cand_act = cand_act or ACT["tanh"]
    if bias is not None:
        xg = xg + bias
    ur = xg[:, :2 * D] + torch.matmul(h, w[:, :2 * D])
    u = gate_act(ur[:, :D])
    r = gate_act(ur[:, D:])
    r_h = r * h
    cand = cand_act(xg[:, 2 * D:] + torch.matmul(r_h, w[:, 2 * D:]))
    return u * h + (1.0 - u) * cand, u, r, r_h, cand


def gru_cell(xg, h, w, bias=None, gate_act=None, cand_act=None):
    """gru_core returning only the new hidden state."""
    return gru_core(xg, h, w, bias, gate_act, cand_act)[0]


@register_op("gru")
def _gru(ctx, ins, attrs):
    """Fused GRU (operators/gru_op.cc analog). Input [B, T, 3D]
    pre-projected, Weight [D, 3D] ([D, 2D] update/reset ++ [D, D]
    candidate, the reference gru op's layout), SeqLen [B], optional H0.
    Output Hidden [B, T, D]."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    seqlen = ins["SeqLen"][0]
    B, T, D3 = x.shape
    D = D3 // 3
    if x.device.type == "meta":
        return {"Hidden": _meta_out(x, D)}
    gate_act = ACT[attrs.get("gate_activation", "sigmoid")]
    cand_act = ACT[attrs.get("activation", "tanh")]
    is_reverse = attrs.get("is_reverse", False)
    bias = ins["Bias"][0].reshape(-1) if ins.get("Bias") else None
    h = ins["H0"][0] if ins.get("H0") else x.new_zeros((B, D))

    xt, mask_t = _time_major(x, seqlen, is_reverse)
    hs = []
    for t in range(T):
        h_new = gru_cell(xt[t], h, w, bias, gate_act, cand_act)
        m = mask_t[t][:, None]
        h = h_new * m + h * (1 - m)
        hs.append(h)
    return {"Hidden": [_batch_major(hs, is_reverse)]}


@register_op("simple_rnn")
def _simple_rnn(ctx, ins, attrs):
    """Vanilla RNN: h_t = act(x_t + h_{t-1} W) (legacy RecurrentLayer)."""
    x = ins["Input"][0]   # [B, T, D]
    w = ins["Weight"][0]  # [D, D]
    seqlen = ins["SeqLen"][0]
    B, T, D = x.shape
    if x.device.type == "meta":
        return {"Hidden": _meta_out(x, D)}
    act = ACT[attrs.get("activation", "tanh")]
    is_reverse = attrs.get("is_reverse", False)
    h = ins["H0"][0] if ins.get("H0") else x.new_zeros((B, D))
    xt, mask_t = _time_major(x, seqlen, is_reverse)
    hs = []
    for t in range(T):
        h_new = act(xt[t] + torch.matmul(h, w))
        m = mask_t[t][:, None]
        h = h_new * m + h * (1 - m)
        hs.append(h)
    return {"Hidden": [_batch_major(hs, is_reverse)]}


# -- single-step recurrent units --------------------------------------------

@register_op("gru_unit")
def _gru_unit(ctx, ins, attrs):
    """One GRU step (operators/gru_unit_op.cc): Input [B, 3D]
    pre-projected, HiddenPrev [B, D], Weight [D, 3D]. Emits the gates
    (u, r, candidate), the reset hidden and the new hidden."""
    xg = ins["Input"][0]
    h = ins["HiddenPrev"][0]
    w = ins["Weight"][0]
    gate_act = _act_attr(attrs.get("gate_activation", "sigmoid"), "sigmoid")
    cand_act = _act_attr(attrs.get("activation", "tanh"), "tanh")
    bias = ins["Bias"][0].reshape(-1) if ins.get("Bias") else None
    h_new, u, r, r_h, cand = gru_core(xg, h, w, bias, gate_act, cand_act)
    return {"Gate": [torch.cat([u, r, cand], dim=1)],
            "ResetHiddenPrev": [r_h], "Hidden": [h_new]}


@register_op("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    """One LSTM step (operators/lstm_unit_op.h): X [B, 4D] packed
    (i, f, o, g), C_prev [B, D]; the forget gate biased by forget_bias."""
    x = ins["X"][0]
    c_prev = ins["C_prev"][0]
    D = c_prev.shape[-1]
    fb = attrs.get("forget_bias", 0.0)
    i = _sigmoid(x[:, 0 * D:1 * D])
    f = _sigmoid(x[:, 1 * D:2 * D] + fb)
    o = _sigmoid(x[:, 2 * D:3 * D])
    g = torch.tanh(x[:, 3 * D:4 * D])
    c = f * c_prev + i * g
    return {"C": [c], "H": [o * torch.tanh(c)]}


@register_op("lstmp")
def _lstmp(ctx, ins, attrs):
    """Projected LSTM (operators/lstmp_op.cc): the recurrent state is
    r_t = proj_act(h_t ProjWeight) [B, P], so the recurrent weight is
    [P, 4D]. Input [B, T, 4D] pre-projected, SeqLen [B]. Outputs
    Projection [B, T, P] and Cell [B, T, D]."""
    x = ins["Input"][0]
    w = ins["Weight"][0]          # [P, 4D]
    wp = ins["ProjWeight"][0]     # [D, P]
    seqlen = ins["SeqLen"][0]
    B, T, D4 = x.shape
    D = D4 // 4
    P = wp.shape[1]
    if x.device.type == "meta":
        r, c = _meta_out(x, P, D)
        return {"Projection": [r], "Cell": [c]}
    use_peep = attrs.get("use_peepholes", False)
    gate_act = ACT[attrs.get("gate_activation", "sigmoid")]
    cell_act = ACT[attrs.get("cell_activation", "tanh")]
    cand_act = ACT[attrs.get("candidate_activation", "tanh")]
    proj_act = ACT[attrs.get("proj_activation", "tanh")]
    is_reverse = attrs.get("is_reverse", False)

    bias = ins["Bias"][0].reshape(-1) if ins.get("Bias") else None
    peep = None
    if bias is not None:
        gate_bias = bias[:4 * D]
        if use_peep and bias.shape[0] > 4 * D:
            peep = bias[4 * D:]
    else:
        gate_bias = None
    c = ins["C0"][0] if ins.get("C0") else x.new_zeros((B, D))
    r = (proj_act(torch.matmul(ins["H0"][0], wp)) if ins.get("H0")
         else x.new_zeros((B, P)))

    xt, mask_t = _time_major(x, seqlen, is_reverse)
    rs, cs = [], []
    for t in range(T):
        gates = xt[t] + torch.matmul(r, w)
        if gate_bias is not None:
            gates = gates + gate_bias
        gi, gf, gc, go = (gates[:, k * D:(k + 1) * D] for k in range(4))
        if peep is not None:
            gi = gi + c * peep[0 * D:1 * D]
            gf = gf + c * peep[1 * D:2 * D]
        i = gate_act(gi)
        f = gate_act(gf)
        c_new = f * c + i * cand_act(gc)
        if peep is not None:
            go = go + c_new * peep[2 * D:3 * D]
        o = gate_act(go)
        h_new = o * cell_act(c_new)
        r_new = proj_act(torch.matmul(h_new, wp))
        m = mask_t[t][:, None]
        r = r_new * m + r * (1 - m)
        c = c_new * m + c * (1 - m)
        rs.append(r)
        cs.append(c)
    return {"Projection": [_batch_major(rs, is_reverse)],
            "Cell": [_batch_major(cs, is_reverse)]}
