"""recurrent_group: the legacy RecurrentGradientMachine step API
(trainer_config_helpers `recurrent_group` / `memory`).

The port of `paddle_tpu/ops/rnn_group_ops.py`, where the step sub-block
is traced once into one `lax.scan` over time. Here the step block's ops
run once a time step, in a Python loop (`lower_block`): the memories
carry from step to step, each sequence input is sliced at step t, and
the step outputs are stacked back to [B, T, ...]. Sequence-length
masking freezes a row's memories and zeroes its outputs past its length
(the padded + @SEQLEN encoding of LoD), in both directions.

A nested group (SubsequenceInput) steps over the SUBSEQUENCE axis: each
step sees a level-1 slice [B, T_inner, ...] with its per-row inner
lengths.

Gradients: taped, the steps' ops build the op's autograd graph (they run
in its grad mode), and the tape's replay is the backward through every
step.

Random ops in the step: the reference's scan traces the step once, so a
dropout in it draws ONE key and every time step applies the same mask
(tests/test_torch_control_flow.py holds the JAX package to that). The
port matches it: each step starts from the generator state the group
started from, so every step draws the same numbers, and the generator
ends one step's draws ahead (ROADMAP C19). A `while` body draws afresh
each iteration instead, as the reference's loop carries its key.

Shape inference on meta tensors lowers the step block once and stacks
that step T times.
"""

from __future__ import annotations

import torch

from .control_flow_ops import lower_block
from .registry import op_tree_stateful, register_op


def _row_mask(m, like):
    """A [B] bool mask broadcast against a [B, ...] value."""
    return m.reshape((m.shape[0],) + (1,) * (like.dim() - 1))


@register_op("recurrent_group")
def _recurrent_group(ctx, ins, attrs):
    seqs = ins.get("Seq", [])
    if not seqs:
        raise ValueError("recurrent_group needs at least one sequence input")
    seqlen = ins["SeqLen"][0] if ins.get("SeqLen") else None
    sub_lens = ins.get("SubSeqLen", [])
    B, T = int(seqs[0].shape[0]), int(seqs[0].shape[1])

    base_env = dict(zip(attrs["x_names"], ins.get("X", [])))
    seq_step = list(attrs["seq_step_names"])
    inner_names = [n for n in attrs.get("inner_len_names", []) if n]
    mem_names = list(attrs["mem_names"])
    feedback = list(attrs["mem_feedback"])
    out_names = list(attrs["out_names"])

    meta = ctx.device.type == "meta"
    order = range(T - 1, -1, -1) if attrs.get("is_reverse") else range(T)
    if meta:
        order = [0]
    gen = ctx.generator
    gen_state = (gen.get_state() if gen is not None
                 and op_tree_stateful(ctx.program, ctx.op) else None)
    mems = list(ins.get("Boot", []))
    steps = {}
    for t in order:
        if gen_state is not None:
            gen.set_state(gen_state)
        env = dict(base_env)
        env.update(zip(seq_step, (s[:, t] for s in seqs)))
        env.update(zip(inner_names, (sl[:, t] for sl in sub_lens)))
        env.update(zip(mem_names, mems))
        lower_block(ctx, attrs["sub_block"], env)
        if seqlen is None or meta:
            mems = [env[f] for f in feedback]
            steps[t] = [env[o] for o in out_names]
            continue
        m = t < seqlen                                       # [B] bool
        mems = [torch.where(_row_mask(m, env[f]), env[f], old)
                for f, old in zip(feedback, mems)]
        steps[t] = [torch.where(_row_mask(m, env[o]), env[o],
                                torch.zeros_like(env[o]))
                    for o in out_names]
    if meta:
        return {"Out": [o.unsqueeze(1).expand((B, T) + tuple(o.shape[1:]))
                        for o in steps[0]]}
    return {"Out": [torch.stack([steps[t][k] for t in range(T)], dim=1)
                    for k in range(len(out_names))]}
