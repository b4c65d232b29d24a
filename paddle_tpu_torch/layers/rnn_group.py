"""recurrent_group / memory / StaticInput / SubsequenceInput — the
legacy step-function RNN API (trainer_config_helpers layers.py
recurrent_group + memory; RecurrentGradientMachine.h step nets), built
on the Program IR's sub-blocks.

The port's copy of `paddle_tpu/layers/rnn_group.py`, building the same
program text; the `recurrent_group` op runs the step block once a time
step (ops/rnn_group_ops.py).

Usage (exactly the reference's shape)::

    def step(y):
        mem = memory(name="rnn_state", size=hidden)
        out = fc(input=[y, mem], size=hidden, act="tanh", name="rnn_state")
        return out

    out = recurrent_group(step=step, input=emb)   # [B, T, hidden]

`memory(name=N)` refers to the previous timestep's value of the step
layer whose `name=` is N — the same name-based linkage the legacy config
DSL uses. Non-sequence inputs wrap in StaticInput and are visible to the
step unchanged each timestep.
"""

from __future__ import annotations

from ..framework import default_main_program, unique_name
from .control_flow import _block_reads_writes, _ancestor_var

__all__ = ["recurrent_group", "memory", "StaticInput",
           "SubsequenceInput"]


class StaticInput:
    """Marks a recurrent_group input as per-batch constant (no time axis);
    the reference's StaticInput (trainer_config_helpers layers.py)."""

    def __init__(self, input, **_compat):
        self.var = input


class SubsequenceInput:
    """Nested-sequence group input (the reference's SubsequenceInput,
    trainer_config_helpers layers.py / RecurrentGradientMachine's
    hierarchical mode): the OUTER group iterates subsequences — each
    outer step sees one level-1 sequence [B, T_inner, ...] with its own
    per-row lengths, typically consumed by an inner recurrent_group."""

    def __init__(self, input, **_compat):
        self.var = input


class _GroupTrace:
    def __init__(self, sub_block):
        self.sub_block = sub_block
        self.memories = []  # (placeholder_var, link_name, boot_layer)


_ACTIVE: list = []


def memory(name, size, boot_layer=None, **_compat):
    """Previous-step value of the step layer named `name` ([B, size]).
    Must be called inside a recurrent_group step function."""
    if not _ACTIVE:
        raise RuntimeError("memory() is only valid inside a "
                           "recurrent_group step function")
    g = _ACTIVE[-1]
    ph = g.sub_block.create_var(
        name=unique_name(f"{name}@mem"), shape=(-1, int(size)),
        dtype="float32")
    g.memories.append((ph, name, boot_layer))
    return ph


def _resolve_link(sub_block, link_name, step_outs):
    """The var a memory feeds back from: the LAST var created in the step
    whose name is `link_name` or starts with `link_name.` (LayerHelper
    names outputs '<name>.tmp*'), mirroring the reference's layer-name
    linkage."""
    match = None
    for vname in sub_block.vars:
        if vname == link_name or vname.startswith(link_name + "."):
            match = vname
    if match is None:
        for v in step_outs:  # fall back: a returned output named exactly
            if v.name == link_name:
                return v.name
        raise ValueError(
            f"recurrent_group memory links to layer {link_name!r} but the "
            f"step function created no layer with that name")
    return match


def recurrent_group(step, input, reverse=False, name=None, **_compat):
    """Run `step` over every timestep of the sequence inputs
    (trainer_config_helpers layers.py recurrent_group). Returns the step
    output as a [B, T, ...] sequence var (a tuple when the step returns
    several)."""
    program = default_main_program()
    parent = program.current_block()
    inputs = list(input) if isinstance(input, (list, tuple)) else [input]

    sub = program.create_block()
    g = _GroupTrace(sub)
    _ACTIVE.append(g)
    seq_srcs, seq_steps, step_args = [], [], []
    inner_len_names, nested = [], False
    try:
        for inp in inputs:
            if isinstance(inp, StaticInput):
                step_args.append(inp.var)
                continue
            if isinstance(inp, SubsequenceInput):
                v = inp.var
                if v.lod_level < 2 or v.sub_seq_len_var is None:
                    raise ValueError(
                        f"SubsequenceInput {v.name!r} needs a nested "
                        "(lod_level=2) sequence")
                nested = True
                T_in = int(v.shape[2])
                sv = sub.create_var(
                    name=unique_name(v.name + "@substep"),
                    shape=(-1, T_in) + tuple(v.shape[3:]),
                    dtype=v.dtype, lod_level=1)
                lv = sub.create_var(
                    name=unique_name(v.name + "@innerlen"),
                    shape=(-1,), dtype="int64")
                sv.seq_len_var = lv.name
                seq_srcs.append(v)
                seq_steps.append(sv)
                step_args.append(sv)
                inner_len_names.append(lv.name)
                continue
            if inp.lod_level < 1 or inp.seq_len_var is None:
                raise ValueError(
                    f"recurrent_group input {inp.name!r} is not a sequence "
                    f"(lod_level must be >= 1)")
            if inp.lod_level >= 2:
                raise ValueError(
                    f"recurrent_group input {inp.name!r} is a NESTED "
                    "sequence — wrap it in SubsequenceInput(...) to "
                    "iterate subsequences (silently slicing the "
                    "subsequence axis would feed the step wrong shapes)")
            sv = sub.create_var(
                name=unique_name(inp.name + "@step"),
                shape=(-1,) + tuple(inp.shape[2:]), dtype=inp.dtype)
            seq_srcs.append(inp)
            seq_steps.append(sv)
            step_args.append(sv)
            inner_len_names.append("")
        if nested and any(n == "" for n in inner_len_names):
            raise ValueError(
                "recurrent_group cannot mix SubsequenceInput with flat "
                "sequence inputs (the reference iterates one LoD level "
                "per group)")
        outs = step(*step_args)
    finally:
        _ACTIVE.pop()
        program.rollback()
    if not seq_srcs:
        raise ValueError("recurrent_group needs at least one sequence input")
    outs_list = list(outs) if isinstance(outs, (list, tuple)) else [outs]

    mem_names, feedbacks, boots = [], [], []
    for ph, link_name, boot_layer in g.memories:
        mem_names.append(ph.name)
        feedbacks.append(_resolve_link(sub, link_name, outs_list))
        if boot_layer is not None:
            boots.append(boot_layer)
        else:
            bvar = parent.create_var(name=unique_name(f"{link_name}@boot"),
                                     stop_gradient=True)
            parent.append_op(
                "fill_constant_batch_size_like",
                {"Input": [seq_srcs[0].name]}, {"Out": [bvar.name]},
                {"shape": [-1, int(ph.shape[-1])], "value": 0.0,
                 "dtype": "float32", "input_dim_idx": 0,
                 "output_dim_idx": 0})
            boots.append(bvar)

    # captures: ancestor vars the step reads that are not scan-managed
    reads, _writes = _block_reads_writes(program, sub)
    managed = set(mem_names) | {v.name for v in seq_steps}
    x_names = [n for n in reads
               if n not in managed and _ancestor_var(parent, n) is not None]

    T = int(seq_srcs[0].shape[1])
    group_outs = []
    for ov in outs_list:
        # a SEQUENCE returned by a nested step (e.g. the inner group's
        # output) stacks over subsequences into a nested sequence
        # [B, S, T_inner, ...] whose inner lengths are the input's
        # sub-sequence lengths
        nested_out = nested and getattr(ov, "lod_level", 0) >= 1
        gout = parent.create_var(
            name=unique_name((name or "recurrent_group") + ".out"),
            shape=(ov.shape[0], T) + tuple(ov.shape[1:]),
            dtype=ov.dtype, lod_level=2 if nested_out else 1)
        gout.seq_len_var = seq_srcs[0].seq_len_var
        if nested_out:
            gout.sub_seq_len_var = seq_srcs[0].sub_seq_len_var
        group_outs.append(gout)

    op_inputs = {"Seq": [v.name for v in seq_srcs],
                 "X": x_names,
                 "Boot": [b.name for b in boots],
                 "SeqLen": [seq_srcs[0].seq_len_var]}
    if nested:
        op_inputs["SubSeqLen"] = [v.sub_seq_len_var for v in seq_srcs]
    parent.append_op(
        "recurrent_group",
        op_inputs,
        {"Out": [v.name for v in group_outs]},
        {"sub_block": sub.idx,
         "x_names": x_names,
         "seq_step_names": [v.name for v in seq_steps],
         "mem_names": mem_names,
         "mem_feedback": feedbacks,
         "out_names": [v.name for v in outs_list],
         "inner_len_names": inner_len_names,
         "is_reverse": bool(reverse)},
        infer_shape=False)
    program.bump()
    return group_outs[0] if len(group_outs) == 1 else tuple(group_outs)
