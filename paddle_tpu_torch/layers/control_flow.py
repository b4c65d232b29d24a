"""Control-flow layers: While / IfElse / Switch / tensor arrays.

The port's copy of `paddle_tpu/layers/control_flow.py`, building the
same program text (fluid layers/control_flow.py: While, IfElse, Switch;
operators/while_op.cc, conditional_block_op.cc):

  * ``While(cond)`` — the sub-block the user builds becomes a Program
    block; the appended `while` op runs it until the condition is false
    (ops/control_flow_ops.py). Loop variables are discovered
    automatically: every ancestor-block variable the body writes (via
    ``assign(x, output=var)``, ``increment`` or ``array_write``) is
    carried. Shapes are static across iterations.
  * ``IfElse(cond)`` — both branches run on the full padded batch and
    merge row-wise by the condition mask.
  * ``Switch()`` — scalar-condition case chain (the piecewise-decay
    helper, fluid layers/control_flow.py Switch).
  * ``create_array``/``array_write``/``array_read`` — fixed-capacity
    LoDTensorArray analog: a [max_len, ...] tensor with dynamic index
    reads/writes, usable inside While bodies.

The dynamic-RNN machinery the reference builds from While
(lod_rank_table, lod_tensor_to_array, shrink_rnn_memory) is not
mirrored, as in the JAX package: the recurrence ops (ops/rnn_ops.py)
and masked sequence ops cover it, and While covers the residual
"arbitrary stepwise body" cases with masking instead of batch
shrinking.
"""

from __future__ import annotations

import contextlib

from ..framework import unique_name
from ..layer_helper import LayerHelper
from .tensor import fill_constant

__all__ = [
    "While", "IfElse", "Switch", "create_array", "array_write", "array_read",
    "max_sequence_len", "lod_rank_table",
]


def _block_reads_writes(program, block):
    """Names a block's ops (recursively through sub-blocks) read from /
    write to ancestor blocks. Reads are conservative: any input name not
    locally created; writes: any output name resolving to an ancestor."""
    local = set(block.vars.keys())
    reads, writes = [], []
    seen_r, seen_w = set(), set()

    def visit(blk, local_names):
        for op in blk.ops:
            for names in op.inputs.values():
                for n in names:
                    if n and n not in local_names and n not in seen_r:
                        seen_r.add(n)
                        reads.append(n)
            for names in op.outputs.values():
                for n in names:
                    if not n:
                        continue
                    if n not in local_names and n not in seen_w:
                        seen_w.add(n)
                        writes.append(n)
            for attr in ("sub_block", "true_block", "false_block"):
                if attr in op.attrs and op.attrs[attr] >= 0:
                    sub = program.blocks[op.attrs[attr]]
                    visit(sub, local_names | set(sub.vars.keys()))
            for idx in op.attrs.get("case_blocks", []) or []:
                sub = program.blocks[idx]
                visit(sub, local_names | set(sub.vars.keys()))
    visit(block, local)
    # a name written before it is read inside the block is not a capture
    return reads, writes


def _ancestor_var(parent_block, name):
    v = parent_block._find_var(name)
    return v


class While:
    """fluid.layers.While-shaped loop (reference layers/control_flow.py).

    Usage::

        i = fill_constant([1], "int64", 0)
        n = fill_constant([1], "int64", 10)
        cond = layers.less_than(i, n)
        w = While(cond)
        with w.block():
            ...ops writing ancestor vars via assign(..., output=var)...
            layers.increment(i)
            layers.less_than(i, n, cond=cond)  # update the loop condition

    The body MUST update `cond` (same contract as the reference's
    while_op.cc kCondition input).
    """

    def __init__(self, cond, max_iters=0, name=None):
        if cond.dtype != "bool":
            raise TypeError("While condition must be a bool tensor")
        self.cond = cond
        self.max_iters = max_iters
        self.helper = LayerHelper("while", name=name)

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent = program.current_block()
        sub = program.create_block()
        try:
            yield
        finally:
            program.rollback()
        reads, writes = _block_reads_writes(program, sub)
        # loop vars: ancestor vars the body writes (cond included so the
        # loop terminates); order: cond first, then discovery order
        loop_vars = []
        for n in writes:
            if _ancestor_var(parent, n) is not None and n not in loop_vars:
                loop_vars.append(n)
        if self.cond.name not in loop_vars:
            raise ValueError(
                "While body never updates the loop condition "
                f"{self.cond.name!r} — the loop would not terminate")
        # captures: ancestor vars read (loop vars excluded; they enter via
        # the carry). cond enters via Condition.
        x_names = [n for n in reads
                   if _ancestor_var(parent, n) is not None
                   and n not in loop_vars and n != self.cond.name]
        parent.append_op(
            "while",
            {"Condition": [self.cond.name], "X": x_names},
            {"Out": list(loop_vars)},
            {"sub_block": sub.idx, "x_names": x_names,
             "loop_vars": list(loop_vars), "cond": self.cond.name,
             "max_iters": int(self.max_iters)},
            infer_shape=False)
        program.bump()


class IfElse:
    """fluid.layers.IfElse-shaped row-wise conditional.

    Usage::

        ie = IfElse(cond)              # cond: bool [N] or [N, 1]
        with ie.true_block():
            d = ie.input(x)
            ie.output(f(d))
        with ie.false_block():
            d = ie.input(x)
            ie.output(g(d))
        out, = ie()

    Both branches see the FULL batch; outputs are merged row-wise by the
    mask. Row i of the result comes from the true branch iff cond[i].
    Gradients flow through both branches, masked — ifelse is an ordinary
    differentiable op on the vjp tape.
    """

    OUT_IF_ELSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        if cond.dtype != "bool":
            raise TypeError("IfElse condition must be a bool tensor")
        self.cond = cond
        self.helper = LayerHelper("ifelse", name=name)
        self._blocks = {}          # "true"/"false" -> block idx
        self._outputs = {"true": [], "false": []}
        self._current = None

    def input(self, x):
        """Reference IfElse.input slices the masked sub-batch; here the
        full batch flows through and the mask is applied at merge."""
        return x

    def output(self, *outs):
        if self._current is None:
            raise RuntimeError("IfElse.output called outside a branch block")
        self._outputs[self._current].extend(outs)

    @contextlib.contextmanager
    def _branch(self, which):
        program = self.helper.main_program
        sub = program.create_block()
        self._blocks[which] = sub.idx
        self._current = which
        try:
            yield
        finally:
            program.rollback()
            self._current = None

    def true_block(self):
        return self._branch("true")

    def false_block(self):
        return self._branch("false")

    def __call__(self):
        if set(self._blocks) != {"true", "false"}:
            raise RuntimeError("IfElse needs both true_block and false_block")
        t_outs = self._outputs["true"]
        f_outs = self._outputs["false"]
        if len(t_outs) != len(f_outs):
            raise ValueError(
                f"IfElse branches declared different output counts "
                f"({len(t_outs)} vs {len(f_outs)})")
        program = self.helper.main_program
        parent = program.current_block()
        reads, writes = [], []
        for idx in self._blocks.values():
            r, w = _block_reads_writes(program, program.blocks[idx])
            reads.extend(r)
            writes.extend(w)
        # Branch envs are discarded after the merge: a write to an
        # ancestor var inside a branch would be silently lost (While and
        # Switch carry such writes; IfElse's contract is ie.output()).
        lost = [n for n in writes if _ancestor_var(parent, n) is not None]
        if lost:
            raise ValueError(
                f"IfElse branch assigns to outer variable(s) {lost}; "
                "branch writes do not persist — return results via "
                "ie.output() instead")
        branch_out_names = {v.name for v in t_outs} | {v.name for v in f_outs}
        x_names, seen = [], set()
        for n in reads:
            if (n not in seen and n != self.cond.name
                    and n not in branch_out_names
                    and _ancestor_var(parent, n) is not None):
                seen.add(n)
                x_names.append(n)
        merged = []
        for tv in t_outs:
            out = parent.create_var(name=unique_name(f"{self.helper.name}.out"),
                                    shape=tv.shape, dtype=tv.dtype)
            merged.append(out)
        parent.append_op(
            "ifelse",
            {"Cond": [self.cond.name], "X": x_names},
            {"Out": [v.name for v in merged]},
            {"true_block": self._blocks["true"],
             "false_block": self._blocks["false"],
             "x_names": x_names,
             "true_outs": [v.name for v in t_outs],
             "false_outs": [v.name for v in f_outs]},
            infer_shape=False)
        program.bump()
        return merged


class Switch:
    """Scalar-condition case chain (fluid layers/control_flow.py Switch).

    Usage (the piecewise learning-rate pattern)::

        lr = create_global_var(...)
        with Switch() as switch:
            with switch.case(step < b1):
                layers.assign(v1, lr)
            with switch.default():
                layers.assign(v2, lr)

    First true case wins. Every var assigned in any case must also be
    assigned in the default block (or already hold a value).
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._conds = []
        self._case_blocks = []
        self._default_block = -1
        self._inside = False

    def __enter__(self):
        self._inside = True
        return self

    def __exit__(self, *exc):
        if any(exc):
            return False
        self._append()
        self._inside = False
        return False

    @contextlib.contextmanager
    def case(self, cond):
        if not self._inside:
            raise RuntimeError("Switch.case used outside `with Switch()`")
        if cond.dtype != "bool":
            raise TypeError("Switch case condition must be a bool tensor")
        program = self.helper.main_program
        sub = program.create_block()
        self._conds.append(cond)
        self._case_blocks.append(sub.idx)
        try:
            yield
        finally:
            program.rollback()

    @contextlib.contextmanager
    def default(self):
        if not self._inside:
            raise RuntimeError("Switch.default used outside `with Switch()`")
        program = self.helper.main_program
        sub = program.create_block()
        self._default_block = sub.idx
        try:
            yield
        finally:
            program.rollback()

    def _append(self):
        program = self.helper.main_program
        parent = program.current_block()
        all_blocks = list(self._case_blocks)
        if self._default_block >= 0:
            all_blocks.append(self._default_block)
        reads, writes = [], []
        for idx in all_blocks:
            r, w = _block_reads_writes(program, program.blocks[idx])
            reads.extend(r)
            writes.extend(w)
        out_names = []
        for n in writes:
            if _ancestor_var(parent, n) is not None and n not in out_names:
                out_names.append(n)
        cond_names = {c.name for c in self._conds}
        x_names, seen = [], set()
        for n in reads:
            if (n not in seen and n not in cond_names
                    and _ancestor_var(parent, n) is not None):
                seen.add(n)
                x_names.append(n)
        parent.append_op(
            "switch",
            {"Cond": [c.name for c in self._conds], "X": x_names},
            {"Out": out_names},
            {"case_blocks": self._case_blocks,
             "default_block": self._default_block,
             "x_names": x_names, "out_names": out_names},
            infer_shape=False)
        program.bump()


# ---------------------------------------------------------------------------
# Tensor arrays (fixed-capacity LoDTensorArray analog)
# ---------------------------------------------------------------------------

def create_array(dtype, element_shape, max_len, name=None):
    """Preallocated [max_len, *element_shape] array for While bodies.

    The reference's LoDTensorArray grows dynamically
    (operators/tensor_array_read_write_op.cc); under static shapes the
    capacity is declared up front, and an index past either end is
    clamped to it (ops/control_flow_ops.py `_array_index`).
    """
    return fill_constant([int(max_len)] + [int(s) for s in element_shape],
                         dtype, 0.0, name=name)


def array_write(x, i, array):
    """array[i] = x (functional; returns the updated array and rebinds the
    array var name so While's write-detection carries it)."""
    helper = LayerHelper("array_write")
    helper.append_op("array_write",
                     {"X": [x.name], "I": [i.name], "Array": [array.name]},
                     {"Out": [array.name]}, {}, infer_shape=False)
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_tmp_variable(array.dtype,
                                     shape=list(array.shape[1:])
                                     if array.shape else None)
    helper.append_op("array_read", {"Array": [array.name], "I": [i.name]},
                     {"Out": [out.name]}, {}, infer_shape=False)
    return out


def max_sequence_len(seq_lens, name=None):
    """Max over the per-row length vector (the reference's
    max_sequence_len op read a LoDRankTable; here lengths are explicit —
    framework.seq_len_name mapping)."""
    from .math_ops import reduce_max
    return reduce_max(seq_lens, dim=[0], keep_dim=True)


def lod_rank_table(*a, **k):
    raise NotImplementedError(
        "lod_rank_table has no analog: the LoD batch-reordering machinery "
        "(lod_rank_table/lod_tensor_to_array/shrink_rnn_memory) is replaced "
        "by the recurrence ops over padded [batch, time] tensors with "
        "@SEQLEN masking — see ops/rnn_ops.py.")
