"""Program IR: the symbolic graph a user builds and the executor runs.

The port's copy of `paddle_tpu/framework.py`: the two-program model
(the startup program holds initializer ops, the main program holds
compute, backward and optimize ops) with the same Block / Operator /
Variable vocabulary, unique names and `Program.to_dict` serialization,
so both packages build identical program text for the same layer calls.

What differs from the JAX package:
  * output shapes are inferred at build time by running each op's torch
    lowering on `meta` tensors (ops/registry.py), not `jax.eval_shape`;
  * the executor interprets the block op by op in eager PyTorch (no
    tracing, no jit), and optimizer ops update the scope's tensors in
    place;
  * the places are `CPUPlace` and `CUDAPlace` (the card); there is no
    mesh, no verifier and no jaxpr audit.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import threading

import numpy as np

# ---------------------------------------------------------------------------
# dtype handling: canonical dtype names are numpy-style strings.
# ---------------------------------------------------------------------------

_DTYPE_ALIASES = {
    "float32": "float32", "fp32": "float32", "float": "float32",
    "float64": "float64", "fp64": "float64", "double": "float64",
    "float16": "float16", "fp16": "float16",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", "uint8": "uint8",
    "int16": "int16", "int32": "int32", "int64": "int64",
    "bool": "bool",
}


def canonical_dtype(dtype) -> str:
    """Normalise a dtype spec (string, numpy dtype, torch dtype) to a
    numpy-style string."""
    if isinstance(dtype, str):
        if dtype in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[dtype]
        return str(np.dtype(dtype))
    name = str(dtype)
    if name.startswith("torch."):
        return _DTYPE_ALIASES[name[len("torch."):]]
    return str(np.dtype(dtype))


# ---------------------------------------------------------------------------
# unique names
# ---------------------------------------------------------------------------

class _UniqueNameGenerator:
    def __init__(self):
        self._ids = collections.defaultdict(int)
        self._lock = threading.Lock()

    def __call__(self, prefix: str) -> str:
        with self._lock:
            idx = self._ids[prefix]
            self._ids[prefix] += 1
        return f"{prefix}_{idx}"

    def reset(self):
        self._ids.clear()


_name_gen = _UniqueNameGenerator()


def unique_name(prefix: str) -> str:
    return _name_gen(prefix)


GRAD_SUFFIX = "@GRAD"
SEQLEN_SUFFIX = "@SEQLEN"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


def seq_len_name(name: str) -> str:
    """Companion int32 [batch] vector of per-row valid lengths: a
    sequence (lod_level >= 1) tensor is padded to a static shape and its
    LoD offsets ride in this var, which sequence ops read through their
    "SeqLen" slot."""
    return name + SEQLEN_SUFFIX


def sub_seq_len_name(name: str) -> str:
    """Companion int32 [batch, S] matrix of a NESTED sequence
    (lod_level 2): the valid inner length of each (example,
    sub-sequence). The outer level (how many sub-sequences an example
    has) stays in `seq_len_name`."""
    return name + SEQLEN_SUFFIX + "@SUB"


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------

class Variable:
    """A symbolic tensor in a Block (fluid framework.py:127). Shapes are
    static; -1 marks a dimension known only at run time (the batch of a
    data var)."""

    def __init__(self, block, name, shape=None, dtype="float32",
                 lod_level=0, persistable=False, stop_gradient=False,
                 trainable=False, is_data=False):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = canonical_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.trainable = trainable
        self.is_data = is_data
        # sharding hint: None or a tuple of mesh axis names / None per
        # dim (ParamAttr.sharding); not part of the program text
        self.sharding = None
        # name of the int32 [batch] lengths var of a padded sequence
        # tensor (seq_len_name), carried by sequence-preserving layers
        self.seq_len_var = None
        # lod_level 2: name of the [batch, S] inner-lengths var
        self.sub_seq_len_var = None

    @property
    def program(self):
        return self.block.program

    def astype(self, dtype):
        from .layers import tensor as tensor_layers
        return tensor_layers.cast(self, dtype)

    # -- operator sugar: + - * / emit elementwise ops (a scalar: scale) ---
    def _binary(self, other, op, reverse=False):
        from .layers import math_ops
        return math_ops.binary_helper(self, other, op, reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    def __radd__(self, other):
        return self._binary(other, "elementwise_add", reverse=True)

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    def __rmul__(self, other):
        return self._binary(other, "elementwise_mul", reverse=True)

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", reverse=True)

    def __neg__(self):
        from .layers import math_ops
        return math_ops.scale(self, scale=-1.0)

    def __repr__(self):
        flags = []
        if self.persistable:
            flags.append("persistable")
        if self.trainable:
            flags.append("param")
        extra = (" [" + ",".join(flags) + "]") if flags else ""
        return f"Var({self.name}: {self.dtype}{list(self.shape or [])}{extra})"

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "trainable": self.trainable,
            "is_data": self.is_data,
            "seq_len_var": self.seq_len_var,
            "sub_seq_len_var": self.sub_seq_len_var,
        }


class Parameter(Variable):
    """A trainable persistable variable (fluid framework.py:988)."""

    def __init__(self, block, name, shape, dtype="float32", **kw):
        self.regularizer = kw.pop("regularizer", None)
        self.gradient_clip = kw.pop("gradient_clip", None)
        trainable = kw.pop("trainable", True)
        super().__init__(block, name, shape=shape, dtype=dtype,
                         persistable=True, trainable=trainable, **kw)


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------

class Operator:
    """A node in a Block: type + named input/output variable lists +
    attrs (fluid OpDesc). The attr `fwd_op_id` links a grad op to the
    forward op whose taped autograd graph it replays (ops/grad.py)."""

    _id_counter = 0
    _id_lock = threading.Lock()

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        with Operator._id_lock:
            Operator._id_counter += 1
            self.id = Operator._id_counter
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def __repr__(self):
        ins = {k: v for k, v in self.inputs.items() if v}
        outs = {k: v for k, v in self.outputs.items() if v}
        return f"Op({self.type} {ins} -> {outs})"

    def to_dict(self):
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": {k: v for k, v in self.attrs.items()
                      if _json_safe(v)},
        }


def _json_safe(v):
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


# ---------------------------------------------------------------------------
# Block / Program
# ---------------------------------------------------------------------------

class Block:
    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: "collections.OrderedDict[str, Variable]" = collections.OrderedDict()
        self.ops: list[Operator] = []

    # -- variables ----------------------------------------------------------
    def create_var(self, name=None, **kw):
        if name is None:
            name = unique_name("tmp")
        if name in self.vars:
            return self.vars[name]
        var = Variable(self, name, **kw)
        self.vars[name] = var
        return var

    def create_parameter(self, name, shape, dtype="float32", **kw):
        param = Parameter(self, name, shape, dtype=dtype, **kw)
        self.vars[name] = param
        return param

    def var(self, name) -> Variable:
        v = self._find_var(name)
        if v is None:
            raise KeyError(f"Variable {name!r} not found in block {self.idx}")
        return v

    def _find_var(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = (blk.program.blocks[blk.parent_idx]
                   if blk.parent_idx >= 0 else None)
        return None

    def has_var(self, name):
        return self._find_var(name) is not None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops ----------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        if infer_shape:
            from .ops.registry import infer_op_shapes
            infer_op_shapes(self, op)
        return op

    def ops_with_serializable_attrs(self):
        """Yield (op, attrs) with grad linkage made positional: a grad
        op's `fwd_op_id` (a process-global counter) is rewritten to the
        forward op's index in this block (`fwd_op_idx`)."""
        id_to_idx = {op.id: i for i, op in enumerate(self.ops)}
        for op in self.ops:
            attrs = dict(op.attrs)
            if "fwd_op_id" in attrs:
                attrs["fwd_op_idx"] = id_to_idx[attrs.pop("fwd_op_id")]
            yield op, attrs

    def to_dict(self):
        op_dicts = []
        for op, attrs in self.ops_with_serializable_attrs():
            d = op.to_dict()
            d["attrs"] = {k: v for k, v in attrs.items() if _json_safe(v)}
            op_dicts.append(d)
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": op_dicts,
        }

    def resolve_fwd_op_links(self):
        """Rewrite deserialized `fwd_op_idx` attrs into live op ids."""
        for op in self.ops:
            if "fwd_op_idx" in op.attrs:
                op.attrs["fwd_op_id"] = self.ops[
                    op.attrs.pop("fwd_op_idx")].id


class Program:
    """A serialisable graph of blocks (fluid framework.py:827).

    `version` is bumped on every mutation, as in the JAX package, so the
    two packages' `to_dict` agree; `seed` seeds the executor's
    `torch.Generator` for the random ops."""

    _uid_counter = 0

    def __init__(self):
        Program._uid_counter += 1
        self.uid = Program._uid_counter
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.version = 0
        self.seed = None

    # -- construction -------------------------------------------------------
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx=None) -> Block:
        """A new sub-block (a While body, an IfElse branch, a
        recurrent_group step) under the current block, or `parent_idx`;
        it becomes the current block until `rollback`."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        return blk

    def rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def bump(self):
        self.version += 1

    # -- clone / serialise --------------------------------------------------
    def clone(self, for_test=False):
        """Deep-copy the program (a fresh uid, version bumped), every
        block with it, so a control-flow op keeps its sub-blocks. With
        for_test=True, ops flip to inference behaviour (dropout off,
        batch_norm on its running stats) through the standard `is_test`
        attr: every op that carries it, and every op whose registry
        entry is test-aware, gets `is_test` True (the reference's
        contract)."""
        cloned = copy.deepcopy(self)
        Program._uid_counter += 1
        cloned.uid = Program._uid_counter
        cloned.bump()
        if for_test:
            from .ops.registry import get_op, has_op
            for blk in cloned.blocks:
                for op in blk.ops:
                    if "is_test" in op.attrs or (
                            has_op(op.type) and get_op(op.type).test_aware):
                        op.attrs["is_test"] = True
        return cloned

    def to_dict(self):
        d = {"blocks": [b.to_dict() for b in self.blocks],
             "version": self.version}
        if getattr(self, "_amp_dtype", None) is not None:
            d["amp_dtype"] = self._amp_dtype
        return d

    def to_json(self, **kw):
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_dict(d) -> "Program":
        """The inverse of `to_dict` (the JAX package's `__model__.json`
        program text loads unchanged). Shapes come from the text; no
        shape inference runs."""
        prog = Program()
        prog.blocks = []
        for bd in d["blocks"]:
            blk = Block(prog, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                vd = dict(vd)
                trainable = vd.pop("trainable", False)
                name = vd.pop("name")
                seq_len_var = vd.pop("seq_len_var", None)
                sub_seq_len_var = vd.pop("sub_seq_len_var", None)
                if trainable:
                    var = blk.create_parameter(
                        name, vd.pop("shape"), dtype=vd.pop("dtype"),
                        lod_level=vd.get("lod_level", 0),
                        stop_gradient=vd.get("stop_gradient", False))
                else:
                    var = blk.create_var(name=name, **vd)
                var.seq_len_var = seq_len_var
                var.sub_seq_len_var = sub_seq_len_var
            for od in bd["ops"]:
                blk.append_op(od["type"], od["inputs"], od["outputs"],
                              od["attrs"], infer_shape=False)
            blk.resolve_fwd_op_links()
            prog.blocks.append(blk)
        if not prog.blocks:
            prog.blocks = [Block(prog, 0)]
        prog._amp_dtype = d.get("amp_dtype")
        return prog

    @staticmethod
    def from_json(s) -> "Program":
        return Program.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# default programs + guards (two-program model, fluid framework.py:1046)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _main_program, _startup_program
    prev_main, prev_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program = prev_main
        _startup_program = prev_startup


def reset_default_programs():
    """Fresh default programs + name counter (used by tests)."""
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()
    _name_gen.reset()


# ---------------------------------------------------------------------------
# Places (paddle/fluid/platform/place.h analog)
# ---------------------------------------------------------------------------

class CPUPlace:
    kind = "cpu"

    def __repr__(self):
        return "CPUPlace()"


class CUDAPlace:
    """The CUDA card `device_id` (the port's accelerator)."""
    kind = "cuda"

    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"
