"""Program <-> ProgramDesc conversion (the port's copy of
`paddle_tpu/proto_io.py`).

A Program serializes to the reference's binary ProgramDesc format
(paddle/fluid/framework/framework.proto; the schema is
proto/program_desc.proto), so a `__model__` written by either package
parses in the other. The messages are encoded and parsed by
`proto/program_desc.py`, by hand: the port needs no protobuf package,
and its bytes equal the JAX package's for the same Program.

Known lossy edges, by design of the 2018 format:
  * Parameter-ness (trainable) is a Python-side notion in fluid too —
    reloaded programs surface params as persistable vars, which is all
    inference needs.
  * the seq_len companion wiring is reconstructed by the @SEQLEN naming
    convention (framework.seq_len_name).
  * attr `fwd_op_id` round-trips as a LONG like any other attr.
  * a float attr is a float32 on the wire: it reads back rounded.

Two extensions give a quantized program (`quant.quantize_program`) a
`__model__`; the JAX package can write no such program:
  * DataType gains UINT8 = 20 and INT8 = 21 (the later Fluid
    framework.proto's numbers) for the int8 weights. The JAX package's
    schema stops at BF16: its `program_to_bytes` raises KeyError 'int8'
    and its parser reads the two values as an unknown enum.
  * the quantizer's `quant_weights` attr, a list of [slot, weight,
    scale] triples (no AttrType holds a list of lists), is written as
    STRINGS, the triples one after another, and read back as triples.
Every program the JAX package can write, the port writes to the same
bytes.
"""

from __future__ import annotations

import numpy as np

from . import framework
from .framework import Program
from .proto import program_desc as pb

__all__ = ["program_to_proto", "program_from_proto",
           "program_to_bytes", "program_from_bytes"]


_DTYPE_TO_PB = {
    "bool": pb.BOOL, "int16": pb.INT16, "int32": pb.INT32,
    "int64": pb.INT64, "float16": pb.FP16, "float32": pb.FP32,
    "float64": pb.FP64, "bfloat16": pb.BF16,
    # the port's extension: the JAX package cannot write these
    "uint8": pb.UINT8, "int8": pb.INT8,
}
_PB_TO_DTYPE = {v: k for k, v in _DTYPE_TO_PB.items()}

_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1

# attrs that reference sub-blocks serialize as AttrType.BLOCK
_BLOCK_ATTRS = {"sub_block", "true_block", "false_block", "default_block"}
# attrs holding a table of strings, written as STRINGS row after row:
# name -> row width (the port's extension, see the module docstring)
_TABLE_ATTRS = {"quant_weights": 3}


def _make_attr(name, value):
    attr = pb.OpDesc.Attr(name=name)
    width = _TABLE_ATTRS.get(name)
    if width and isinstance(value, (list, tuple)) and all(
            isinstance(row, (list, tuple)) and len(row) == width
            for row in value):
        value = [cell for row in value for cell in row]
    if name in _BLOCK_ATTRS and isinstance(value, int) and value >= 0:
        attr.type = pb.BLOCK
        attr.block_idx = value
    elif isinstance(value, bool):
        attr.type = pb.BOOLEAN
        attr.b = value
    elif isinstance(value, int):
        if _INT32_MIN <= value <= _INT32_MAX:
            attr.type = pb.INT
            attr.i = value
        else:
            attr.type = pb.LONG
            attr.l = value
    elif isinstance(value, float):
        attr.type = pb.FLOAT
        attr.f = value
    elif isinstance(value, str):
        attr.type = pb.STRING
        attr.s = value
    elif isinstance(value, (list, tuple)):
        vals = list(value)
        if all(isinstance(v, bool) for v in vals) and vals:
            attr.type = pb.BOOLEANS
            attr.bools = vals
        elif all(isinstance(v, (int, np.integer)) for v in vals):
            attr.type = pb.INTS
            attr.ints = [int(v) for v in vals]
        elif all(isinstance(v, (int, float, np.floating)) for v in vals):
            attr.type = pb.FLOATS
            attr.floats = [float(v) for v in vals]
        elif all(isinstance(v, str) for v in vals):
            attr.type = pb.STRINGS
            attr.strings = vals
        else:
            raise TypeError(
                f"attr {name!r}: mixed-type list {vals!r} has no "
                "ProgramDesc encoding")
    else:
        raise TypeError(f"attr {name!r}: {type(value).__name__} has no "
                        "ProgramDesc encoding")
    return attr


def _get_attr(attr):
    t = attr.type
    if t == pb.BLOCK:
        return attr.block_idx
    if t == pb.BOOLEAN:
        return attr.b
    if t == pb.INT:
        return attr.i
    if t == pb.LONG:
        return attr.l
    if t == pb.FLOAT:
        return attr.f
    if t == pb.STRING:
        return attr.s
    if t == pb.INTS:
        return list(attr.ints)
    if t == pb.FLOATS:
        return list(attr.floats)
    if t == pb.STRINGS:
        width = _TABLE_ATTRS.get(attr.name)
        if width:
            cells = list(attr.strings)
            return [cells[i:i + width] for i in range(0, len(cells), width)]
        return list(attr.strings)
    if t == pb.BOOLEANS:
        return list(attr.bools)
    raise TypeError(f"attr {attr.name!r}: unsupported AttrType {t}")


def _slots(slots):
    return [pb.OpDesc.Var(parameter=slot, arguments=list(names))
            for slot, names in slots.items()]


def program_to_proto(program: Program) -> pb.ProgramDesc:
    proto = pb.ProgramDesc()
    for blk in program.blocks:
        bd = pb.BlockDesc(idx=blk.idx, parent_idx=blk.parent_idx)
        for var in blk.vars.values():
            tensor = pb.VarType.TensorDesc(
                data_type=_DTYPE_TO_PB[
                    framework.canonical_dtype(var.dtype or "float32")],
                dims=[int(d) for d in (var.shape or ())])
            bd.vars.append(pb.VarDesc(
                name=var.name, persistable=bool(var.persistable),
                type=pb.VarType(
                    type=pb.VarType.LOD_TENSOR,
                    lod_tensor=pb.VarType.LoDTensorDesc(
                        tensor=tensor, lod_level=int(var.lod_level or 0)))))
        for op, attrs in blk.ops_with_serializable_attrs():
            bd.ops.append(pb.OpDesc(
                type=op.type, inputs=_slots(op.inputs),
                outputs=_slots(op.outputs),
                attrs=[_make_attr(name, attrs[name])
                       for name in sorted(attrs)]))
        proto.blocks.append(bd)
    return proto


def program_from_proto(proto: pb.ProgramDesc) -> Program:
    prog = Program()
    prog.blocks = []
    for bd in proto.blocks:
        blk = framework.Block(prog, bd.idx, bd.parent_idx)
        for vd in bd.vars:
            shape = None
            dtype = "float32"
            lod_level = 0
            if vd.type.HasField("lod_tensor"):
                td = vd.type.lod_tensor
                shape = tuple(td.tensor.dims) or None
                dtype = _PB_TO_DTYPE[td.tensor.data_type]
                lod_level = td.lod_level
            elif vd.type.HasField("selected_rows"):
                shape = tuple(vd.type.selected_rows.dims) or None
                dtype = _PB_TO_DTYPE[vd.type.selected_rows.data_type]
            blk.create_var(name=vd.name, shape=shape, dtype=dtype,
                           lod_level=lod_level,
                           persistable=vd.persistable)
        for od in bd.ops:
            inputs = {v.parameter: list(v.arguments) for v in od.inputs}
            outputs = {v.parameter: list(v.arguments) for v in od.outputs}
            attrs = {a.name: _get_attr(a) for a in od.attrs}
            blk.append_op(od.type, inputs, outputs, attrs,
                          infer_shape=False)
        blk.resolve_fwd_op_links()
        prog.blocks.append(blk)
    if not prog.blocks:
        prog.blocks = [framework.Block(prog, 0)]
    # reconstruct seq-len companion wiring from the naming convention
    for blk in prog.blocks:
        for name, var in blk.vars.items():
            sl = framework.seq_len_name(name)
            if sl in blk.vars:
                var.seq_len_var = sl
    return prog


def program_to_bytes(program: Program) -> bytes:
    return program_to_proto(program).SerializeToString()


def program_from_bytes(data: bytes) -> Program:
    return program_from_proto(pb.ProgramDesc.FromString(data))
