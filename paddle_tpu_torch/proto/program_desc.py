"""The ProgramDesc messages of `program_desc.proto`, encoded and parsed
by hand (proto2 wire format, no protobuf package, no generated code).

`SerializeToString()` gives the bytes protobuf gives for the same
message: fields in field-number order; an optional scalar only when it
was set (to any value, its default included); repeated scalars
unpacked, one tag an element; a negative int32 or int64 as a 10-byte
varint; a float as 4 little-endian bytes rounded like a C cast (1e39 ->
inf, 1e-46 -> 0.0, the sign of -0.0 and NaN kept). Serializing raises
`EncodeError` when a required field is unset, as protobuf does.

`ParseFromString(data)` accepts packed runs of repeated scalars too,
merges a singular message field that appears twice, lets the last
value of a singular scalar win, and skips fields it does not know (wire
types 0, 1, 2, 5 and groups), a known field with another wire type, and
an enum value outside its enum, as protobuf does. A truncated or
malformed buffer raises `DecodeError` and leaves no partial message
behind; a string that is not UTF-8 is malformed here.

The classes read like protobuf's: `OpDesc.Attr(name="x", type=INT,
i=3)`, `attr.i`, `attr.HasField("i")`, `block.vars.append(VarDesc(...))`.
An unset singular field reads as its default (for a message field, an
empty message that is not attached).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["DecodeError", "EncodeError", "AttrType", "DataType", "OpDesc",
           "VarType", "VarDesc", "BlockDesc", "ProgramDesc",
           "INT", "FLOAT", "STRING", "INTS", "FLOATS", "STRINGS", "BOOLEAN",
           "BOOLEANS", "BLOCK", "LONG", "BOOL", "INT16", "INT32", "INT64",
           "FP16", "FP32", "FP64", "BF16", "UINT8", "INT8"]


class DecodeError(ValueError):
    """A buffer that is not a well-formed message of the expected type."""


class EncodeError(ValueError):
    """A message that cannot be serialized (a required field unset)."""


# -- enums --------------------------------------------------------------------

class AttrType:
    INT, FLOAT, STRING, INTS, FLOATS, STRINGS = 0, 1, 2, 3, 4, 5
    BOOLEAN, BOOLEANS, BLOCK, LONG = 6, 7, 8, 9
    VALUES = frozenset(range(10))


class DataType:
    """program_desc.proto's DataType; UINT8 and INT8 are the port's
    extension (the later Fluid numbers), which the JAX package's schema
    lacks."""
    BOOL, INT16, INT32, INT64, FP16, FP32, FP64, BF16 = range(8)
    UINT8, INT8 = 20, 21
    VALUES = frozenset([*range(8), UINT8, INT8])


INT, FLOAT, STRING, INTS, FLOATS, STRINGS = 0, 1, 2, 3, 4, 5
BOOLEAN, BOOLEANS, BLOCK, LONG = 6, 7, 8, 9
BOOL, INT16, INT32, INT64, FP16, FP32, FP64, BF16 = range(8)
UINT8, INT8 = DataType.UINT8, DataType.INT8

# -- wire primitives ----------------------------------------------------------

_VARINT, _FIXED64, _BYTES, _START_GROUP, _END_GROUP, _FIXED32 = range(6)
_U64 = (1 << 64) - 1
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


def _varint(value):
    """Unsigned LEB128 of `value` taken modulo 2**64 (a negative int is
    its 64-bit two's complement: 10 bytes)."""
    value &= _U64
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _read_varint(buf, pos, end):
    result = shift = 0
    for i in range(10):
        if pos >= end:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            if i == 9 and b > 1:
                raise DecodeError("varint overflows 64 bits")
            return result & _U64, pos
        shift += 7
    raise DecodeError("varint longer than 10 bytes")


def _signed(value, bits):
    value &= (1 << bits) - 1
    return value - (1 << bits) if value >> (bits - 1) else value


def _f32_bytes(value):
    """4 little-endian bytes of `value` rounded to float32 as a C cast
    rounds it (round to nearest even; past the largest float32, inf)."""
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        return np.asarray(value, dtype=np.float64).astype("<f4").tobytes()


def _f32(value):
    return struct.unpack("<f", _f32_bytes(value))[0]


def _skip(buf, pos, end, wire, number):
    """Position past one field's payload of wire type `wire`."""
    if wire == _VARINT:
        return _read_varint(buf, pos, end)[1]
    if wire == _FIXED64:
        pos += 8
    elif wire == _FIXED32:
        pos += 4
    elif wire == _BYTES:
        n, pos = _read_varint(buf, pos, end)
        pos += n
    elif wire == _START_GROUP:
        while True:
            tag, pos = _read_varint(buf, pos, end)
            if tag >> 3 == 0:
                raise DecodeError("field number 0")
            if tag & 7 == _END_GROUP:
                if tag >> 3 != number:
                    raise DecodeError("mismatched end of group")
                return pos
            pos = _skip(buf, pos, end, tag & 7, tag >> 3)
    else:
        raise DecodeError(f"wire type {wire} out of place")
    if pos > end:
        raise DecodeError("truncated field")
    return pos


# -- fields -------------------------------------------------------------------

_WIRE = {"int32": _VARINT, "int64": _VARINT, "bool": _VARINT,
         "enum": _VARINT, "float": _FIXED32, "string": _BYTES,
         "message": _BYTES}


class _Field:
    """One field of a message: a descriptor over the instance's value
    (None while an optional field is unset)."""

    def __init__(self, number, name, kind, label="optional", default=None,
                 message=None, enum=None):
        self.number, self.name, self.kind = number, name, kind
        self.label, self.message, self.enum = label, message, enum
        self.repeated = label == "repeated"
        self.wire = _WIRE[kind]
        if default is None and kind != "message":
            default = {"string": "", "float": 0.0, "bool": False}.get(kind, 0)
        self.default = default
        self.tag = _varint((number << 3) | self.wire)

    def __get__(self, msg, owner=None):
        if msg is None:
            return self
        value = msg._values.get(self.name)
        if value is None:
            if self.repeated:
                value = msg._values[self.name] = []
            elif self.kind == "message":
                return self.message()
            else:
                return self.default
        return value

    def __set__(self, msg, value):
        if self.repeated:
            msg._values[self.name] = [self.check(v) for v in value]
        else:
            msg._values[self.name] = (None if value is None
                                      else self.check(value))

    def check(self, value):
        """`value` as this field stores it; raises like protobuf on a
        wrong type or an out-of-range integer."""
        kind = self.kind
        if kind == "message":
            if not isinstance(value, self.message):
                raise TypeError(f"{self.name}: expected "
                                f"{self.message.__name__}, got "
                                f"{type(value).__name__}")
            return value
        if kind == "string":
            if isinstance(value, bytes):
                value = value.decode("utf-8")
            if not isinstance(value, str):
                raise TypeError(f"{self.name}: expected str, got "
                                f"{type(value).__name__}")
            return value
        if kind == "float":
            if isinstance(value, (str, bytes)) or not np.isscalar(value):
                raise TypeError(f"{self.name}: expected a number, got "
                                f"{type(value).__name__}")
            return _f32(float(value))
        if kind == "bool":
            return bool(value)
        if isinstance(value, float) or not isinstance(value,
                                                      (int, np.integer)):
            raise TypeError(f"{self.name}: expected an int, got "
                            f"{type(value).__name__}")
        value = int(value)
        lo, hi = ((_INT64_MIN, _INT64_MAX) if kind == "int64"
                  else (_INT32_MIN, _INT32_MAX))
        if not lo <= value <= hi:
            raise ValueError(f"Value out of range: {value}")
        if kind == "enum" and value not in self.enum.VALUES:
            raise ValueError(f"Unknown enum value: {value}")
        return value

    def encode_one(self, value):
        kind = self.kind
        value = self.check(value)      # a list may have grown unchecked
        if kind == "message":
            body = value._serialize()
            return self.tag + _varint(len(body)) + body
        if kind == "string":
            body = value.encode("utf-8")
            return self.tag + _varint(len(body)) + body
        if kind == "float":
            return self.tag + _f32_bytes(value)
        return self.tag + _varint(int(value))

    def decode_scalar(self, raw):
        """The value of a varint field read as `raw` (unsigned 64 bit);
        None for an enum value outside the enum (protobuf keeps those as
        unknown fields)."""
        if self.kind == "bool":
            return raw != 0
        if self.kind == "int64":
            return _signed(raw, 64)
        value = _signed(raw, 32)
        if self.kind == "enum" and value not in self.enum.VALUES:
            return None
        return value


# -- messages -----------------------------------------------------------------

class _Message:
    FIELDS = ()

    def __init__(self, **values):
        self._values = {}
        for name, value in values.items():
            if name not in self._by_name():
                raise ValueError(f"{type(self).__name__} has no field "
                                 f"{name!r}")
            setattr(self, name, value)

    @classmethod
    def _by_name(cls):
        table = cls.__dict__.get("_names")
        if table is None:
            table = {f.name: f for f in cls.FIELDS}
            cls._names = table
        return table

    @classmethod
    def _by_number(cls):
        table = cls.__dict__.get("_numbers")
        if table is None:
            table = {f.number: f for f in cls.FIELDS}
            cls._numbers = table
        return table

    def HasField(self, name):
        field = self._by_name().get(name)
        if field is None or field.repeated:
            raise ValueError(f"{type(self).__name__} has no singular field "
                             f"{name!r}")
        return self._values.get(name) is not None

    def __repr__(self):
        parts = [f"{f.name}={getattr(self, f.name)!r}" for f in self.FIELDS
                 if (getattr(self, f.name) if f.repeated
                     else self.HasField(f.name))]
        return f"{type(self).__name__}({', '.join(parts)})"

    # -- encoding ------------------------------------------------------------
    def _missing(self, prefix=""):
        """Dotted names of required fields left unset, recursively."""
        missing = []
        for f in self.FIELDS:
            value = self._values.get(f.name)
            if f.label == "required" and value is None:
                missing.append(prefix + f.name)
            if f.kind != "message" or value is None:
                continue
            for i, sub in enumerate(value if f.repeated else [value]):
                at = f"{f.name}[{i}]." if f.repeated else f"{f.name}."
                missing += sub._missing(prefix + at)
        return missing

    def _serialize(self):
        out = []
        for f in sorted(self.FIELDS, key=lambda f: f.number):
            value = self._values.get(f.name)
            if value is None:
                continue
            if f.repeated:
                out += [f.encode_one(v) for v in value]
            else:
                out.append(f.encode_one(value))
        return b"".join(out)

    def SerializeToString(self):
        missing = self._missing()
        if missing:
            raise EncodeError(f"Message {type(self).__name__} is missing "
                              f"required fields: {','.join(missing)}")
        return self._serialize()

    # -- decoding ------------------------------------------------------------
    def _merge(self, buf, pos, end):
        numbers = self._by_number()
        values = self._values
        while pos < end:
            tag, pos = _read_varint(buf, pos, end)
            number, wire = tag >> 3, tag & 7
            if number == 0:
                raise DecodeError("field number 0")
            if wire == _END_GROUP:
                raise DecodeError("end of group out of place")
            f = numbers.get(number)
            if f is None or (wire != f.wire and not (
                    f.repeated and wire == _BYTES and f.kind not in
                    ("string", "message"))):
                pos = _skip(buf, pos, end, wire, number)
                continue
            if wire == _BYTES:
                n, pos = _read_varint(buf, pos, end)
                stop = pos + n
                if stop > end:
                    raise DecodeError(f"truncated field {f.name}")
                if f.kind == "message":
                    if f.repeated:
                        sub = f.message()
                        sub._merge(buf, pos, stop)
                        values.setdefault(f.name, []).append(sub)
                    else:
                        sub = values.get(f.name)
                        if sub is None:
                            sub = values[f.name] = f.message()
                        sub._merge(buf, pos, stop)
                elif f.kind == "string":
                    try:
                        text = bytes(buf[pos:stop]).decode("utf-8")
                    except UnicodeDecodeError as e:
                        raise DecodeError(f"{f.name}: not UTF-8") from e
                    if f.repeated:
                        values.setdefault(f.name, []).append(text)
                    else:
                        values[f.name] = text
                else:                           # a packed run
                    values.setdefault(f.name, []).extend(
                        self._packed(f, buf, pos, stop))
                pos = stop
            elif wire == _FIXED32:
                if pos + 4 > end:
                    raise DecodeError(f"truncated field {f.name}")
                value = struct.unpack_from("<f", buf, pos)[0]
                pos += 4
                if f.repeated:
                    values.setdefault(f.name, []).append(value)
                else:
                    values[f.name] = value
            else:
                raw, pos = _read_varint(buf, pos, end)
                value = f.decode_scalar(raw)
                if value is None:
                    continue
                if f.repeated:
                    values.setdefault(f.name, []).append(value)
                else:
                    values[f.name] = value
        if pos != end:
            raise DecodeError("field runs past the end of its message")

    @staticmethod
    def _packed(f, buf, pos, stop):
        out = []
        if f.kind == "float":
            if (stop - pos) % 4:
                raise DecodeError(f"packed {f.name}: length not a "
                                  "multiple of 4")
            return list(struct.unpack_from(f"<{(stop - pos) // 4}f", buf,
                                           pos))
        while pos < stop:
            raw, pos = _read_varint(buf, pos, stop)
            value = f.decode_scalar(raw)
            if value is not None:
                out.append(value)
        return out

    def ParseFromString(self, data):
        """Replace this message's contents with the parse of `data`;
        returns the number of bytes read. On a malformed buffer raises
        DecodeError and leaves the message as it was."""
        buf = memoryview(bytes(data))
        fresh = type(self)()
        fresh._merge(buf, 0, len(buf))
        self._values = fresh._values
        return len(buf)

    @classmethod
    def FromString(cls, data):
        msg = cls()
        msg.ParseFromString(data)
        return msg


def _message(name, fields, **nested):
    cls = type(name, (_Message,), {"FIELDS": tuple(fields), **nested})
    for f in cls.FIELDS:
        setattr(cls, f.name, f)
    return cls


_Attr = _message("Attr", [
    _Field(1, "name", "string", "required"),
    _Field(2, "type", "enum", "required", enum=AttrType),
    _Field(3, "i", "int32"),
    _Field(4, "f", "float"),
    _Field(5, "s", "string"),
    _Field(6, "ints", "int32", "repeated"),
    _Field(7, "floats", "float", "repeated"),
    _Field(8, "strings", "string", "repeated"),
    _Field(10, "b", "bool"),
    _Field(11, "bools", "bool", "repeated"),
    _Field(12, "block_idx", "int32"),
    _Field(13, "l", "int64"),
])
_Var = _message("Var", [
    _Field(1, "parameter", "string", "required"),
    _Field(2, "arguments", "string", "repeated"),
])
OpDesc = _message("OpDesc", [
    _Field(3, "type", "string", "required"),
    _Field(1, "inputs", "message", "repeated", message=_Var),
    _Field(2, "outputs", "message", "repeated", message=_Var),
    _Field(4, "attrs", "message", "repeated", message=_Attr),
    _Field(5, "is_target", "bool", default=False),
], Attr=_Attr, Var=_Var)

_TensorDesc = _message("TensorDesc", [
    _Field(1, "data_type", "enum", "required", enum=DataType),
    _Field(2, "dims", "int64", "repeated"),
])
_LoDTensorDesc = _message("LoDTensorDesc", [
    _Field(1, "tensor", "message", "required", message=_TensorDesc),
    _Field(2, "lod_level", "int32", default=0),
])
_LoDTensorArrayDesc = _message("LoDTensorArrayDesc", [
    _Field(1, "tensor", "message", "required", message=_TensorDesc),
    _Field(2, "lod_level", "int32", default=0),
])
_ReaderDesc = _message("ReaderDesc", [
    _Field(1, "lod_tensor", "message", "repeated", message=_LoDTensorDesc),
])


class _VarTypeEnum:
    LOD_TENSOR, SELECTED_ROWS, FEED_MINIBATCH, FETCH_LIST = 1, 2, 3, 4
    STEP_SCOPES, LOD_RANK_TABLE, LOD_TENSOR_ARRAY, PLACE_LIST = 5, 6, 7, 8
    READER = 9
    VALUES = frozenset(range(1, 10))


VarType = _message("VarType", [
    _Field(1, "type", "enum", "required", enum=_VarTypeEnum),
    _Field(2, "selected_rows", "message", message=_TensorDesc),
    _Field(3, "lod_tensor", "message", message=_LoDTensorDesc),
    _Field(4, "tensor_array", "message", message=_LoDTensorArrayDesc),
    _Field(5, "reader", "message", message=_ReaderDesc),
], TensorDesc=_TensorDesc, LoDTensorDesc=_LoDTensorDesc,
    LoDTensorArrayDesc=_LoDTensorArrayDesc, ReaderDesc=_ReaderDesc,
    Type=_VarTypeEnum, **{k: getattr(_VarTypeEnum, k) for k in (
        "LOD_TENSOR", "SELECTED_ROWS", "FEED_MINIBATCH", "FETCH_LIST",
        "STEP_SCOPES", "LOD_RANK_TABLE", "LOD_TENSOR_ARRAY", "PLACE_LIST",
        "READER")})

VarDesc = _message("VarDesc", [
    _Field(1, "name", "string", "required"),
    _Field(2, "type", "message", "required", message=VarType),
    _Field(3, "persistable", "bool", default=False),
])
BlockDesc = _message("BlockDesc", [
    _Field(1, "idx", "int32", "required"),
    _Field(2, "parent_idx", "int32", "required"),
    _Field(3, "vars", "message", "repeated", message=VarDesc),
    _Field(4, "ops", "message", "repeated", message=OpDesc),
])
ProgramDesc = _message("ProgramDesc", [
    _Field(1, "blocks", "message", "repeated", message=BlockDesc),
])
