"""The reference's ProgramDesc wire format (program_desc.proto), encoded
and parsed by hand in program_desc.py: no protobuf package and no
generated code."""

from . import program_desc  # noqa: F401
