"""v2 data-type declarations (reference python/paddle/v2/data_type.py,
backed by trainer/PyDataProvider2.py input types). Reuses the
data_provider InputType objects; `to_var_spec` maps a declaration to the
(shape, dtype, lod_level) of the fluid-style data var it becomes."""

from ..data_provider import (                      # noqa: F401
    dense_vector, integer_value, sparse_binary_vector,
    sparse_float_vector, dense_vector_sequence, integer_value_sequence,
    sparse_binary_vector_sequence, InputType)

__all__ = [
    "dense_vector", "integer_value", "sparse_binary_vector",
    "sparse_float_vector", "dense_vector_sequence",
    "integer_value_sequence", "sparse_binary_vector_sequence",
    "to_var_spec",
]


def to_var_spec(t: InputType):
    """-> (shape, dtype, lod_level) for layer.data. InputType.seq is a
    nesting LEVEL (0/1/2 — sub_sequence types are 2), not a bool."""
    lod = int(t.seq)
    if t.kind == "index":
        return [1], "int64", lod
    return [t.dim], "float32", lod
