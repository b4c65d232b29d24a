"""Data-layer entry point (the port's copy of `paddle_tpu/layers/io.py`).

`data(...)` declares a feed variable. The port builds dense programs
only: sequence (lod_level >= 1) data is not ported yet."""

from __future__ import annotations

from ..framework import default_main_program

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         main_program=None, stop_gradient=True):
    if lod_level:
        raise NotImplementedError("paddle_tpu_torch: sequence (lod_level "
                                  ">= 1) data is not ported yet")
    prog = main_program or default_main_program()
    block = prog.global_block()
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    var = block.create_var(name=name, shape=shape, dtype=dtype,
                           lod_level=lod_level, is_data=True,
                           stop_gradient=stop_gradient)
    prog.bump()
    return var
