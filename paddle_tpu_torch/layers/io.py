"""Data-layer entry point (the port's copy of `paddle_tpu/layers/io.py`).

`data(...)` declares a feed variable. A sequence (lod_level >= 1) input
is a padded dense tensor [batch, max_len, *shape] beside a companion
int32 lengths vector `<name>@SEQLEN` (and, for lod_level 2, the [batch,
S] inner lengths `<name>@SEQLEN@SUB`), which the DataFeeder fills and
the sequence ops read: the reference's LoD offsets under static
shapes."""

from __future__ import annotations

from ..framework import (default_main_program, seq_len_name,
                         sub_seq_len_name)

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         main_program=None, stop_gradient=True):
    prog = main_program or default_main_program()
    block = prog.global_block()
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    if lod_level > 0:
        # batch dim + one padded time dim per lod level
        shape = [shape[0]] + [-1] * lod_level + shape[1:]
    var = block.create_var(name=name, shape=shape, dtype=dtype,
                           lod_level=lod_level, is_data=True,
                           stop_gradient=stop_gradient)
    if lod_level > 0:
        sl = block.create_var(name=seq_len_name(name), shape=(-1,),
                              dtype="int32", is_data=True, stop_gradient=True)
        var.seq_len_var = sl.name
    if lod_level > 1:
        ssl = block.create_var(name=sub_seq_len_name(name), shape=(-1, -1),
                               dtype="int32", is_data=True,
                               stop_gradient=True)
        var.sub_seq_len_var = ssl.name
    prog.bump()
    return var
