"""LayerHelper: shared parameter/var plumbing for layer functions.

The port's copy of `paddle_tpu/layer_helper.py`: creates parameters in
the main program and their initializer ops in the startup program (the
two-program model), creates temp output vars, and appends activation
ops.
"""

from __future__ import annotations

from .framework import (default_main_program, default_startup_program,
                        unique_name)
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        if kwargs.get("name") is None:
            self.name = unique_name(layer_type)
        else:
            self.name = kwargs["name"]

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None):
        attr = ParamAttr.to_attr(attr)
        if attr is None:
            return None
        name = attr.name or unique_name(f"{self.name}.w")
        init = attr.initializer or default_initializer
        if init is None:
            init = (ConstantInitializer(0.0) if is_bias
                    else XavierInitializer())
        shape = [int(s) for s in shape]

        main_block = self.main_program.global_block()
        if name in main_block.vars:
            return main_block.vars[name]
        param = main_block.create_parameter(
            name, shape, dtype=dtype, trainable=attr.trainable,
            regularizer=attr.regularizer, gradient_clip=attr.gradient_clip)
        if attr.sharding is not None:
            param.sharding = tuple(attr.sharding)
        if attr.update_hooks:
            param.update_hooks = list(attr.update_hooks)
        # twin persistable var + init op in the startup program
        sblock = self.startup_program.global_block()
        svar = sblock.create_var(name=name, shape=shape, dtype=dtype,
                                 persistable=True)
        if attr.sharding is not None:
            svar.sharding = tuple(attr.sharding)
        init(svar, sblock)
        self.startup_program.bump()
        self.main_program.bump()
        return param

    def create_persistable_var(self, name, shape, dtype="float32",
                               initializer=None):
        """Non-trainable state (optimizer accumulators, learning rate)."""
        main_block = self.main_program.global_block()
        if name in main_block.vars:
            return main_block.vars[name]
        var = main_block.create_var(name=name, shape=shape, dtype=dtype,
                                    persistable=True, stop_gradient=True)
        sblock = self.startup_program.global_block()
        svar = sblock.create_var(name=name, shape=shape, dtype=dtype,
                                 persistable=True)
        (initializer or ConstantInitializer(0.0))(svar, sblock)
        self.startup_program.bump()
        self.main_program.bump()
        return var

    def create_tmp_variable(self, dtype, shape=None, lod_level=0):
        return self.block.create_var(
            name=unique_name(f"{self.name}.tmp"), shape=shape, dtype=dtype,
            lod_level=lod_level)

    def append_op(self, *args, **kwargs):
        op = self.block.append_op(*args, **kwargs)
        self.main_program.bump()
        return op

    def append_activation(self, out_var, act):
        if act is None:
            return out_var
        tmp = self.create_tmp_variable(out_var.dtype,
                                       lod_level=out_var.lod_level)
        tmp.seq_len_var = out_var.seq_len_var
        tmp.sub_seq_len_var = out_var.sub_seq_len_var
        self.append_op(act, {"X": [out_var.name]}, {"Out": [tmp.name]}, {})
        return tmp

    def input_dtype(self, inputs):
        dtype = None
        for var in inputs:
            if dtype is None:
                dtype = var.dtype
            elif dtype != var.dtype:
                raise ValueError("all inputs must have the same dtype")
        return dtype
