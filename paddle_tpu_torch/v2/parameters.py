"""v2 Parameters (the port's copy of `paddle_tpu/v2/parameters.py`;
reference python/paddle/v2/parameters.py): numpy get/set over the
trained parameter values + tar-style serialization.

In v2, `parameters.create(cost)` materializes initialized parameter
buffers before a trainer exists; here that means running the startup
program into a fresh scope, which the SGD trainer then adopts.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import framework
from ..executor import Executor, Scope
from . import _place

__all__ = ["Parameters", "create"]


class Parameters:
    def __init__(self, scope, main_program):
        self.scope = scope
        self._program = main_program

    def names(self):
        block = self._program.global_block()
        return [p.name for p in block.all_parameters()]

    def keys(self):
        return self.names()

    def get(self, name):
        if not self.scope.has(name):
            raise KeyError(f"parameter {name!r} is not initialised "
                           f"(known: {sorted(self.names())})")
        val = self.scope.get(name)
        if isinstance(val, torch.Tensor):
            return val.detach().cpu().numpy()
        return np.asarray(val)

    def set(self, name, value):
        """A numpy copy of `value`, placed where the parameter already
        lives (the executor copies a host array to its device)."""
        val = torch.from_numpy(np.array(value))
        cur = self.scope.get(name)
        if isinstance(cur, torch.Tensor):
            val = val.to(device=cur.device, dtype=cur.dtype)
        self.scope.set(name, val)

    __getitem__ = get
    __setitem__ = set

    def __iter__(self):
        return iter(self.names())

    # -- serialization (parameters.to_tar in the reference; npz here) ---
    def to_tar(self, f):
        np.savez(f, **{n: self.get(n) for n in self.names()
                       if self.scope.has(n)})

    @staticmethod
    def from_tar(f):
        data = np.load(f)
        p = Parameters(Scope(), framework.default_main_program())
        for n in data.files:
            p.set(n, data[n])
        return p

    def init_from_tar(self, f):
        with np.load(f) as data:
            for n in data.files:
                self.set(n, data[n])


def create(cost, place=None):
    """Run the startup program into a fresh scope and wrap it
    (reference parameters.create: build + init from the topology), on
    `place` or where `init` chose."""
    scope = Scope()
    exe = Executor(place or _place.default_place())
    exe.run(framework.default_startup_program(), scope=scope)
    return Parameters(scope, cost.block.program)
