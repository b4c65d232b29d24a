"""Op registry: op type -> torch lowering.

The port's copy of `paddle_tpu/ops/registry.py`. Each op registers a
lowering, a function from torch tensors to torch tensors,
`fn(ctx, ins, attrs) -> {slot: [tensor, ...]}`, that the executor calls
op by op (executor.py). Gradients: a forward op whose `<type>_grad` twin
appears later in the program is lowered under autograd and taped; the
grad op replays the tape with `torch.autograd.grad` (ops/grad.py).

Build-time shape inference runs the same lowering on `meta` tensors:
no data, no device, no JAX. A run-time-unknown dim (-1, a data var's
batch) travels as the sentinel prime `_DYN` and maps back to -1. Kernel
wrappers handed meta tensors compute shapes only.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from .. import framework


class OpDef(NamedTuple):
    type: str
    lowering: Callable            # (ctx, ins, attrs) -> dict slot -> list[val]
    differentiable: bool          # participates in autodiff at all
    stateful: bool                # draws from the executor's generator
    is_optimizer: bool = False    # parameter-update op: pruned for inference
    test_aware: bool = False      # behaves differently under is_test
                                  # (clone(for_test) forces is_test=True)


_REGISTRY: Dict[str, OpDef] = {}


def register_op(type, *, differentiable=True, stateful=False,
                is_optimizer=False, test_aware=False):
    """Decorator: register `fn(ctx, ins, attrs) -> {slot: [values]}`.
    The lowering modules register on import; the ops package imports
    them all, and the package's __init__ imports the ops package."""

    def deco(fn):
        _REGISTRY[type] = OpDef(type, fn, differentiable, stateful,
                                is_optimizer, test_aware)
        return fn

    return deco


def optimizer_op_types():
    """The parameter-update op types (OpDef metadata): what inference
    pruning strips."""
    return {t for t, d in _REGISTRY.items() if d.is_optimizer}


def get_op(type) -> OpDef:
    if type not in _REGISTRY:
        raise NotImplementedError(
            f"op {type!r} has no registered lowering in paddle_tpu_torch "
            f"({len(_REGISTRY)} ops registered)")
    return _REGISTRY[type]


def has_op(type) -> bool:
    return type in _REGISTRY


def torch_dtype(dtype):
    """Canonical dtype string -> torch dtype."""
    return getattr(torch, framework.canonical_dtype(dtype))


class LoweringContext:
    """State while the executor lowers a program.

    env: var name -> tensor; tape: op id -> TapeEntry for grad replay;
    `generator`: the `torch.Generator` the random ops draw from, seeded
    from `Program.seed` (the counterpart of the JAX package's threaded
    PRNG key; the two produce different numbers from the same seed);
    `amp_dtype`: the program's amp compute dtype (amp.py), or None;
    `op`: the op being lowered (its var names), set by the executor;
    `is_test`: inference behaviour for every test-aware op (batch_norm
    on its running stats, dropout the identity), besides each op's own
    `is_test` attr; the executor runs programs with it False, as the
    reference does;
    `in_place`: whether ops that write a persistable var may update the
    scope's tensor in place (False under the NaN guard: they write a new
    tensor, and the executor commits the run's state or none of it).
    """

    def __init__(self, program, block, env, device, generator=None,
                 in_place=True):
        from ..amp import amp_dtype_of
        self.program = program
        self.block = block
        self.env = env
        self.device = torch.device(device)
        self.tape = {}
        self.generator = generator
        self.amp_dtype = amp_dtype_of(program)
        self.op = None
        self.in_place = in_place
        self.is_test = False

    def lookup(self, name):
        if name not in self.env:
            raise KeyError(f"var {name!r} not materialised during lowering")
        return self.env[name]


# Sentinel prime standing in for unknown (-1) dims during build-time
# shape inference; output dims divisible by it map back to -1 (the JAX
# package's convention).
_DYN = 9973


def _meta_tensor(var: framework.Variable):
    shape = tuple(_DYN if s == -1 else s for s in (var.shape or ()))
    return torch.empty(shape, dtype=torch_dtype(var.dtype), device="meta")


def _restore_dyn(shape):
    return tuple(-1 if (s >= _DYN and s % _DYN == 0) else s for s in shape)


class _MetaCtx:
    """Context for shape inference: meta tensors, a meta device, no RNG
    state (random ops draw on the meta device, which has none), and the
    test-aware ops in test mode, as the reference's shape context."""
    device = torch.device("meta")
    generator = None
    amp_dtype = None
    op = None
    in_place = False
    is_test = True

    def lookup(self, name):
        raise KeyError(name)


def eval_op_shapes(block, op):
    """Run an op's lowering on meta tensors; no data, no device.

    Returns {slot: [(shape, dtype) | None, ...]} with the _DYN sentinel
    mapped back to -1, or None when inference is impossible (unknown op,
    an input var missing/shapeless, or the lowering rejecting the
    shapes)."""
    if not has_op(op.type):
        return None
    opdef = get_op(op.type)
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if not n:
                continue
            v = block._find_var(n)
            if v is None or v.shape is None:
                return None  # cannot infer
            vals.append(_meta_tensor(v))
        if vals:
            ins[slot] = vals
    try:
        with torch.no_grad():
            out = opdef.lowering(_MetaCtx(), ins, dict(op.attrs))
    except Exception:
        return None
    result = {}
    for slot, vals in out.items():
        result[slot] = [
            None if not isinstance(t, torch.Tensor)
            else (_restore_dyn(tuple(t.shape)),
                  framework.canonical_dtype(t.dtype))
            for t in vals]
    return result


def infer_op_shapes(block, op):
    """Fill missing output shapes/dtypes by running the lowering on meta
    tensors, once at graph build time."""
    if not has_op(op.type):
        return
    out_vars = []
    for names in op.outputs.values():
        for n in names:
            v = block._find_var(n)
            if v is not None:
                out_vars.append(v)
    if not out_vars or all(v.shape is not None for v in out_vars):
        return
    out = eval_op_shapes(block, op)
    if out is None:
        return
    for slot, names in op.outputs.items():
        if slot not in out:
            continue
        for n, entry in zip(names, out[slot]):
            v = block._find_var(n)
            if v is not None and entry is not None and v.shape is None:
                v.shape, v.dtype = entry
