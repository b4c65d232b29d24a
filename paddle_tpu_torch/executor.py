"""Executor: runs a Program op by op in eager PyTorch.

The port of `paddle_tpu/executor.py`. The JAX package traces a block's
ops into one pure function, jit-compiles it with the state buffers
donated and caches the executable; here `Executor.run` interprets the
block directly, on the card unless the caller asks for the CPU:

  * `_analyze` classifies the block's vars into mutable state, read-only
    state and feeds, with the reference's error messages for an unfed
    data var and an uninitialised persistable;
  * feeds are coerced to their var's dtype (`host_cast_feed`) and moved
    to the device; a tensor already on the device in that dtype is
    taken as it is (the one-shot engine's CUDA graphs feed their static
    input buffers this way);
  * each op runs its lowering (ops/registry.py); a forward op whose
    `<type>_grad` op appears later (`_ops_needing_tape`) runs under the
    autograd tape, and its grad op replays the tape (ops/grad.py);
  * the optimizer ops update the scope's tensors in place, where the
    reference donates their buffers; the persistables the block writes
    are then stored back into the scope.

The NaN guard (flag `check_nan_inf`, the reference's :309-317): the
reference's step is functional and turns donation off under the guard,
so a tripped step leaves the pre-step state. The port's counterpart:
with the guard on, every op that writes a persistable var writes a new
tensor (`LoweringContext.in_place` is False: the optimizer ops,
`increment`, `average_accumulates`), the scope's generator state is
kept, and the executor scans every fetch and every updated state var,
then commits all of them to the scope or none. It costs one more copy
of the updated state, as the reference without donation. With the guard
off, updates stay in place; a run that fails after an op wrote a
scope tensor in place (its autograd version counter moved) marks the
scope `state_invalidated`: that state holds half an update, so the
Trainer restores it from a checkpoint and never retries the step.

There is no jit, no donation and no compile cache: PyTorch dispatches
each op's kernels as the interpreter reaches it. The one-shot serving
engine captures a `run` per bucket rung as a CUDA graph
(serving/graphs.py), with `return_numpy=False`.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from . import amp as amp_mod
from . import flags as flags_mod
from . import framework, monitor
from ._device import resolve_device, use_full_f32
from .framework import CPUPlace, CUDAPlace
from .ops import grad as grad_mod
from .ops import registry as op_registry

__all__ = ["Executor", "Scope", "global_scope", "scope_guard",
           "host_cast_feed", "error_context", "lower_ops_on"]

_GENERATOR_KEY = "__rng_generator__"


class Scope:
    """Name -> tensor container (framework/scope.h analog). Persistable
    state lives here between runs, on the executor's device."""

    def __init__(self):
        self.vars = {}
        # set by a run that failed after writing one of these tensors in
        # place (guard off); cleared by io.load_checkpoint
        self.state_invalidated = False

    def set(self, name, value):
        self.vars[name] = value

    def get(self, name, default=None):
        return self.vars.get(name, default)

    def has(self, name):
        return name in self.vars

    def keys(self):
        return self.vars.keys()


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    prev = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = prev


# Ambient annotation appended to the NaN guard's message: the Trainer
# sets it to "global step N (pass P, batch B)" around each supervised
# step. Thread-local, so a serving thread's run never inherits it.
_error_context = threading.local()


def _current_error_context():
    return getattr(_error_context, "msg", None)


@contextlib.contextmanager
def error_context(msg):
    """Context manager: annotate executor-raised diagnostics with
    `msg` (e.g. the trainer's current global step)."""
    prev = _current_error_context()
    _error_context.msg = msg
    try:
        yield
    finally:
        _error_context.msg = prev


def _feed_signature(feed):
    """(name, shape, dtype) of every feed, sorted: a batch's shape key."""
    return tuple(sorted((k, tuple(np.shape(v)), str(v.dtype)
                         if hasattr(v, "dtype") else str(np.asarray(v).dtype))
                        for k, v in feed.items()))


def host_cast_feed(program, name, arr):
    """Coerce a feed array to its data var's declared dtype (the
    reference's feed-dtype policy; torch keeps int64 as int64)."""
    var = program.global_block()._find_var(name)
    if var is not None and var.dtype is not None:
        want = np.dtype(var.dtype)
        if arr.dtype != want:
            arr = arr.astype(want)
    return arr


def _to_numpy(t):
    """A fetched tensor as numpy. numpy has no bfloat16, so a bf16 var
    (an amp activation) comes back upcast to float32, exactly; the JAX
    package returns an ml_dtypes bfloat16 array there."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _place_device(place):
    """Executor place -> torch device: None (the card), CPUPlace,
    CUDAPlace(i), or a device string."""
    if place is None:
        return resolve_device(None)
    if isinstance(place, CPUPlace):
        return resolve_device("cpu")
    if isinstance(place, CUDAPlace):
        return resolve_device(f"cuda:{place.device_id}")
    return resolve_device(place)


def lower_ops_on(program, device, before, values):
    """Lower every op of `program` on `device` through the executor's own
    op dispatch, each op on given values of its inputs: `before[name]`
    for a persistable (its value before the step) and `values[name]` for
    every other var (feeds, and what another implementation computed);
    a grad op replays its forward op's tape. So two implementations are
    compared op by op instead of run free. Values are torch tensors or
    numpy arrays (a bfloat16 one, ml_dtypes' type, is taken exactly).
    Returns {output name: (the port's value, on the CPU, values[name] as
    a tensor)} for every float output `values` holds."""
    def tensor(v):
        if isinstance(v, torch.Tensor):
            return v
        a = np.array(v)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(a)

    device = resolve_device(device)
    if device.type == "cuda":
        use_full_f32()
    block = program.global_block()
    ctx = op_registry.LoweringContext(program, block, {}, device,
                                      in_place=False)
    taped = Executor._ops_needing_tape(block)
    persistable = {n for n, v in block.vars.items() if v.persistable}
    pairs = {}
    for op in block.ops:
        for names in op.inputs.values():
            for n in names:
                if n:
                    ctx.env[n] = tensor(before[n] if n in persistable
                                        else values[n]).to(device)
        Executor._lower_op(ctx, op, taped)
        for names in op.outputs.values():
            for n in names:
                if n and n in values and tensor(values[n]).is_floating_point():
                    pairs[n] = (ctx.env[n].detach().cpu(), tensor(values[n]))
    return pairs


class Executor:
    """fluid.Executor-shaped API over an eager op-by-op interpreter.

    `Executor()` runs on the CUDA card and raises when there is none;
    `Executor(CPUPlace())` (or `Executor("cpu")`) runs on the CPU."""

    def __init__(self, place=None):
        self.device = _place_device(place)
        self.place = (CPUPlace() if self.device.type == "cpu"
                      else CUDAPlace(self.device.index or 0))
        if self.device.type == "cuda":
            use_full_f32()

    # -- public API ---------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        program = program or framework.default_main_program()
        feed = dict(feed or {})
        fetch_list = fetch_list or []
        scope = scope or _global_scope
        fetch_names = [v.name if isinstance(v, framework.Variable) else v
                       for v in fetch_list]

        (block, state_mut, state_ro, state_out, feed_names,
         uses_key) = self._analyze(program, feed, fetch_names, scope)
        guard = flags_mod.get("check_nan_inf")
        env = {}
        for n in state_mut + state_ro:
            env[n] = self._to_device(scope.get(n), n)
        for n in feed_names:
            env[n] = self._coerce_feed(program, n, feed[n])
        gen = self._generator(program, scope) if uses_key else None
        gen_state = gen.get_state() if guard and gen is not None else None
        # the scope's own tensors and their version counters: an in-place
        # write by a run that then fails invalidates the scope's state
        held = [(t, t._version) for n in state_mut
                if (t := scope.get(n)) is env[n]]
        ctx = op_registry.LoweringContext(program, block, env, self.device,
                                          generator=gen, in_place=not guard)
        taped = self._ops_needing_tape(block)
        try:
            for op in block.ops:
                self._lower_op(ctx, op, taped)
            missing = [n for n in fetch_names if n not in env]
            if missing:
                raise KeyError(f"fetch var(s) {missing} were not computed "
                               "by the program")
            fetches = [env[n] for n in fetch_names]
            if guard:
                self._check_nan_inf(fetch_names, fetches, state_out,
                                    [env[n] for n in state_out])
        except BaseException:
            if gen_state is not None:
                gen.set_state(gen_state)
            if any(t._version != v for t, v in held):
                scope.state_invalidated = True
            raise
        for name in state_out:
            scope.set(name, env[name])
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches

    @staticmethod
    def _check_nan_inf(fetch_names, fetches, state_names, state):
        """FLAGS_check_nan_inf (the reference's `_check_nan_inf`): every
        fetch and every updated state var is scanned, and ALL offending
        variables are named in one FloatingPointError, with the
        Trainer's step context when one is set. One host sync for the
        whole scan."""
        named = [(n, v) for n, v in list(zip(fetch_names, fetches))
                 + list(zip(state_names, state))
                 if isinstance(v, torch.Tensor) and v.is_floating_point()
                 and v.numel()]
        if not named:
            return
        # max |v| is finite iff every element is (amax propagates NaN):
        # two launches a var, where isfinite(v).all() takes five
        peaks = torch.stack([v.detach().abs().amax().float()
                             for _, v in named])
        finite = torch.isfinite(peaks).tolist()
        bad = [n for (n, _), ok in zip(named, finite) if not ok]
        if bad:
            monitor.counter_inc("executor.nan_guard_trips")
            ctx = _current_error_context()
            err = FloatingPointError(
                "NaN/Inf detected in variable(s) "
                + ", ".join(repr(n) for n in bad)
                + (f" at {ctx}" if ctx else "")
                + " (PADDLE_TPU_CHECK_NAN_INF is enabled)")
            monitor.blackbox.maybe_dump("nan_guard", error=err,
                                        extra={"bad_vars": bad})
            raise err

    # -- analysis -----------------------------------------------------------
    def _analyze(self, program, feed, fetch_names, scope):
        """Classify block vars into mutable state, read-only state and
        feeds (the reference's `_analyze`, same errors)."""
        block = program.global_block()
        written = set()
        read = set()
        for op in block.ops:
            for names in op.inputs.values():
                for n in names:
                    if n and n not in written:
                        read.add(n)
            for names in op.outputs.values():
                written.update(n for n in names if n)

        persistable = {n for n, v in block.vars.items() if v.persistable}
        feed_names = sorted(feed.keys())
        feed_set = set(feed_names)

        state_out = [n for n in block.vars
                     if n in persistable and n in written]
        out_set = set(state_out)
        state_mut, state_ro = [], []
        for n in block.vars:
            if n in persistable and n not in feed_set:
                if (n in read or n in written) and scope.has(n):
                    (state_mut if n in out_set else state_ro).append(n)
                elif n in read and not scope.has(n):
                    raise RuntimeError(
                        f"persistable var {n!r} is read by the program but "
                        "not initialised — run the startup program first")

        for n, v in block.vars.items():
            if (not v.persistable and n not in feed_set and n not in written
                    and n in read):
                raise RuntimeError(f"var {n!r} must be fed (is_data var "
                                   "missing from feed dict)")

        uses_key = any(op_registry.has_op(op.type)
                       and op_registry.get_op(op.type).stateful
                       and not op.attrs.get("is_test", False)
                       for op in block.ops)
        return block, state_mut, state_ro, state_out, feed_names, uses_key

    @staticmethod
    def _ops_needing_tape(block):
        return {op.attrs["fwd_op_id"] for op in block.ops
                if op.type.endswith("_grad") and "fwd_op_id" in op.attrs}

    @staticmethod
    def _lower_op(ctx, op, taped):
        if op.type.endswith("_grad") and "fwd_op_id" in op.attrs:
            grad_mod.lower_grad_op(ctx, op)
            return
        opdef = op_registry.get_op(op.type)
        ctx.op = op
        ins = {slot: [ctx.lookup(n) for n in names if n]
               for slot, names in op.inputs.items() if any(names)}
        if op.id in taped and opdef.differentiable:
            # amp casts happen INSIDE the tape (grad.py) so gradients
            # come back in the original (f32 master) dtypes
            outs = grad_mod.lower_with_tape(ctx, op, opdef, ins, op.attrs)
        else:
            if ctx.amp_dtype is not None:
                ins = amp_mod.cast_ins(op.type, ins, ctx.amp_dtype)
            with torch.no_grad():
                outs = opdef.lowering(ctx, ins, dict(op.attrs))
        for slot, names in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            for name, val in zip(names, vals):
                if name:
                    ctx.env[name] = val

    # -- helpers ------------------------------------------------------------
    def _generator(self, program, scope):
        """The scope's generator on this device, seeded from
        `program.seed` (default 0) at first use and advanced by every
        later draw — the counterpart of the reference's `__rng_key__`."""
        gen = scope.get(_GENERATOR_KEY)
        if gen is None or gen.device != self.device:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(program.seed if program.seed is not None else 0)
            scope.set(_GENERATOR_KEY, gen)
        return gen

    def _to_device(self, val, name):
        if val is None:
            raise RuntimeError(f"state var {name!r} missing from scope")
        if not isinstance(val, torch.Tensor):
            val = torch.from_numpy(np.ascontiguousarray(val))
        return val if val.device == self.device else val.to(self.device)

    def _coerce_feed(self, program, name, val):
        if isinstance(val, torch.Tensor) and val.device == self.device:
            var = program.global_block()._find_var(name)
            if var is None or var.dtype is None \
                    or val.dtype == op_registry.torch_dtype(var.dtype):
                return val
        arr = host_cast_feed(program, name, np.asarray(val))
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
